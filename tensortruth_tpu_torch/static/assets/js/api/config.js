// Typed client for /api/config (reference frontend/src/api/config.ts).

import {api, apiFetch} from "./client.js";

export function getConfig() { return api("/config"); }
export function getConfigDefaults() { return api("/config/defaults"); }
export function patchConfigRaw(body) {
  return apiFetch("/config", {method: "PATCH", body: JSON.stringify(body)});
}
