// Typed client for /api/startup (reference frontend/src/api/startup.ts):
// first-run status, downloadable index bundles, index build/download and
// model pull (both return task ids to watch).

import {api, post} from "./client.js";

export function startupStatus() { return api("/startup/status"); }
export function availableIndexes() { return api("/startup/available-indexes"); }
export function downloadIndexes(modules) {
  return post("/startup/download-indexes", modules ? {modules} : {});
}
export function pullModel(model) { return post("/startup/pull-model", {model}); }
