// Typed client for /api/providers (reference frontend/src/api/providers.ts).

import {api, del, patch, post} from "./client.js";

export function listProviders() { return api("/providers"); }
export function addProvider(body) { return post("/providers", body); }
export function patchProvider(id, body) { return patch(`/providers/${id}`, body); }
export function deleteProvider(id) { return del(`/providers/${id}`); }
export function testProvider(body) { return post("/providers/test", body); }
export function discoverModels(providerId) {
  return providerId
    ? api(`/providers/discover?provider_id=${encodeURIComponent(providerId)}`)
    : api("/providers/discover");
}
