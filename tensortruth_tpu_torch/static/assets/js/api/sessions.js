// Typed client for /api/sessions (reference frontend/src/api/sessions.ts).

import {api, apiFetch, del, patch, post} from "./client.js";

export function listSessions() { return api("/sessions"); }
export function createSession(body) { return post("/sessions", body || {}); }
export function getSession(id) { return api(`/sessions/${id}`); }
export function patchSession(id, body) { return patch(`/sessions/${id}`, body); }
export function patchSessionRaw(id, body) {
  return apiFetch(`/sessions/${id}`, {method: "PATCH", body: JSON.stringify(body)});
}
export function deleteSession(id) { return del(`/sessions/${id}`); }
export function deleteMessage(id, index) { return del(`/sessions/${id}/messages/${index}`); }
export function sessionStats() { return api("/sessions/stats"); }
export function imageUrl(sessionId, imageId) {
  return `/api/sessions/${sessionId}/images/${imageId}`;
}
