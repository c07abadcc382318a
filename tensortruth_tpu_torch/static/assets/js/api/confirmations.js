// Typed client for /api/tool-confirmations (reference
// frontend/src/api/confirmations.ts): the orchestrator blocks on these.

import {post} from "./client.js";

export function approveConfirmation(id) {
  return post(`/tool-confirmations/${id}/approve`);
}
export function rejectConfirmation(id) {
  return post(`/tool-confirmations/${id}/reject`);
}
