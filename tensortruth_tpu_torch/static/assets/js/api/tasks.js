// Typed client for /api/tasks (reference frontend/src/api/tasks.ts) plus
// the polling helper every long-running flow (index build, model pull)
// shares.

import {api} from "./client.js";

export function listTasks() { return api("/tasks"); }
export function getTask(id) { return api(`/tasks/${id}`); }

export async function watchTask(taskId, onUpdate) {
  // Transient poll failures (server busy compiling, blip) must not freeze
  // the progress UI forever — tolerate up to 10 consecutive errors, then
  // surface a failed status instead of rejecting into the void.
  let errors = 0;
  for (let i = 0; i < 1800; i++) {
    try {
      const t = await getTask(taskId);
      errors = 0;
      onUpdate(t);
      if (t.status === "completed" || t.status === "failed") return t;
    } catch (e) {
      if (++errors >= 10) {
        const t = {status: "failed", stage: `poll failed: ${e}`};
        onUpdate(t);
        return t;
      }
    }
    await new Promise(r => setTimeout(r, 1000));
  }
}
