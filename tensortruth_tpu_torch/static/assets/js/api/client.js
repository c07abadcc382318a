// Shared HTTP client every typed API module builds on (reference
// frontend/src/api/client.ts). Two entry points:
//   api(path, opts)      — JSON in/out, rejects are surfaced to the caller
//   apiFetch(path, opts) — raw Response, for callers that need the status
//                          code (save buttons showing "error 422" etc.)

export const api = (path, opts) => fetch("/api" + path, {
  headers: {"Content-Type": "application/json"}, ...opts
}).then(r => r.json());

export const apiFetch = (path, opts) => fetch("/api" + path, {
  headers: {"Content-Type": "application/json"}, ...opts
});

export const post = (path, body) =>
  api(path, {method: "POST", body: JSON.stringify(body ?? {})});

export const patch = (path, body) =>
  api(path, {method: "PATCH", body: JSON.stringify(body ?? {})});

export const del = (path) => api(path, {method: "DELETE"});
