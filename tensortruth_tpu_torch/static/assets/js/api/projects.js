// Typed client for /api/projects (reference frontend/src/api/projects.ts).

import {api, del, patch, post} from "./client.js";

export function listProjects() { return api("/projects"); }
export function getProject(id) { return api(`/projects/${id}`); }
export function createProject(body) { return post("/projects", body); }
export function patchProject(id, body) { return patch(`/projects/${id}`, body); }
export function deleteProject(id) { return del(`/projects/${id}`); }
export function createProjectSession(id, body) {
  return post(`/projects/${id}/sessions`, body || {});
}
export function listProjectSessions(id) { return api(`/projects/${id}/sessions`); }
// catalog modules + indexing config (reference api/projects.ts + documents.ts)
export function addCatalogModule(id, moduleName) {
  return post(`/projects/${id}/catalog-modules`, {module_name: moduleName});
}
export function removeCatalogModule(id, moduleName) {
  return del(`/projects/${id}/catalog-modules/${encodeURIComponent(moduleName)}`);
}
export function getIndexingConfig(id) { return api(`/projects/${id}/indexing-config`); }
export function patchIndexingConfig(id, body) {
  return patch(`/projects/${id}/indexing-config`, body);
}
