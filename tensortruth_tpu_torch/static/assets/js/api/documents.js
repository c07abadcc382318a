// Typed client for the per-scope document routes (reference
// frontend/src/api/documents.ts): list/delete/reindex plus the three
// ingestion paths (multipart file upload with progress, URL fetch, pasted
// text). Every call takes a scope — `{kind: "session"|"project", id}` or a
// plain session-id string (reference ScopeType: documents live under
// /api/sessions/{id}/… or /api/projects/{id}/…, server routes/documents.py).

import {api, del, post} from "./client.js";

export function scopePath(scope) {
  if (typeof scope === "string") return `/sessions/${scope}`;
  return `/${scope.kind === "project" ? "projects" : "sessions"}/${scope.id}`;
}

export function listDocuments(scope) {
  return api(`${scopePath(scope)}/documents`);
}
export function deleteDocument(scope, docId) {
  return del(`${scopePath(scope)}/documents/${docId}`);
}
export function addUrlDocument(scope, url) {
  return post(`${scopePath(scope)}/documents`, {url});
}
export function addTextDocument(scope, filename, text) {
  return post(`${scopePath(scope)}/documents`, {filename, text});
}
export function reindexDocuments(scope) {
  return post(`${scopePath(scope)}/documents/reindex`, {});
}
export function fileUrlInfo(url) {
  return api(`/file-url-info?url=${encodeURIComponent(url)}`);
}

// Multipart upload via XHR so the browser reports upload progress
// (fetch() cannot). Callbacks: onProgress(pct), onIndexing(), then
// onDone(status, data) or onError().
export function uploadDocumentXHR(scope, file, cbs) {
  const form = new FormData();
  form.append("file", file);
  const xhr = new XMLHttpRequest();
  xhr.open("POST", `/api${scopePath(scope)}/documents`);
  xhr.upload.onprogress = ev => {
    if (ev.lengthComputable && cbs.onProgress)
      cbs.onProgress(Math.round(100 * ev.loaded / ev.total));
  };
  xhr.upload.onload = () => { if (cbs.onIndexing) cbs.onIndexing(); };
  xhr.onload = () => {
    let data = {};
    try { data = JSON.parse(xhr.responseText); } catch (e) {}
    cbs.onDone(xhr.status, data);
  };
  xhr.onerror = () => cbs.onError && cbs.onError();
  xhr.send(form);
}
