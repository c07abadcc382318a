// Typed client for /api/extensions (reference frontend/src/api/extensions.ts).

import {api, del, post} from "./client.js";

export function listExtensions() { return api("/extensions"); }
export function extensionLibrary() { return api("/extensions/library"); }
export function installExtension(catalogName) {
  return post("/extensions/install", {catalog_name: catalogName});
}
export function uninstallExtension(extType, filename) {
  return del(`/extensions/${extType}/${filename}`);
}
export function reloadExtensions() {
  // not under /api/... prefix pattern of the others: the reload endpoint is
  // app-level (reference api/main.py /api/reload-extensions)
  return fetch("/api/reload-extensions", {method: "POST"});
}
