// Typed client for the knowledge-catalog routes (reference
// frontend/src/api/modules.ts): built module indexes, known embedding
// models, registered rerankers.

import {api, apiFetch, del} from "./client.js";

export function listModules(embeddingModel) {
  // reference ModuleSelector filters modules by the embedding model whose
  // index dir they live in; the route accepts ?embedding_model=
  return api(embeddingModel
    ? `/modules?embedding_model=${encodeURIComponent(embeddingModel)}`
    : "/modules");
}
export function listEmbeddingModels() { return api("/embedding-models"); }
export function listRerankers() { return api("/rerankers"); }
export function addReranker(modelId) {
  return apiFetch("/rerankers", {method: "POST",
                                 body: JSON.stringify({model_id: modelId})});
}
export function removeReranker(modelId) {
  return del(`/rerankers/${encodeURIComponent(modelId)}`);
}
