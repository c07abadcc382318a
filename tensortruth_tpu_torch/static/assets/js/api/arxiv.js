// Typed client for /api/arxiv (reference frontend/src/api/arxiv.ts):
// paper-metadata lookup used before ingesting an arXiv id as a document.

import {api} from "./client.js";

export function arxivLookup(arxivId) {
  return api(`/arxiv/${encodeURIComponent(arxivId)}`);
}
