"""XLM-R encoder, its checkpoint loader, the embedder/reranker runtimes and their manager."""
