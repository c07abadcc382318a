from tensortruth_tpu_torch.index.nodes import Node, HierarchyStore
from tensortruth_tpu_torch.index.store import VectorIndex, sanitize_model_id
from tensortruth_tpu_torch.index.chunker import (
    ChunkingStrategy,
    hierarchical_chunk,
    semantic_chunk,
    semantic_hierarchical_chunk,
    chunk_document,
)

__all__ = [
    "VectorIndex",
    "sanitize_model_id",
    "Node",
    "HierarchyStore",
    "ChunkingStrategy",
    "hierarchical_chunk",
    "semantic_chunk",
    "semantic_hierarchical_chunk",
    "chunk_document",
]
