"""Host code the port shares with the reference package instead of copying.

These modules of ``tensortruth_tpu`` never import jax (the port's import test
holds them to that), so the port and the programs that drive it take them
from there: the ``VectorIndex`` format with its node hierarchy, the
hierarchical chunker that builds the nodes, and the app config.
"""

from tensortruth_tpu.app.config import TensorTruthTPUConfig
from tensortruth_tpu.index import HierarchyStore, Node, VectorIndex, chunk_document

__all__ = ["HierarchyStore", "Node", "TensorTruthTPUConfig", "VectorIndex", "chunk_document"]
