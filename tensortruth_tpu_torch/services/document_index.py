"""Per-scope (session/project) incremental document index.

Behavioral mirror of reference document_index.py:141-641 on top of the
tombstoning VectorIndex (index/store.py):

* build index from markdown texts, **incremental add** without rebuild
  (reference :478-534), **delete by doc_id** (reference :536-581);
* settings hash over (chunk_sizes, conversion method) for staleness
  detection (reference :583-622);
* embedding runs through the shared TPU embedder — the reference forces CPU
  for scope indexes (:316) to protect VRAM; here device memory is managed by
  the ModelManager so the same device is used.
"""

from __future__ import annotations

import hashlib
import json
import logging
from pathlib import Path

from tensortruth_tpu_torch.index.chunker import hierarchical_chunk
from tensortruth_tpu_torch.index.store import VectorIndex

logger = logging.getLogger(__name__)

SETTINGS_FILE = "settings_hash.json"
DEFAULT_SCOPE_CHUNK_SIZES = [2048, 512, 256]


def settings_hash(chunk_sizes: list[int], conversion_method: str = "builtin") -> str:
    blob = json.dumps([chunk_sizes, conversion_method])
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class DocumentIndexBuilder:
    """Owns one scope's VectorIndex directory."""

    def __init__(
        self,
        index_dir: str | Path,
        embedder,
        chunk_sizes: list[int] | None = None,
        chunk_overlap: int = 64,
        conversion_method: str = "builtin",
    ):
        self.index_dir = Path(index_dir)
        # Accept a ready embedder OR a zero-arg factory. The factory stays
        # uncalled until an operation actually needs the model (chunking
        # wants its tokenizer, indexing its encode) — so delete/list on a
        # cold server never pays the 568M-param model load.
        if callable(embedder) and not hasattr(embedder, "encode"):
            self._embedder_factory = embedder
            self._embedder = None
        else:
            self._embedder_factory = None
            self._embedder = embedder
        self.chunk_sizes = chunk_sizes or list(DEFAULT_SCOPE_CHUNK_SIZES)
        # Overlap must stay below the smallest level size (chunker invariant).
        self.chunk_overlap = min(chunk_overlap, max(1, min(self.chunk_sizes) // 4))
        self.conversion_method = conversion_method
        self._index: VectorIndex | None = None

    @property
    def embedder(self):
        if self._embedder is None and self._embedder_factory is not None:
            self._embedder = self._embedder_factory()
        return self._embedder

    # -- staleness (reference document_index.py:583-622) ----------------------

    def current_settings_hash(self) -> str:
        return settings_hash(self.chunk_sizes, self.conversion_method)

    def stored_settings_hash(self) -> str | None:
        p = self.index_dir / SETTINGS_FILE
        if not p.exists():
            return None
        try:
            return json.loads(p.read_text())["hash"]
        except (json.JSONDecodeError, KeyError, TypeError):
            # torn/garbled marker (crash mid-write predating the atomic
            # writer): treat as stale so the next build rewrites it, instead
            # of surfacing a parse error on every staleness probe
            return "<corrupt>"

    def is_stale(self) -> bool:
        stored = self.stored_settings_hash()
        return stored is not None and stored != self.current_settings_hash()

    def _write_settings(self) -> None:
        from tensortruth_tpu_torch.app.file_utils import atomic_write_json

        self.index_dir.mkdir(parents=True, exist_ok=True)
        atomic_write_json(
            self.index_dir / SETTINGS_FILE, {"hash": self.current_settings_hash()}
        )

    # -- index access -----------------------------------------------------------

    @property
    def exists(self) -> bool:
        return VectorIndex.is_valid(self.index_dir)

    def load(self) -> VectorIndex | None:
        if self._index is None and self.exists:
            self._index = VectorIndex.load(self.index_dir)
        return self._index

    def _embed_fn(self):
        return lambda texts: self.embedder.encode(texts)

    def _chunk(self, doc_id: str, text: str, metadata: dict | None):
        return hierarchical_chunk(
            text,
            self.embedder.tokenizer,
            doc_id,
            chunk_sizes=self.chunk_sizes,
            chunk_overlap=self.chunk_overlap,
            metadata={"doc_type": "uploaded_pdf", **(metadata or {})},
        )

    # -- mutations ----------------------------------------------------------------

    def build_index(self, documents: dict[str, str], metadata: dict[str, dict] | None = None) -> VectorIndex:
        """Full (re)build from {doc_id: markdown_text}."""
        metadata = metadata or {}
        nodes = []
        for doc_id, text in documents.items():
            nodes.extend(self._chunk(doc_id, text, metadata.get(doc_id)))
        index = VectorIndex.build(
            nodes,
            self._embed_fn(),
            embedding_model=getattr(self.embedder, "model_id", ""),
            chunk_sizes=self.chunk_sizes,
            chunk_overlap=self.chunk_overlap,
        )
        index.save(self.index_dir)
        self._write_settings()
        self._index = index
        return index

    def add_documents(self, documents: dict[str, str], metadata: dict[str, dict] | None = None) -> int:
        """Incremental add (reference :478-534). Creates the index if absent.
        Returns the number of leaf chunks indexed."""
        if not self.exists:
            index = self.build_index(documents, metadata)
            return index.n_alive
        index = self.load()
        assert index is not None
        metadata = metadata or {}
        added = 0
        for doc_id, text in documents.items():
            if any(n.doc_id == doc_id for n in index.store.nodes()):
                index.remove_document(doc_id)  # re-upload replaces
            nodes = self._chunk(doc_id, text, metadata.get(doc_id))
            added += index.add_nodes(nodes, self._embed_fn())
        index.save(self.index_dir)
        return added

    def remove_document(self, doc_id: str) -> int:
        """Tombstone delete (reference :536-581)."""
        index = self.load()
        if index is None:
            return 0
        removed = index.remove_document(doc_id)
        # Compact when tombstones dominate (periodic maintenance policy).
        if index.n_rows and index.n_alive < index.n_rows // 2:
            index.compact()
        index.save(self.index_dir)
        return removed

    def doc_ids(self) -> list[str]:
        index = self.load()
        if index is None:
            return []
        return sorted({n.doc_id for n in index.store.nodes()})
