"""Chunk-node schema and the host-side hierarchy store.

Replaces the LlamaIndex docstore the reference persists next to every Chroma
index (reference indexing/builder.py:424-442: ALL nodes go to the docstore,
only leaf nodes are embedded). The hierarchy store is the lookup structure
auto-merging retrieval walks at query time (reference rag_engine.py:641-644).

Design: nodes are plain dataclasses; the store keeps id→node plus
parent↔children maps and a stable leaf ordering. The leaf ordering IS the row
order of the embedding matrix on device — ``leaf_ids[row] == node_id`` — so
device-side top-k returns row indices that hydrate host-side with one list
lookup, no dict hops in the hot path.
"""

from __future__ import annotations

import json
import uuid
from dataclasses import dataclass, field, asdict
from pathlib import Path
from typing import Iterable, Iterator


def _new_id() -> str:
    return uuid.uuid4().hex


@dataclass
class Node:
    """One chunk at one level of the hierarchy.

    ``level`` 0 is the coarsest (largest chunk size); the deepest level holds
    the leaves that get embedded. Character span ``(start, end)`` indexes into
    the source document text.
    """

    node_id: str
    text: str
    level: int
    doc_id: str
    module: str = ""
    parent_id: str | None = None
    child_ids: list[str] = field(default_factory=list)
    start: int = 0
    end: int = 0
    metadata: dict = field(default_factory=dict)

    @property
    def is_leaf(self) -> bool:
        return not self.child_ids

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        return cls(**d)


class HierarchyStore:
    """id→node map with parent/child navigation and stable leaf order."""

    def __init__(self) -> None:
        self._nodes: dict[str, Node] = {}
        self._leaf_ids: list[str] = []
        self._leaf_row: dict[str, int] = {}

    # -- construction ------------------------------------------------------

    def add(self, node: Node) -> None:
        if node.node_id in self._nodes:
            raise ValueError(f"duplicate node_id {node.node_id}")
        self._nodes[node.node_id] = node

    def add_all(self, nodes: Iterable[Node]) -> None:
        for n in nodes:
            self.add(n)

    def finalize_leaves(self) -> list[str]:
        """Freeze leaf ordering (= embedding-matrix row order)."""
        self._leaf_ids = [n.node_id for n in self._nodes.values() if n.is_leaf]
        self._leaf_row = {nid: i for i, nid in enumerate(self._leaf_ids)}
        return self._leaf_ids

    def remove_doc(self, doc_id: str) -> list[str]:
        """Drop every node of a document; returns removed leaf ids.

        Mirrors the reference's incremental delete
        (document_index.py:536-581). Embedding-matrix rows are tombstoned by
        the caller (see index/store.py) — the store only mutates the maps.
        """
        removed_leaves = []
        doomed = [nid for nid, n in self._nodes.items() if n.doc_id == doc_id]
        for nid in doomed:
            n = self._nodes.pop(nid)
            if n.is_leaf:
                removed_leaves.append(nid)
            if n.parent_id and n.parent_id in self._nodes:
                parent = self._nodes[n.parent_id]
                if nid in parent.child_ids:
                    parent.child_ids.remove(nid)
        self._leaf_ids = [nid for nid in self._leaf_ids if nid in self._nodes]
        self._leaf_row = {nid: i for i, nid in enumerate(self._leaf_ids)}
        return removed_leaves

    # -- lookup ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node_id: str) -> bool:
        return node_id in self._nodes

    def get(self, node_id: str) -> Node:
        return self._nodes[node_id]

    def parent(self, node_id: str) -> Node | None:
        pid = self._nodes[node_id].parent_id
        return self._nodes[pid] if pid else None

    # Fast paths shared with PackedHierarchyStore (automerge contract).
    def parent_id_of(self, node_id: str) -> str | None:
        return self._nodes[node_id].parent_id

    def n_children_of(self, node_id: str) -> int:
        return len(self._nodes[node_id].child_ids)

    def children(self, node_id: str) -> list[Node]:
        return [self._nodes[c] for c in self._nodes[node_id].child_ids]

    @property
    def leaf_ids(self) -> list[str]:
        return self._leaf_ids

    def leaf_by_row(self, row: int) -> Node:
        return self._nodes[self._leaf_ids[row]]

    def row_of(self, node_id: str) -> int:
        return self._leaf_row[node_id]

    def nodes(self) -> Iterator[Node]:
        return iter(self._nodes.values())

    def leaves(self) -> Iterator[Node]:
        return (self._nodes[i] for i in self._leaf_ids)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str | Path) -> None:
        """JSONL: one node per line, then a footer with the leaf ordering.

        Atomic (tmp + rename) like every other index artifact: a crash
        mid-save must not leave a half-written hierarchy next to a valid
        matrix — is_valid() would pass and load() would then fail."""
        path = Path(path)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with tmp.open("w", encoding="utf-8") as f:
            for n in self._nodes.values():
                f.write(json.dumps(n.to_dict(), ensure_ascii=False) + "\n")
            f.write(json.dumps({"__leaf_ids__": self._leaf_ids}) + "\n")
        tmp.replace(path)

    @classmethod
    def load(cls, path: str | Path) -> "HierarchyStore":
        store = cls()
        leaf_ids: list[str] | None = None
        with Path(path).open("r", encoding="utf-8") as f:
            for line in f:
                d = json.loads(line)
                if "__leaf_ids__" in d:
                    leaf_ids = d["__leaf_ids__"]
                else:
                    store.add(Node.from_dict(d))
        if leaf_ids is None:
            store.finalize_leaves()
        else:
            store._leaf_ids = leaf_ids
            store._leaf_row = {nid: i for i, nid in enumerate(leaf_ids)}
        return store


def new_node_id() -> str:
    return _new_id()
