"""MultiIndexEngine: every loaded module's leaf matrix stacked into one
device matrix, searched by one top-k launch per query batch.

Port of ``tensortruth_tpu/retrieval/engine.py``, flat single-device tier:

* ``_restack`` streams ``iter_matrix_pieces`` into one preallocated host
  tensor in the corpus dtype, padded to 2048-row tiles, then makes ONE copy
  to the device (the f32 stack is never materialised);
* per-module quota (``similarity_top_k`` per index) over ``top_k x
  n_modules`` global candidates, auto-merge per module, then
  ``top_k_per_index`` balancing;
* LRU cache of 128 query texts.

``use_fused`` defaults to whether the engine's device is CUDA (the reference
defaults to whether it runs on a TPU). The IVF tier, the int8 corpus and a
multi-device mesh are not ported yet: asking for them raises.
"""

from __future__ import annotations

import logging
import warnings
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from tensortruth_tpu.index.nodes import Node
from tensortruth_tpu.index.store import VectorIndex
from tensortruth_tpu_torch.ops.topk import topk_search
from tensortruth_tpu_torch.retrieval.automerge import auto_merge

logger = logging.getLogger(__name__)

TILE_ROWS = 2048  # corpus padding unit = fused_topk's tile_n
_CORPUS_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class RetrievedNode:
    """Engine output unit (analog of LlamaIndex NodeWithScore)."""

    node: Node
    score: float
    module: str
    source_index: int

    @property
    def node_id(self) -> str:
        return self.node.node_id


class MultiIndexEngine:
    def __init__(
        self,
        indexes: dict[str, VectorIndex],
        similarity_top_k: int = 10,
        merge_ratio: float = 0.5,
        enable_cache: bool = True,
        cache_size: int = 128,
        balance_strategy: str = "top_k_per_index",
        device="cuda",
        use_fused: bool | None = None,
        ivf_threshold: int = 2_000_000,
        corpus_dtype: str = "bfloat16",
        mesh=None,
    ):
        if mesh is not None:
            raise NotImplementedError("multi-device engine is not ported yet (ROADMAP A15)")
        if corpus_dtype not in _CORPUS_DTYPES:
            raise NotImplementedError(
                f"corpus_dtype={corpus_dtype!r} is not ported yet (int8 tier: ROADMAP A12)"
            )
        self.modules = list(indexes.keys())
        self.indexes = indexes
        self.similarity_top_k = similarity_top_k
        self.merge_ratio = merge_ratio
        self.enable_cache = enable_cache
        self.cache_size = cache_size
        self.balance_strategy = balance_strategy
        self.device = torch.device(device)
        self.use_fused = use_fused if use_fused is not None else self.device.type == "cuda"
        self.ivf_threshold = ivf_threshold
        self.corpus_dtype = corpus_dtype
        self._cache: OrderedDict[str, list[RetrievedNode]] = OrderedDict()
        self._stacked: torch.Tensor | None = None
        self._row_map: np.ndarray | None = None  # global row -> physical row
        self._module_of_row: np.ndarray | None = None
        self._n_actual = 0
        self._restack()

    # -- device matrix management ---------------------------------------------

    def _restack(self) -> None:
        mods, rows, active, dim = [], [], [], 0
        for mi, mod in enumerate(self.modules):
            m, row_map = self.indexes[mod].matrix()
            if m.shape[0] == 0:
                continue
            mods.append(np.full(m.shape[0], mi, np.int32))
            rows.append(row_map)
            active.append(mod)
            dim = m.shape[1]
        self._cache.clear()
        if not active:
            self._stacked, self._n_actual = None, 0
            return
        self._module_of_row = np.concatenate(mods)
        self._row_map = np.concatenate(rows)
        self._n_actual = int(self._module_of_row.shape[0])
        if self._n_actual >= self.ivf_threshold:
            raise NotImplementedError(
                f"{self._n_actual} rows reach the IVF tier (>= {self.ivf_threshold}), "
                "which is not ported yet (ROADMAP A13)"
            )
        n_pad = -(-self._n_actual // TILE_ROWS) * TILE_ROWS
        host = torch.zeros((n_pad, dim), dtype=_CORPUS_DTYPES[self.corpus_dtype])
        row = 0
        with warnings.catch_warnings():
            # Pieces may be read-only mmaps; they are only read from here.
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            for mod in active:
                for piece in self.indexes[mod].iter_matrix_pieces():
                    n = piece.shape[0]
                    host[row : row + n] = torch.from_numpy(np.asarray(piece, dtype=np.float32))
                    row += n
        if row != self._n_actual:
            raise RuntimeError(f"matrix pieces supplied {row} rows, stack expects {self._n_actual}")
        self._stacked = host.to(self.device)

    @property
    def n_chunks(self) -> int:
        return self._n_actual

    # -- retrieval -------------------------------------------------------------

    def retrieve(self, query_emb: np.ndarray, query_text: str = "") -> list[RetrievedNode]:
        """Single query: (D,) embedding -> balanced merged RetrievedNodes."""
        if self.enable_cache and query_text and query_text in self._cache:
            self._cache.move_to_end(query_text)
            return self._cache[query_text]
        result = self.retrieve_batch(query_emb[None, :])[0]
        if self.enable_cache and query_text:
            self._cache[query_text] = result
            if len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
        return result

    def retrieve_batch(self, query_embs: np.ndarray) -> list[list[RetrievedNode]]:
        """Batch of queries -> per-query balanced merged RetrievedNodes; one
        top-k launch for the whole batch across all loaded modules."""
        if self._stacked is None or self._n_actual == 0:
            return [[] for _ in range(query_embs.shape[0])]
        k = min(self.similarity_top_k * max(1, len(self.modules)), self._n_actual)
        q = torch.from_numpy(np.asarray(query_embs, dtype=np.float32)).to(self.device, self._stacked.dtype)
        with torch.inference_mode():
            vals, idx = topk_search(
                q, self._stacked, k, exact=not self.use_fused, n_actual=self._n_actual
            )
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        return [self._postprocess(vals[i], idx[i]) for i in range(vals.shape[0])]

    def _postprocess(self, scores: np.ndarray, rows: np.ndarray) -> list[RetrievedNode]:
        """Host side: global rows -> per-module hits -> auto-merge -> balance."""
        valid = rows >= 0
        scores, rows = scores[valid], rows[valid]

        per_module: dict[int, list[tuple[str, float]]] = {}
        for s, r in zip(scores.tolist(), rows.tolist()):
            mi = int(self._module_of_row[r])
            node = self.indexes[self.modules[mi]].node_of_row(int(self._row_map[r]))
            per_module.setdefault(mi, []).append((node.node_id, float(s)))

        results: list[RetrievedNode] = []
        for mi, hits in per_module.items():
            mod = self.modules[mi]
            hits = hits[: self.similarity_top_k]  # per-module quota
            for nid, score in auto_merge(hits, self.indexes[mod].store, self.merge_ratio):
                results.append(
                    RetrievedNode(
                        node=self.indexes[mod].store.get(nid), score=score, module=mod, source_index=mi
                    )
                )

        if len(self.modules) > 1 and self.balance_strategy == "top_k_per_index":
            return self._balance(results)
        results.sort(key=lambda r: -r.score)
        return results

    def _balance(self, nodes: list[RetrievedNode]) -> list[RetrievedNode]:
        """Per-index limit = max(1, total // n_indexes), re-sorted by score."""
        by_index: dict[int, list[RetrievedNode]] = {}
        for n in nodes:
            by_index.setdefault(n.source_index, []).append(n)
        if not by_index:
            return []
        limit = max(1, len(nodes) // len(by_index))
        balanced: list[RetrievedNode] = []
        for group in by_index.values():
            group.sort(key=lambda r: -r.score)
            balanced.extend(group[:limit])
        balanced.sort(key=lambda r: -r.score)
        return balanced

    def clear_cache(self) -> None:
        self._cache.clear()
