"""MultiIndexEngine: every loaded module's leaf matrix stacked into one
device matrix, searched by one top-k launch per query batch.

Port of ``tensortruth_tpu/retrieval/engine.py``. Every tier streams
``iter_matrix_pieces`` (the f32 stack is never materialised):

* flat bf16 / f32: one preallocated host tensor in the corpus dtype, padded
  to 2048-row tiles, then ONE copy to the device; searched by
  ``topk_search`` (kernel B1 past 4096 rows when fused);
* flat int8 (``corpus_dtype="int8"`` with ``use_fused``): per-piece
  ``quantize_corpus_streaming`` into a tile-padded int8 matrix + f32 row
  scales; searched by ``fused_topk_int8`` (kernel B2) at any size. Without
  ``use_fused`` it warns and falls back to bf16, as the reference does;
* IVF, at ``ivf_threshold`` rows or more (twice that for int8): a
  cluster-major ``IVFIndex`` of bf16 or int8 blocks, searched by
  ``ivf_search`` (kernel B4).

On a mesh (``parallel/mesh.py``) the device is the mesh's lead device and
the flat tiers are row-sharded (``parallel/sharded_topk.py``: bf16 / f32
through ``shard_corpus_streaming``, tile-aligned when fused; int8 through
``shard_corpus_int8_streaming``, searched by B2 when fused, else by the
dequantised exact product), searched by one launch per shard and a merge.
The IVF threshold scales with the shard count; past it the blocks are built
in host memory and placed cluster-sharded (``ops/ivf.py::shard_ivf``).

The query is never cast to int8: it scores in bf16 against an int8 corpus.
Then: per-module quota (``similarity_top_k`` per index) over ``top_k x
n_modules`` global candidates, auto-merge per module, ``top_k_per_index``
balancing, and an LRU cache of 128 query texts.

``use_fused`` defaults to whether the engine's device is CUDA (the reference
defaults to whether it runs on a TPU). The tier thresholds, cluster and probe
counts are the reference's, sized for a TPU.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from tensortruth_tpu_torch.index.nodes import Node
from tensortruth_tpu_torch.index.store import VectorIndex
from tensortruth_tpu_torch.ops.ivf import (
    IVFIndex,
    ShardedIVF,
    build_ivf,
    host_tensor,
    ivf_search,
    ivf_search_sharded,
    shard_ivf,
)
from tensortruth_tpu_torch.ops.topk import fused_topk_int8, quantize_corpus_streaming, topk_search
from tensortruth_tpu_torch.parallel.mesh import SHARD_AXIS
from tensortruth_tpu_torch.parallel.sharded_topk import (
    shard_corpus_int8_streaming,
    shard_corpus_streaming,
    sharded_topk,
)
from tensortruth_tpu_torch.retrieval.automerge import auto_merge

logger = logging.getLogger(__name__)

TILE_ROWS = 2048  # corpus padding unit = fused_topk's tile_n


@dataclass
class RetrievedNode:
    """Engine output unit (analog of LlamaIndex NodeWithScore)."""

    node: Node
    score: float
    module: str
    source_index: int

    @property
    def text(self) -> str:
        return self.node.text

    @property
    def node_id(self) -> str:
        return self.node.node_id

    def to_dict(self) -> dict:
        return {
            "node_id": self.node.node_id,
            "module": self.module,
            "score": self.score,
            "text": self.node.text,
            "metadata": self.node.metadata,
        }


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
        ivf_clusters: int = 1024,
        ivf_nprobe: int = 32,
        corpus_dtype: str = "bfloat16",
        mesh=None,
    ):
        self.mesh = mesh
        self.modules = list(indexes.keys())
        self.indexes = indexes
        self.similarity_top_k = similarity_top_k
        self.merge_ratio = merge_ratio
        self.enable_cache = enable_cache
        self.cache_size = cache_size
        self.balance_strategy = balance_strategy
        self.device = mesh.lead if mesh is not None else torch.device(device)
        self.use_fused = use_fused if use_fused is not None else self.device.type == "cuda"
        self.ivf_threshold = ivf_threshold
        self.ivf_clusters = ivf_clusters
        self.ivf_nprobe = ivf_nprobe
        self.corpus_dtype = corpus_dtype
        self._cache: OrderedDict[str, list[RetrievedNode]] = OrderedDict()
        # flat corpus (a ShardedCorpus on a mesh), or the IVF blocks (the ShardedIVF on a mesh)
        self._stacked = None
        self._stacked_scales: torch.Tensor | None = None  # f32 row scales of an int8 flat corpus
        self._ivf: IVFIndex | None = None
        self._ivf_sharded: ShardedIVF | None = None
        self.placement_seconds: dict[str, float] = {}  # host clock per step of the last _restack
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
        self._ivf, self._ivf_sharded, self._stacked_scales, self.placement_seconds = None, None, None, {}
        if not active:
            self._stacked, self._n_actual = None, 0
            return
        self._module_of_row = np.concatenate(mods)
        self._row_map = np.concatenate(rows)
        self._n_actual = int(self._module_of_row.shape[0])

        def emb_pieces():
            """Row-contiguous f32 pieces in stack order (mmap shards as is)."""
            for mod in active:
                yield from self.indexes[mod].iter_matrix_pieces()

        # A mesh shards the flat scan over its shards, so the IVF threshold
        # scales with the shard count; int8 halves the bytes per row, so the
        # flat scan holds to twice the rows (the reference's factors).
        n_shards = self.mesh.shape[SHARD_AXIS] if self.mesh is not None else 1
        dtype_factor = 2 if self.corpus_dtype == "int8" else 1
        tile_n = TILE_ROWS if self.use_fused else None
        t0 = time.perf_counter()
        if self._n_actual >= self.ivf_threshold * n_shards * dtype_factor:
            ivf = build_ivf(
                emb_pieces,
                n_clusters=self.ivf_clusters,
                block_dtype=torch.int8 if self.corpus_dtype == "int8" else torch.bfloat16,
                n_rows=self._n_actual,
                dim=dim,
                device=self.device,
                device_blocks=self.mesh is None,
            )
            self.placement_seconds = dict(ivf.build_seconds)
            if self.mesh is None:
                self._ivf = ivf
                self._stacked = ivf.blocks
                return
            t0 = time.perf_counter()
            self._ivf_sharded = self._stacked = shard_ivf(ivf, self.mesh)
            self.placement_seconds["shard"] = time.perf_counter() - t0
            return
        if self.mesh is not None:
            if self.corpus_dtype == "int8":
                self._stacked, _ = shard_corpus_int8_streaming(emb_pieces(), self._n_actual, dim, self.mesh, tile_n)
            else:
                dtype = torch.float32 if self.corpus_dtype == "float32" else torch.bfloat16
                self._stacked, _ = shard_corpus_streaming(emb_pieces(), self._n_actual, dim, self.mesh, dtype, tile_n)
            self.placement_seconds["shard"] = time.perf_counter() - t0
            return
        if self.corpus_dtype == "int8" and self.use_fused:
            emb_q, scales, _ = quantize_corpus_streaming(emb_pieces(), self._n_actual, dim, tile_n=TILE_ROWS)
            self.placement_seconds["quantize"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            self._stacked = torch.from_numpy(emb_q).to(self.device)
            self._stacked_scales = torch.from_numpy(scales).to(self.device)
            self.placement_seconds["to_device"] = time.perf_counter() - t0
            return
        dtype = torch.float32 if self.corpus_dtype == "float32" else torch.bfloat16
        if self.corpus_dtype == "int8":
            # The int8 flat scan needs the fused kernel; the exact path falls
            # back to bf16. Say so instead of silently doubling device memory.
            logger.warning(
                "corpus_dtype=int8 requested but use_fused=False on a single device: "
                "falling back to bfloat16 corpus (2x device memory)"
            )
        n_pad = -(-self._n_actual // TILE_ROWS) * TILE_ROWS
        host = torch.zeros((n_pad, dim), dtype=dtype)
        row = 0
        for piece in emb_pieces():
            host[row : row + piece.shape[0]] = host_tensor(piece)
            row += piece.shape[0]
        if row != self._n_actual:
            raise RuntimeError(f"matrix pieces supplied {row} rows, stack expects {self._n_actual}")
        self.placement_seconds["stack"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._stacked = host.to(self.device)
        self.placement_seconds["to_device"] = time.perf_counter() - t0

    def refresh(self) -> None:
        """Re-stack after index mutations (add/remove documents)."""
        self._restack()

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
        # Never cast the query to int8: normalised components are all below
        # 1 in magnitude and would truncate to 0. An int8 corpus (flat or IVF
        # blocks) is scored by a bf16 query.
        int8 = self._stacked_scales is not None or self._stacked.dtype == torch.int8
        q_dtype = torch.bfloat16 if int8 else self._stacked.dtype
        q = torch.from_numpy(np.asarray(query_embs, dtype=np.float32)).to(self.device, q_dtype)
        if self._ivf_sharded is not None:
            vals, idx = ivf_search_sharded(self._ivf_sharded, q, k, nprobe=self.ivf_nprobe)
            return [self._postprocess(vals[i], idx[i]) for i in range(vals.shape[0])]
        if self._ivf is not None:
            vals, idx = ivf_search(self._ivf, q, k, nprobe=self.ivf_nprobe)
            return [self._postprocess(vals[i], idx[i]) for i in range(vals.shape[0])]
        with torch.inference_mode():
            if self.mesh is not None:
                vals, idx = sharded_topk(q, self._stacked, k=k, n_actual=self._n_actual, use_fused=self.use_fused)
            elif self._stacked_scales is not None:
                vals, idx = fused_topk_int8(q, self._stacked, self._stacked_scales, k, n_actual=self._n_actual)
            else:
                vals, idx = topk_search(q, self._stacked, k, exact=not self.use_fused, n_actual=self._n_actual)
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
