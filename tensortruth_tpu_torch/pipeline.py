"""The online query step: tokenize (host) -> [embed -> top-k] (device).

Port of ``tensortruth_tpu/pipeline.py``: encoder forward, normalised CLS and
the corpus top-k run back to back on the device with no host round trip in
between; (scores, rows) come back to the host once per batch.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tensortruth_tpu_torch.models.embedder import bucket, pad_batch
from tensortruth_tpu_torch.models.xlmr import XLMRModel, cls_embed
from tensortruth_tpu_torch.ops.topk import EXACT_MAX_ROWS, pad_topk, exact_topk, fused_topk
from tensortruth_tpu_torch.utils import profiling


def embed_topk(
    model: XLMRModel,
    ids: torch.Tensor,
    mask: torch.Tensor,
    emb: torch.Tensor,
    *,
    k: int,
    n_actual: int,
    use_fused: bool = True,
    m: int = 1,
    tile_n: int = 2048,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder forward -> normalised CLS -> corpus top-k, all on emb's device.

    Past ``EXACT_MAX_ROWS`` valid rows the fused kernel B1 runs; below it the
    exact path over the whole (padded) matrix, whose padding-row hits are
    then masked to -inf / -1 as in the reference."""
    q = cls_embed(model, ids, mask).to(emb.dtype)
    n = emb.shape[0]
    with profiling.span("search", b=q.shape[0], n=n_actual, k=k):
        if use_fused and n_actual > EXACT_MAX_ROWS:
            vals, idx = fused_topk(q, emb, k, m=m, tile_n=tile_n, n_actual=n_actual)
        else:
            vals, idx = pad_topk(*exact_topk(q, emb, min(k, n)), k)
    valid = (idx >= 0) & (idx < n_actual)
    return vals.masked_fill(~valid, float("-inf")), idx.masked_fill(~valid, -1)


class QueryPipeline:
    """Host wrapper: bucketed tokenization + the fused device step."""

    def __init__(self, embedder, engine):
        self.embedder = embedder
        self.engine = engine

    def applicable(self) -> bool:
        """The fused step needs the flat single-device bf16/f32 tier (no
        mesh, no IVF index, no int8 scales) with a corpus on the embedder's
        device; the other tiers embed, then search through the engine."""
        eng = self.engine
        return (
            eng.mesh is None
            and eng._ivf is None
            and eng._stacked_scales is None
            and eng._stacked is not None
            and eng._stacked.device == self.embedder.device
        )

    def retrieve_batch(self, texts: Sequence[str]):
        """texts -> per-query merged/balanced RetrievedNodes."""
        eng, e = self.engine, self.embedder
        if not texts or eng._stacked is None:
            return [[] for _ in texts]
        with profiling.span("query_step", queries=len(texts)) as span:
            ids, mask = e.tokenizer.encode_batch(list(texts), e.max_length)
            seq = bucket(int(mask.sum(axis=1).max()), e.seq_buckets)
            bsz = bucket(len(texts), e.batch_buckets)
            if span:
                span.count(tokens=int(mask.sum()), slots=bsz * seq)
            ids_p, mask_p = pad_batch(ids, mask, np.arange(len(texts)), bsz, seq, e.tokenizer.pad_id)
            k = min(eng.similarity_top_k * max(1, len(eng.modules)), eng._n_actual)
            with torch.inference_mode():
                vals, idx = embed_topk(
                    e.model, *e.to_device(ids_p, mask_p), eng._stacked,
                    k=k, n_actual=eng._n_actual, use_fused=eng.use_fused,
                )
                vals, idx = vals[: len(texts)].cpu().numpy(), idx[: len(texts)].cpu().numpy()
            return [eng._postprocess(vals[i], idx[i]) for i in range(len(texts))]

    def retrieve_one(self, text: str):
        """Single query with the engine's LRU text cache semantics."""
        eng = self.engine
        if eng.enable_cache and text in eng._cache:
            eng._cache.move_to_end(text)
            return eng._cache[text]
        result = self.retrieve_batch([text])[0]
        if eng.enable_cache:
            eng._cache[text] = result
            if len(eng._cache) > eng.cache_size:
                eng._cache.popitem(last=False)
        return result
