"""Headline benchmark: end-to-end query throughput at the 1M-chunk tier.

    python -m tensortruth_tpu_torch.scripts.bench   # from the repository root; needs one CUDA card

Port of the JAX package's ``bench.py`` (BASELINE.json configs 3 + 4): the
full online query pipeline on one card. BGE-M3-architecture query encoding
-> kernel B1 (fused matmul + bucketed top-k) over a 1M x 1024 bf16 corpus
-> bge-reranker-v2-m3-architecture cross-encoder scoring of the top
candidates. Weights are random at full width (XLM-R large, bf16, seed 0);
the timing is that of trained weights.

The headline is the serving loop in its steady state: each batch's rerank
needs its own top-k ids on the host, where its (query, chunk) pairs are
built and tokenized (the docstore lookup of real serving), while the NEXT
batch's embed -> top-k is already queued on the card; batch B's scores are
finished only after batch B+1's rerank is issued, the two-phase protocol of
``services/batcher.py``. Pairs follow the leaf-length mix of the
reference's chunked docs (measured with a trained tokenizer: about 65% of
pairs near 275 tokens, 30% near 147, the rest near 250; the offline
tokenizer puts the same pairs at 255, 131 and 228 tokens, buckets 256
and 192), scored through the length-bucketed ``Reranker.score_pairs_async``.

On one CUDA stream a host read of batch B's ids must not wait for batch
B+1's forward, which is queued behind it: each step copies its ids
non-blocking into pinned memory right after its own top-k and records an
event there (``models/embedder.py::to_host_async``); the loop waits on that
event alone. ``serve`` counts the rounds in which batch B+1's step was still
pending on the card when batch B's ids reached the host.

:func:`run` returns the numbers; :func:`headline` formats them as the
reference's one JSON line, which :func:`main` prints. ``tiny=True`` is the
reference's ``BENCH_TINY``: its tiny architecture over 6,000 rows of D=128
(past the 4096-row exact cut-over, so B1's path runs); only it may run on
the CPU, and it gives no meaningful numbers.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch
from torch.profiler import record_function

from tensortruth_tpu_torch.models.embedder import to_host_async
from tensortruth_tpu_torch.models.reranker import Reranker
from tensortruth_tpu_torch.models.xlmr import (
    BGE_M3_CONFIG,
    BGE_RERANKER_V2_M3_CONFIG,
    XLMRConfig,
    XLMRModel,
    cls_embed,
    rerank_logits,
)
from tensortruth_tpu_torch.ops.topk import fused_topk, pad_corpus_for_fused
from tensortruth_tpu_torch.pipeline import embed_topk
from tensortruth_tpu_torch.scripts import backend, card_line, driver_device, sync, time_calls
from tensortruth_tpu_torch.tokenization import load_tokenizer

# Anchors of the reference's line, neither of them this card's number: a
# torch-2.9 CPU run of the reference-equivalent pipeline with its rerank
# stage scaled to the same pair-length mix (22.5 s embed + 1.4 s top-k +
# 417.6 s rerank per 32-query batch, BASELINE.md), and a 3090-class GPU
# estimate from the same FLOP count at ~35-40 TFLOPS bf16 and ~50% MFU.
REFERENCE_BASELINE_QPS_CPU = 0.0725
REFERENCE_BASELINE_QPS_GPU_EST = 13.0

BATCH = 32  # queries per batch (the server's batching tier)
SEQ_Q = 128  # query token bucket
N_CHUNKS = 1_000_000
DIM = 1024
TOP_K = 100  # dense candidates (two-stage: top-100 -> rerank)
# Pairs per query through the cross-encoder: the engine's adaptive
# similarity_top_k = max(5, 2 * top_n) = 10; every candidate is scored.
RERANK_TOP = 10
SEQ_PAIR = 256  # the fixed-shape rerank stage

# Chunk word counts calibrated to the measured mix (~275 / ~147 / ~250 tokens
# per pair): per 10 chunks 6 long, 3 short, 1 mid.
_CHUNK_WORDS = [242, 242, 242, 242, 242, 242, 118, 118, 118, 215]
# Every candidate hydrates a distinct chunk text, so the host tokenizes
# ~320 unique strings per batch: 4096 texts >> BATCH * RERANK_TOP.
_POOL_SIZE = 4096
_WORDS = "retrieval engine shard merge index token kernel matmul embed chunk".split()

ROUNDS = 4  # serving-loop rounds timed (and fixed-256 pipeline rounds)

# The reference's BENCH_TINY architecture, over a corpus past the exact cut-over.
TINY_CONFIG = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                   max_position=2052)
TINY_N_CHUNKS, TINY_DIM = 6_000, 128


def make_pool(n: int = _POOL_SIZE) -> list[str]:
    """``n`` unique chunk texts (word ``c{j}`` first) at the measured length mix."""
    return [
        " ".join(f"c{j}" if i == 0 else _WORDS[(i + j) % len(_WORDS)] for i in range(_CHUNK_WORDS[j % len(_CHUNK_WORDS)]))
        for j in range(n)
    ]


def make_queries(n: int = BATCH) -> list[str]:
    return [f"how does component {i} interact with the sharded engine" for i in range(n)]


def random_corpus(device, n: int, d: int, seed: int = 0, tile_n: int = 2048, piece: int = 65_536) -> torch.Tensor:
    """(n rounded up to ``tile_n``, d) bf16 rows, N(0, 1) from a generator on
    ``device`` seeded ``seed``, each row divided by its f32 norm; the rows
    past ``n`` are zero, as ``pad_corpus_for_fused`` lays a corpus out."""
    corpus = torch.zeros((-(-n // tile_n) * tile_n, d), dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for lo in range(0, n, piece):
        x = torch.randn((min(n, lo + piece) - lo, d), generator=gen, device=device).to(torch.bfloat16)
        corpus[lo : lo + x.shape[0]] = x / torch.linalg.vector_norm(x.float(), dim=1, keepdim=True).to(torch.bfloat16)
    return corpus


def host_corpus(arr: np.ndarray, device) -> tuple[torch.Tensor, int]:
    """A host (N, D) float matrix padded by ``pad_corpus_for_fused``, as bf16
    on ``device``; returns (corpus, N)."""
    padded, n = pad_corpus_for_fused(np.asarray(arr, np.float32))
    return torch.from_numpy(padded).to(device).to(torch.bfloat16), n


class _Step:
    """One batch's embed -> top-k, queued; its ids on their way to pinned
    host memory behind a CUDA event."""

    def __init__(self, idx: torch.Tensor):
        self.wait = to_host_async(idx)
        self._done = None
        if idx.is_cuda:
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(idx.device))

    def pending(self) -> bool:
        """Whether the card has not yet finished this step (and its copy)."""
        return self._done is not None and not self._done.query()


class Bench:
    """The models, corpus and text pool of one benchmark, on one device."""

    def __init__(self, embedder: XLMRModel, reranker: Reranker, corpus: torch.Tensor, n_chunks: int):
        self.embedder = embedder
        self.reranker = reranker
        self.corpus = corpus
        self.n_chunks = n_chunks
        self.device = corpus.device
        self.ids = torch.ones((BATCH, SEQ_Q), dtype=torch.int32, device=self.device)
        self.mask = torch.ones((BATCH, SEQ_Q), dtype=torch.int32, device=self.device)
        self.pair_ids = torch.ones((BATCH * RERANK_TOP, SEQ_PAIR), dtype=torch.int32, device=self.device)
        self.pair_mask = torch.ones((BATCH * RERANK_TOP, SEQ_PAIR), dtype=torch.int32, device=self.device)
        self.pool = make_pool()
        self.queries = make_queries()

    def embed(self) -> torch.Tensor:
        return cls_embed(self.embedder, self.ids, self.mask)

    def topk(self, q: torch.Tensor):
        return fused_topk(q.to(torch.bfloat16), self.corpus, TOP_K, n_actual=self.n_chunks)

    def rerank_fixed(self) -> torch.Tensor:
        return rerank_logits(self.reranker.model, self.pair_ids, self.pair_mask)

    def fused_step(self):
        """Encoder -> normalised CLS -> B1 over the corpus, with no host
        round trip between them (``pipeline.embed_topk``)."""
        return embed_topk(self.embedder, self.ids, self.mask, self.corpus, k=TOP_K, n_actual=self.n_chunks,
                          use_fused=True)

    def issue(self) -> _Step:
        return _Step(self.fused_step()[1])

    def build_pairs(self, idx_host: np.ndarray) -> list[tuple[str, str]]:
        """Top-RERANK_TOP candidate rows -> (query, chunk text) pairs: the
        pool lookup stands in for the docstore's hydration step."""
        return [
            (self.queries[i], self.pool[int(idx_host[i, j]) % len(self.pool)])
            for i in range(BATCH)
            for j in range(RERANK_TOP)
        ]

    def warm(self) -> None:
        """Every (batch, seq) bucket the mix gives, and the fused step."""
        self.reranker.score_pairs(self.build_pairs(self.issue().wait()[:, :RERANK_TOP]))

    def serve(self, rounds: int = ROUNDS, record: list | None = None) -> dict:
        """The double-buffered loop: per round, queue batch B+1's step, read
        batch B's ids, build, tokenize and launch its rerank, then finish
        batch B-1's scores. ``record`` receives (pairs, scores) per batch.
        Returns seconds per round, the rounds in which batch B+1's step was
        still pending on the card when batch B's ids arrived, and the host's
        total wait for those ids."""
        t0 = time.perf_counter()
        inflight = self.issue()
        finish_prev, prev_pairs = None, None
        pending, wait_s = 0, 0.0
        for _ in range(rounds):
            with record_function("bench.step"):
                nxt = self.issue()  # overlaps the rerank below
            with record_function("bench.readback"):
                t1 = time.perf_counter()
                idx_host = inflight.wait()[:, :RERANK_TOP]
                wait_s += time.perf_counter() - t1
                pending += nxt.pending()
            with record_function("bench.rerank"):
                pairs = self.build_pairs(idx_host)
                finish = self.reranker.score_pairs_async(pairs)  # tokenize + launch
            if finish_prev is not None:
                with record_function("bench.finish"):
                    scores = finish_prev()  # the card is already past it
                if record is not None:
                    record.append((prev_pairs, scores))
            finish_prev, prev_pairs, inflight = finish, pairs, nxt
        with record_function("bench.finish"):
            scores = finish_prev()
            inflight.wait()
        if scores.shape != (BATCH * RERANK_TOP,):
            raise RuntimeError(f"rerank returned {scores.shape} scores for {BATCH * RERANK_TOP} pairs")
        if record is not None:
            record.append((prev_pairs, scores))
        return {"s_per_round": (time.perf_counter() - t0) / rounds, "rounds": rounds,
                "pending_at_readback": pending, "readback_wait_s": wait_s}

    def fixed256_pipeline(self, rounds: int = ROUNDS) -> float:
        """Seconds per batch of the fused step + the fixed 320 x 256 rerank,
        back to back: the older headline's shape, a comparison anchor."""
        self.fused_step()
        self.rerank_fixed()
        sync(self.device)
        t0 = time.perf_counter()
        for _ in range(rounds):
            self.fused_step()
            self.rerank_fixed()
        sync(self.device)
        return (time.perf_counter() - t0) / rounds


def setup(device="cuda", tiny: bool = False, *, embedder: XLMRModel | None = None,
          reranker: XLMRModel | None = None, corpus: np.ndarray | None = None) -> Bench:
    """Models at full width (or the tiny architecture) with random weights
    from seed 0 and the seeded corpus on ``device``. A caller may hand in
    either model and a host corpus instead."""
    device = driver_device(device, tiny)
    emb_cfg, rr_cfg = BGE_M3_CONFIG, BGE_RERANKER_V2_M3_CONFIG
    n, d = N_CHUNKS, DIM
    if tiny:
        emb_cfg, rr_cfg = XLMRConfig(**TINY_CONFIG), XLMRConfig(num_labels=1, **TINY_CONFIG)
        n, d = TINY_N_CHUNKS, TINY_DIM
    embedder = embedder or XLMRModel.random_init(emb_cfg, device, seed=0)
    reranker = reranker or XLMRModel.random_init(rr_cfg, device, seed=0)
    if corpus is None:
        emb = random_corpus(device, n, d)
    else:
        emb, n = host_corpus(corpus, device)
    return Bench(embedder, Reranker(reranker, load_tokenizer()), emb, n)


def measure(bench: Bench) -> dict:
    """Every stage of the reference's line, unrounded (seconds)."""
    device = bench.device
    with torch.inference_mode():
        t_embed, t_embed_min, q = time_calls(bench.embed, device, iters=8)
        t_topk, t_topk_min, _ = time_calls(lambda: bench.topk(q), device, iters=8)
        t_rerank, _, _ = time_calls(bench.rerank_fixed, device)
        t_fused, t_fused_min, _ = time_calls(bench.fused_step, device, iters=8)
        bench.warm()
        serve = bench.serve()
        t_pipe = bench.fixed256_pipeline()
    return {
        "embed_s": t_embed, "embed_min_s": t_embed_min, "topk_s": t_topk, "topk_min_s": t_topk_min,
        "embed_topk_fused_s": t_fused, "embed_topk_fused_min_s": t_fused_min, "rerank_fixed256_s": t_rerank,
        "serve_s_per_batch": serve["s_per_round"], "fixed256_pipeline_s_per_batch": t_pipe,
        "qps": BATCH / serve["s_per_round"], "serve": serve, "backend": backend(device),
        "n_chunks": bench.n_chunks, "card": card_line() if device.type == "cuda" else None,
    }


def run(device="cuda", tiny: bool = False) -> dict:
    """:func:`measure` over a fresh :func:`setup`."""
    return measure(setup(device, tiny))


def headline(m: dict) -> dict:
    """The reference's JSON line (its keys and rounding) from :func:`measure`."""

    def ms(key: str) -> float:
        return round(m[key] * 1e3, 2)

    qps = m["qps"]
    return {
        "metric": "query_throughput_1M_retrieve_rerank",
        "value": round(qps, 2),
        "unit": "qps",
        "vs_baseline": round(qps / REFERENCE_BASELINE_QPS_CPU, 1),
        "vs_baseline_cpu": round(qps / REFERENCE_BASELINE_QPS_CPU, 1),
        "vs_baseline_gpu_est": round(qps / REFERENCE_BASELINE_QPS_GPU_EST, 1),
        "detail": {
            "embed_ms": ms("embed_s"),
            "embed_ms_min": ms("embed_min_s"),
            "topk_ms": ms("topk_s"),
            "topk_ms_min": ms("topk_min_s"),
            "embed_topk_fused_ms": ms("embed_topk_fused_s"),
            "embed_topk_fused_ms_min": ms("embed_topk_fused_min_s"),
            "rerank_fixed256_ms": ms("rerank_fixed256_s"),
            "serve_ms_per_batch": ms("serve_s_per_batch"),
            "fixed256_pipeline_ms_per_batch": ms("fixed256_pipeline_s_per_batch"),
            "backend": m["backend"],
            "n_chunks": m["n_chunks"],
            "card": m["card"],
        },
    }


def main() -> None:
    print(json.dumps(headline(run())))


if __name__ == "__main__":
    main()
