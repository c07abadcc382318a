"""Drive the PyTorch/CUDA port's index build, server, online query path, serving under load, mesh and multislice
tiers once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each of which raises (exit code 1, no result line) when it fails:

1. card: the card's name and power limit, as nvidia-smi reports them;
2. kernel build: compile the hand-written kernels (``tensortruth_tpu_torch/csrc``)
   with nvcc into ``tensortruth_tpu_torch/_build/``;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it, with the tolerance stated below, and both
   timed with CUDA events, each beside its bound (the least time the card
   could take for the same work, from this run's inputs) and, where one
   PyTorch call computes the same function, beside that call: B1 fused
   top-k (also at query batches of 16 and 64), B2 its int8 variant, B3 attention at S = 512, 1024 and 2048
   (beside ``scaled_dot_product_attention``; the ``kernels`` line gives
   S = 1024's numbers and every S under ``by_seq``), B4 the IVF probe over bf16 and over
   int8 blocks (the int8 path also bit for bit on integer rows at scale 1,
   and its grouping of the (query, probe) pairs by cluster against the plain
   grouping), B5 the tensor-core product at the int8 probe's shape, bf16
   and int8, both block orders (beside ``torch.mm`` and ``torch._int_mm``;
   the int8 product also beside ``torch._int_mm`` on a column-major copy of
   b, made outside the timing, and with the time of its own b^T kernel);
4. build path: lay out a ``sources.json`` and ``library_docs/`` with three
   library modules and build each through the port's own CLI,
   ``build_db.main`` (the embedder the CLI loads: BGE-M3 at full width on
   the card): ``corpus``, 192 synthetic docs of 11,000 words (the port's
   ``scripts/measure_build.py`` generator, about 13,800 leaves), and
   ``docs``, this repository's docs, both hierarchical; ``docs_semantic``,
   the same docs under ``--chunking-strategy semantic``, whose leaves are
   whole sections of up to 2048 tokens: kernel B3 must be launched while it
   builds. Each build prints its seconds per stage, chunks/s, leaves by seq
   bucket and peak device memory. The indexes must carry their metadata and
   unit-norm f32 rows; B3 is held against its plain version on the mask of
   every forward that took it (batch and sequence buckets as the build
   padded them, fully padded rows included); ``docs_semantic`` (beside
   ``corpus``) answers 2 ``retrieve()`` requests; then
   ``scripts/measure_build.py`` times the embed loop alone over 2048 leaves
   of 248 words, and chunking (native and Python tokenizer) + embedding of
   48 docs of 11,000 words;
5. server path: the port's aiohttp app (``create_app(device="cuda")``) in
   this process on 127.0.0.1, over the ``corpus`` index the build path
   wrote, with a stub chat model: ``/health``, ``/api/config/devices`` (must
   name the card), a session over ``corpus``, a document of about 2,000
   words of the docs uploaded into it (chunked and embedded on the card),
   one REST chat, three WebSocket messages (``/help``, one leaf of the
   uploaded document verbatim, a 640-token passage: B3),
   ``/api/system/memory`` against ``torch.cuda.memory_allocated``, and one
   chat under the profile routes, whose trace must name B1's kernel. Each
   chat must give sources and ``done`` with no error frame, and both WS
   questions' sources must hold some of the uploaded document; the leaf's
   search must return that leaf. Every B1 search of the phase is held
   against a plain search of its query over the engine's indexes, stacked
   anew: each returned score is the plain score of its row, the rows hold
   at least MIN_RECALL of the plain top-k, and the session index's rows
   among them are counted both ways (so a chat with none of the upload
   among its sources is shown to have ranked it below the top-k). B1 and
   B3 must be launched during the phase; B3 is held against its plain
   version on every mask the phase gave it;
6. main path: a two-module index (the ``docs`` index the build path wrote,
   whose nodes must match the chunker's by span, plus a synthetic module that
   brings the stacked corpus to 262,144 leaf rows), loaded with the port's
   ``load_engine_for_modules`` under the default BGE-M3 /
   bge-reranker-v2-m3 architectures (random weights at full width, seeded),
   answers 8 requests through ``RAGService.retrieve()`` and one through
   ``query()`` with a stub LLM; the answers, the placement on the
   card, the recall of the fused top-k against the exact one, that every
   kernel of the path was launched during the requests, B3 against its
   plain version on the mask of every forward that took it, and, in a
   profiled replay of one request, that no stream synchronise falls between
   the rerank stage's batch launches are checked;
7. serving path: the main path's index served again by the port's app in
   this process through the port's serving driver
   (``scripts/measure_serving_e2e.py``'s ``launch(in_process=True)`` and
   ``drive``, its fake Ollama answering): 32 concurrent WebSocket sessions,
   2 warm-up messages each, a 10 s window. No error frame and no answer
   without sources; the batcher must coalesce (fewer batches than
   requests); the window's first 32 queries, sent again one at a time, must
   give the concurrent answers' sources (ids and order, scores within the
   serving driver's SCORE_TOL, two neighbours within it may swap); B1 must
   be launched, and every B1 search of the phase (the embedder's query
   batches of 1, 16 and 64 rows) is held against ``fused_topk_plain`` on
   the same query batch and corpus (TOPK_TOL); B3, launched on the pairs of
   merged parents, is held against its plain version on every mask the
   phase gave it;
8. orchestrator path, on the same server and fake Ollama: one ``docs``
   leaf asked verbatim in a session whose model (``fake-tools``) reports
   tool calling, through the port's real provider code: a ``tool_phase``
   naming ``rag_query`` with the leaf as its query, then ``sources`` holding
   the leaf and equal to the direct path's for the same text, then
   ``done``; its B1 search is held against a plain search, B3 as above;
9. recall path: ``scripts/measure_recall.py``'s ``run()``, B1 against the
   exact top-k over 1,000,000 x 1024 bf16 rows at k = 10 and 100, each
   recall at least its prediction less RECALL_MARGIN;
10. capacity path: one more module brings the docs to 2,097,152 rows (the
   smallest power of two above the 2M-row IVF threshold). Through
   ``load_engine`` it is served (a) as the int8 flat tier (``corpus_dtype:
   int8``: kernel B2) and (b) with default params as the IVF tier over bf16
   blocks (B4), each answering 4 ``retrieve()`` requests; (c) a
   ``MultiIndexEngine`` over the same indexes with ``corpus_dtype="int8"``
   and ``ivf_threshold=1_048_576`` takes the IVF tier over int8 blocks (B4's
   int8 variant and its grouping kernel) and answers one 32-query batch. Each checks its placement,
   its answers, a recall or self-retrieval rate, and that its kernel was
   launched while it was driven;
11. mesh path, over the capacity path's indexes and at the same widths, on
   a 2 x 4 mesh whose eight slots all sit on the card (no number of it is a
   multi-GPU figure): (a) the bf16 and (b) the int8 flat tier row-sharded
   over its 4 shards through ``load_engine(mesh=...)``, 4 ``retrieve()``
   requests each (the embedder and reranker data-parallel over the 8 slots,
   B1 / B2 once per shard per request), the placement holding each shard
   once (``torch.cuda.memory_allocated``), the DP query embeddings against
   the single-device embedder's; (c) a ``MultiIndexEngine`` on the mesh with
   ``ivf_threshold=262_144``: the cluster-sharded IVF over bf16 and over
   int8 blocks, one 32-query batch each (B4, and over int8 blocks its
   grouping, once per shard); (d) ``rag.mesh.enabled`` with the default
   shape through ``RAGService.load_engine``: a 1 x 1 mesh over the main
   path's corpus, 2 requests; (e) two processes on the card forming a gloo
   world of 2 (``scripts/global_mesh_worker.py``, 2 shards each), each
   reading and placing only its half of the rows through
   ``GlobalMeshSearch``, bf16 then int8, the last rank serving. Each sharded
   search is held against the same sharding through the plain versions
   (TOPK_TOL / PROBE_TOL), and against the exact top-20 (MIN_RECALL) or by
   self-retrieval; both ranks of (e) must return exactly (a)'s and (b)'s
   top-20. B1, B2 and B4 must be launched while (a)-(d) are driven;
12. multislice path, over the capacity path's IVF indexes (1024 clusters x
   3072 rows x 1024, bf16 and int8), nprobe 32, top-20, 40 queries (the 32
   corpus rows of the capacity path, self-retrieval, and the 8 questions),
   3 batches per step: (a) ``MultiSliceIVF`` with 4 cluster groups in this
   process (each a view of the index), routed on the host: held against the
   same routing through the plain probe (PROBE_TOL), self-retrieval, and its
   overlap with the single-device ``ivf_search`` reported (the two route
   differently: f32 on the host, bf16 on the card); B4 must be launched once
   per group touched per batch; (b) groups 2 and 3 written as parts
   (``save_part``) and served by two ``SupervisedTransport`` worker
   processes on the card, the local copies dropped: the ids must equal
   (a)'s exactly, the scores within the reference's cross-process tolerance
   (whether bit-equal is recorded), some returned rows must come from the
   workers' clusters; (c) (a) and (b) over int8 blocks (B4 int8 and its
   grouping); (e) one int8 worker is killed (SIGKILL) and the next batch
   must respawn it once and return (c)'s ids; (d) 2 groups, each sharded
   over a 1 x 2 mesh of the card, against the plain probe (one launch per
   shard per group touched). No group may fail and no worker respawn
   outside (e). The workers' own launches are not visible here: (b)'s
   equality is their proof;
13. probe path: the int8 tensor-core probe
   (``tensortruth_tpu_torch.scripts.probe_int8_mma.run()``) times B5's four
   variants at M=16384, K=1024, N=4096 and applies the reference's decision
   rule; B5 must have been launched, bf16 and int8, while it ran.

The last nine lines are the mesh phase's numbers (``{"mesh": ...}``:
placement seconds and device bytes per tier, request times, the shapes each
shard gave each kernel), the server phase's (``{"server": ...}``), the
multislice phase's (``{"multislice": ...}``: per dtype the routing ms, the
batch ms, each group's rows, clusters and B4 shape, part bytes, write and
load seconds, worker start seconds, the coordinator's device bytes, the
overlaps and the max |err| against plain), the serving phase's
(``{"serving": ...}``: messages/s, p50 and p95, the batcher's counters,
the batched-vs-sequential comparison, launches), the orchestrator phase's
(``{"orchestrator": ...}``), the recall phase's (``{"recall": ...}``),
the card's name and power limit,
a JSON object describing each kernel, and the final ``{"ok": true,
"device": ...}`` line.
Nothing here imports JAX or the JAX package; the host code (index, chunker,
config) is the port's own. All scratch files go to a temporary directory
inside the checkout that is removed at exit.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import time
import statistics
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# Kernel B1 vs its plain version (both f32 accumulations of exact bf16
# products, summed in different orders): scores agree to ~1e-6; an index may
# differ only where the two scores at that rank are within this tolerance.
TOPK_TOL = 1e-4
# Kernel B3 vs its plain version: the kernel rounds the unnormalised softmax
# weights to bf16 and the plain version the normalised ones, and both round
# the output to bf16, whose step grows with the value (2^-8 below 1.0, 2^-5
# from 4 to 8). Inputs are N(0, 1): a row with many real keys averages V to
# below 1, a row with a few (short leaves on the build path) comes close to
# one row of V, up to about 5. Each output is held to ATTN_TOL x max(1, |plain|).
ATTN_TOL = 2e-2
# Kernel B4 vs its plain version: both sum exact bf16 products in f32, in
# different orders (B4's int8 variant then applies one f32 scale); padding
# slots are -inf in both, exactly.
PROBE_TOL = 1e-4
# Kernel B5 vs its plain version: int8 -> int32 must be bit-exact. bf16 -> f32
# sums the same exact products in f32 in another order; with N(0, 1) operands
# and K = 1024 the outputs reach about 175 (sigma 32), where one f32 ulp is
# 1.5e-5, and two summation orders differ by a few tens of ulps.
MATMUL_TOL = 1e-3
# Fused vs exact top-20 over the main path's corpus: expected loss of the
# bucketed candidates is about k^2 / (2 c_out) = 0.1 items of 20. The same
# holds for B2 against the exact top-20 over its own (dequantised) scores.
MIN_RECALL = 0.9
# A corpus row used as a query finds itself at rank 0 unless it was spilled
# out of the clusters its own vector probes.
MIN_SELF_RETRIEVAL = 0.95

CORPUS_ROWS = 262_144  # 128 tiles of 2048
CAPACITY_ROWS = 2_097_152  # 1024 tiles: the smallest power of two past the 2M IVF threshold
# The IVF tier's probe shapes: 32 queries, the engine's nprobe and cluster
# count, rows per cluster as build_ivf sizes them for 2M random rows.
PROBE_SHAPE = {"b": 32, "nprobe": 32, "clusters": 1024, "rpc": 3072, "d": 1024}
# Leaf word counts of the synthetic module (bench.py:76): about 275 / 147 /
# 250 tokens per rerank pair.
CHUNK_WORDS = [242, 242, 242, 242, 242, 242, 118, 118, 118, 215]
POOL_SIZE = 4096

# One H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W): the
# least time for some work is the larger of its bytes over the memory rate and
# its operations over the tensor cores' rate for the operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}

KERNELS = {
    "fused_topk": {
        "route": "cuda",
        "source": "tensortruth_tpu_torch/csrc/fused_topk.cu",
        "replaces": "tensortruth_tpu/ops/topk.py:233",
    },
    "fused_topk_int8": {
        "route": "cuda",
        "source": "tensortruth_tpu_torch/csrc/fused_topk.cu",
        "replaces": "tensortruth_tpu/ops/topk.py:383",
    },
    "blocked_attention": {
        "route": "cuda",
        "source": "tensortruth_tpu_torch/csrc/attention.cu",
        "replaces": "tensortruth_tpu/ops/attention.py:74",
    },
    "ivf_probe": {
        "route": "cuda",
        "source": "tensortruth_tpu_torch/csrc/ivf_probe.cu",
        "replaces": "tensortruth_tpu/ops/ivf.py:124",
    },
    "ivf_probe_int8": {
        "route": "cuda",
        "source": "tensortruth_tpu_torch/csrc/ivf_probe.cu",
        "replaces": "tensortruth_tpu/ops/ivf.py:124",
    },
    # The first of B4's two launches over int8 blocks: the (query, probe)
    # pairs grouped by cluster, which the TPU kernel's scalar prefetch of the
    # cluster ids stands in for.
    "ivf_group_probes": {
        "route": "cuda",
        "source": "tensortruth_tpu_torch/csrc/ivf_probe.cu",
        "replaces": "tensortruth_tpu/ops/ivf.py:124",
    },
    "tc_matmul": {
        "route": "cuda",
        "source": "tensortruth_tpu_torch/csrc/tc_matmul.cu",
        "replaces": "scripts/probe_int8_mxu_pallas.py:70",
    },
    "tc_matmul_int8": {
        "route": "cuda",
        "source": "tensortruth_tpu_torch/csrc/tc_matmul.cu",
        "replaces": "scripts/probe_int8_mxu_pallas.py:70",
    },
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(torch, fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of a kernel shorter than its host
    launch: the calls are queued behind a device sleep, so the events time
    them back to back and no host gap between them."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)  # about 2 ms of clock cycles, longer than queueing the calls
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(torch, kernel, plain) -> tuple[float, float]:
    """(kernel ms, plain ms), timed plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, ops: int, kind: str = "bf16") -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the peak
    rate for ``kind`` operands, whichever is longer."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def unit_rows(torch, gen, n: int, d: int, dtype):
    x = torch.randn((n, d), generator=gen, device=gen.device)
    return (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(dtype)


def gib(nbytes: int) -> str:
    return f"{nbytes} bytes ({nbytes / 2**30:.2f} GiB)"


def check_topk_agrees(name: str, got, want) -> tuple[float, int]:
    """Values within TOPK_TOL; an index may differ only where the two scores
    at that rank are within it. Returns (max |err|, index swaps)."""
    from tensortruth_tpu_torch.ops.topk import check_topk_agrees as agrees

    return agrees(name, got, want, TOPK_TOL)


# -- phase 3: kernels against their plain versions ---------------------------


def check_fused_topk(torch) -> dict:
    from tensortruth_tpu_torch.ops.topk import fused_topk, fused_topk_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b, n, d, k = 32, CORPUS_ROWS, 1024, 100
    q = unit_rows(torch, gen, b, d, torch.bfloat16)
    e = unit_rows(torch, gen, n, d, torch.bfloat16)
    got, want = fused_topk(q, e, k), fused_topk_plain(q, e, k)
    torch.cuda.synchronize()
    err, swapped = check_topk_agrees("fused_topk", got, want)
    # The embedder's other query-batch buckets on the serving path: 16 pads
    # to one 32-query block, 64 takes two (another stream schedule).
    for other in (16, 64):
        oq = unit_rows(torch, gen, other, d, torch.bfloat16)
        err = max(err, check_topk_agrees(f"fused_topk B={other}", fused_topk(oq, e, k), fused_topk_plain(oq, e, k))[0])

    # Planted ties: integer-valued rows make every dot product exact in f32
    # whatever the summation order, so tie order must match exactly.
    tie_n = 16_384
    tq = torch.randint(-2, 3, (b, d), generator=gen, device="cuda").to(torch.bfloat16)
    te = torch.randint(-2, 3, (tie_n // 4, d), generator=gen, device="cuda").to(torch.bfloat16).repeat(4, 1)
    tv, ti = fused_topk(tq, te, k, n_actual=tie_n - 100)
    pv, pi = fused_topk_plain(tq, te, k, n_actual=tie_n - 100)
    check(torch.equal(tv, pv) and torch.equal(ti, pi), "fused_topk: planted ties ordered differently")

    ms, plain_ms = in_turns(torch, lambda: fused_topk(q, e, k), lambda: fused_topk_plain(q, e, k))
    bnd = bound(nbytes(q, e, *got), 2 * b * n * d)
    log(
        f"kernel fused_topk B={b} (and 16, 64) N={n} D={d} k={k} bf16: max_abs_err={err:.3g} "
        f"(tol {TOPK_TOL}), near-tie swaps={swapped}, planted ties exact; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})"
    )
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None}


def check_fused_topk_int8(torch) -> dict:
    """B2 at the int8 flat tier's size: 2,097,152 rows of quantize_corpus."""
    from tensortruth_tpu_torch.ops.topk import fused_topk_int8, fused_topk_int8_plain, quantize_corpus

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    b, n, d, k, step = 32, CAPACITY_ROWS, 1024, 100, 262_144
    q = unit_rows(torch, gen, b, d, torch.bfloat16)
    t0 = time.perf_counter()
    e_q = torch.empty((n, d), dtype=torch.int8, device="cuda")
    scales = torch.empty(n, dtype=torch.float32, device="cuda")
    with ThreadPoolExecutor(8) as pool:  # numpy releases the GIL on these arrays
        chunks = [unit_rows(torch, gen, step, d, torch.float32).cpu().numpy() for _ in range(0, n, step)]
        for i, (rows_q, rows_s) in enumerate(pool.map(quantize_corpus, chunks)):
            e_q[i * step : (i + 1) * step] = torch.from_numpy(rows_q)
            scales[i * step : (i + 1) * step] = torch.from_numpy(rows_s)
    del chunks
    quantize_s = time.perf_counter() - t0
    got, want = fused_topk_int8(q, e_q, scales, k), fused_topk_int8_plain(q, e_q, scales, k)
    torch.cuda.synchronize()
    err, swapped = check_topk_agrees("fused_topk_int8", got, want)
    ms, plain_ms = in_turns(
        torch, lambda: fused_topk_int8(q, e_q, scales, k), lambda: fused_topk_int8_plain(q, e_q, scales, k)
    )
    bnd = bound(nbytes(q, e_q, scales, *got), 2 * b * n * d)
    del e_q, scales, got, want
    torch.cuda.empty_cache()  # the plain version's 4 GiB bf16 copy goes too

    # Planted ties: integer rows at scale 1 score exactly in any order.
    tie_n = 16_384
    tq = torch.randint(-2, 3, (b, d), generator=gen, device="cuda").to(torch.bfloat16)
    te = torch.randint(-2, 3, (tie_n // 4, d), generator=gen, device="cuda").to(torch.int8).repeat(4, 1)
    ts = torch.ones(tie_n, device="cuda")
    for n_actual in (tie_n - 100, 3000):  # the int8 tier has no exact cut-over: one tile too
        tv, ti = fused_topk_int8(tq, te, ts, k, n_actual=n_actual)
        pv, pi = fused_topk_int8_plain(tq, te, ts, k, n_actual=n_actual)
        check(torch.equal(tv, pv) and torch.equal(ti, pi), f"fused_topk_int8: planted ties ordered differently ({n_actual})")
    log(
        f"kernel fused_topk_int8 B={b} N={n} D={d} k={k} int8 (quantize_corpus on the host, "
        f"{quantize_s:.1f} s): max_abs_err={err:.3g} (tol {TOPK_TOL}), near-tie swaps={swapped}, "
        f"planted ties exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})"
    )
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None}


def check_group_probes(torch, probe, n_clusters: int) -> dict:
    """B4's grouping kernel against its plain version: the same chunks, and
    each cluster's pairs the same set (their order within a cluster is not
    fixed)."""
    from tensortruth_tpu_torch.ops.ivf import group_probes, group_probes_plain

    order, chunks, n_chunks = (x.cpu() for x in group_probes(probe, n_clusters))
    p_order, p_chunks, p_n = (x.cpu() for x in group_probes_plain(probe, n_clusters))
    n = int(n_chunks[0])
    check(n == int(p_n[0]) and torch.equal(chunks[:n], p_chunks[:n]), "ivf_group_probes: chunks differ")
    for cluster in chunks[:n, 0].unique().tolist():
        rows = chunks[:n][chunks[:n, 0] == cluster]
        lo, hi = int(rows[0, 1]), int(rows[-1, 1] + rows[-1, 2])
        check(set(order[lo:hi].tolist()) == set(p_order[lo:hi].tolist()), f"ivf_group_probes: cluster {cluster}")
    # The kernel is shorter than its host call: timed queued behind a device
    # sleep. The plain version reads the counts back to the host.
    ms = queued_ms(torch, lambda: group_probes(probe, n_clusters))
    plain_ms = cuda_ms(torch, lambda: group_probes_plain(probe, n_clusters))
    # Each pair id read once; the order, the chunks and their count written once.
    bnd = bound(nbytes(probe) + probe.numel() * 4 + n * 12 + 4, 0)
    log(f"kernel ivf_group_probes pairs={probe.numel()} clusters={n_clusters}: {n} chunks of at most 32 pairs, "
        f"as the plain grouping's; kernel {ms:.4f} ms on the device, plain {plain_ms:.4f} ms, "
        f"bound {bnd['bound_ms']:.6f} ms ({bnd['bound_by']})")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None}


def check_ivf_probe(torch) -> dict[str, dict]:
    """B4 over bf16 and over int8 blocks at the IVF tier's shapes, with
    padding slots in every block and probe ids shared across queries."""
    from tensortruth_tpu_torch.ops.ivf import probe_scores, probe_scores_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    b, nprobe, c, rpc, d = (PROBE_SHAPE[x] for x in ("b", "nprobe", "clusters", "rpc", "d"))
    q = unit_rows(torch, gen, b, d, torch.bfloat16)
    valid = (torch.rand((c, rpc), generator=gen, device="cuda") > 0.3).to(torch.int32)
    valid[:, -128:] = 0  # every block ends in padding, as build_ivf leaves it
    probe = torch.randint(0, c, (b, nprobe), generator=gen, device="cuda", dtype=torch.int32)
    probe[:, 0] = probe[0, 0].item()  # one cluster every query probes
    probe[1::2, 1] = probe[0, 1].item()  # and one half of them do
    pad = valid[probe.long()] == 0
    out = {}
    for name in ("ivf_probe", "ivf_probe_int8"):
        int8 = name.endswith("int8")
        blocks = torch.empty((c, rpc, d), dtype=torch.int8 if int8 else torch.bfloat16, device="cuda")
        scales = torch.empty((c, rpc), device="cuda") if int8 else None
        for c0 in range(0, c, 64):
            x = unit_rows(torch, gen, 64 * rpc, d, torch.float32)
            if int8:  # quantize_corpus's arithmetic, on the card
                s = x.abs().amax(dim=1).div(127.0).clamp(min=1e-12)
                x = torch.round(x / s[:, None]).clamp(-127, 127)
                scales[c0 : c0 + 64] = s.view(64, rpc)
            blocks[c0 : c0 + 64] = x.view(64, rpc, d).to(blocks.dtype)
            del x
        got = probe_scores(probe, q, blocks, valid, scales)
        want = probe_scores_plain(probe, q, blocks, valid, scales)
        torch.cuda.synchronize()
        check(torch.equal(torch.isneginf(got), pad) and torch.equal(torch.isneginf(want), pad),
              f"{name}: -inf not exactly on the padding slots")
        err = (got[~pad] - want[~pad]).abs().max().item()
        check(err <= PROBE_TOL, f"{name}: max |err| {err} > {PROBE_TOL}")
        exact = ""
        if int8:  # int8 rows with integer queries at scale 1: every score exact, whatever the order of the sums
            iq = torch.randint(-3, 4, (b, d), generator=gen, device="cuda").to(torch.bfloat16)
            ones = torch.ones_like(scales)
            check(torch.equal(probe_scores(probe, iq, blocks, valid, ones), probe_scores_plain(probe, iq, blocks, valid, ones)),
                  f"{name}: integer rows at scale 1 not bit-exact")
            exact = ", integer rows at scale 1 bit-exact"
            out["ivf_group_probes"] = check_group_probes(torch, probe, c)
        ms, plain_ms = in_turns(
            torch, lambda: probe_scores(probe, q, blocks, valid, scales),
            lambda: probe_scores_plain(probe, q, blocks, valid, scales),
        )
        # What this probe array needs: each valid row of a probed cluster read
        # once (with its scale), the probed clusters' valid flags, and one dot
        # product per (query, valid probed slot).
        probed = torch.unique(probe.long())
        rows = int(valid[probed].sum())
        n_bytes = rows * (d * blocks.element_size() + (4 if int8 else 0)) + probed.numel() * rpc * 4
        bnd = bound(n_bytes + nbytes(probe, q, got), 2 * d * int((~pad).sum()))
        log(
            f"kernel {name} B={b} nprobe={nprobe} clusters={c} rpc={rpc} D={d} "
            f"{blocks.dtype} blocks ({gib(blocks.numel() * blocks.element_size())}), "
            f"{int(pad.sum())} padding slots probed: max_abs_err={err:.3g} (tol {PROBE_TOL}){exact}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {probed.numel()} distinct clusters probed, "
            f"{rows} valid rows in them: bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})"
        )
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": None}
        del blocks, scales, got, want
        torch.cuda.empty_cache()
    return out


def attention_err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, max |out - ref| / max(1, |ref|)) over all outputs."""
    diff = (out.float() - ref.float()).abs()
    return diff.max().item(), (diff / ref.float().abs().clamp(min=1.0)).max().item()


def check_attention(torch) -> dict:
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from tensortruth_tpu_torch.ops.attention import attention_reference, blocked_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    b, nh, dh = 16, 16, 64
    worst, timing = 0.0, {}
    for s in (512, 1024, 2048):
        q, k, v = (
            torch.randn((b, nh, s, dh), generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(3)
        )
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
        lengths[0], lengths[3] = s, 0  # one full row, one fully padded row
        mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
        out = blocked_attention(q, k, v, mask)
        ref = attention_reference(q, k, v, mask)
        torch.cuda.synchronize()
        err, scaled = attention_err(out, ref)
        check(torch.isfinite(out.float()).all().item(), f"blocked_attention S={s}: non-finite output")
        check(scaled <= ATTN_TOL, f"blocked_attention S={s}: max |err| / max(1, |plain|) {scaled} > {ATTN_TOL}")
        uniform = v[3].float().mean(dim=1, keepdim=True).expand(nh, s, dh)
        pad_err = (out[3].float() - uniform).abs().max().item()
        check(pad_err <= ATTN_TOL, f"blocked_attention S={s}: padded row is not the mean of V ({pad_err})")
        ms, plain_ms = in_turns(
            torch, lambda: blocked_attention(q, k, v, mask), lambda: attention_reference(q, k, v, mask)
        )
        # The library yardstick: the same function with the -1e9 bias as a float mask.
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(q.dtype)
        lib_err = (sdpa(q, k, v, attn_mask=bias).float() - ref.float()).abs().max().item()
        library_ms = cuda_ms(torch, lambda: sdpa(q, k, v, attn_mask=bias))
        # What this mask needs: every query row against its real keys (a
        # fully padded row averages all of V), read once.
        keys = int(torch.where(lengths > 0, lengths, s).sum())
        bnd = bound(nbytes(q, out, mask) + nbytes(k, v) * keys // (b * s), 4 * nh * s * dh * keys)
        log(
            f"kernel blocked_attention B={b} NH={nh} S={s} DH={dh} bf16: max_abs_err={err:.3g}, over "
            f"max(1, |plain|) {scaled:.3g} (tol {ATTN_TOL}), padded-row err={pad_err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, {keys} of {b * s} keys real), "
            f"scaled_dot_product_attention {library_ms:.4f} ms (max |err| {lib_err:.3g}, not asserted)"
        )
        worst = max(worst, err)
        timing[s] = {"max_abs_err": err, "max_scaled_err": scaled, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": library_ms}
        del q, k, v, out, ref, bias
        torch.cuda.empty_cache()
    # The top-level numbers are S=1024's, the bucket the main path's long
    # request lands in; every S measured is under "by_seq".
    top = {key: val for key, val in timing[1024].items() if key not in ("max_abs_err", "max_scaled_err")}
    return {"max_abs_err": worst, **top, "by_seq": {str(s): t for s, t in timing.items()}}


@contextmanager
def b3_forwards():
    """(model config, mask) of every encoder forward that takes kernel B3
    while the block runs: ``models/xlmr.py::encoder_forward``, which every
    embed and rerank forward goes through, is wrapped."""
    from tensortruth_tpu_torch.models import xlmr

    forwards = []
    forward = xlmr.encoder_forward

    def recorded(model, ids, mask, type_ids=None):
        if xlmr.use_flash(model.cfg, mask.shape[1], mask.device):
            forwards.append((model.cfg, mask))
        return forward(model, ids, mask, type_ids=type_ids)

    xlmr.encoder_forward = recorded
    try:
        yield forwards
    finally:
        xlmr.encoder_forward = forward


def check_attention_on_path(torch, path: str, forwards) -> list[dict]:
    """B3 against its plain version on each mask a path gave it (the padded
    rows and lengths of that forward), with random q, k, v laid out as the
    encoder's (B, NH, S, DH) views of a (B, S, H) projection. The plain
    version runs 16 rows at a time (rows are independent) to bound its
    (B, NH, S, S) f32 scores; each (B, S) is timed once on its first mask:
    the kernel, the plain version (its 16-row pieces in turn) and
    ``scaled_dot_product_attention`` with the -1e9 bias as a float mask."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from tensortruth_tpu_torch.ops.attention import attention_reference, blocked_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    shapes = {}
    for cfg, mask in forwards:
        (b, s), nh, dh = mask.shape, cfg.num_heads, cfg.head_dim
        q, k, v = (
            torch.randn((b, s, nh * dh), generator=gen, device="cuda").to(torch.bfloat16)
            .view(b, s, nh, dh).transpose(1, 2)
            for _ in range(3)
        )
        out = blocked_attention(q, k, v, mask)
        check(torch.isfinite(out.float()).all().item(), f"blocked_attention on the {path} path B={b} S={s}: non-finite")
        errs = [attention_err(out[i : i + 16], attention_reference(*(t[i : i + 16] for t in (q, k, v, mask))))
                for i in range(0, b, 16)]
        err, scaled = max(e for e, _ in errs), max(e for _, e in errs)
        check(scaled <= ATTN_TOL,
              f"blocked_attention on the {path} path B={b} S={s}: max |err| / max(1, |plain|) {scaled} > {ATTN_TOL}")
        entry = shapes.setdefault((b, s), {"b": b, "nh": nh, "s": s, "dh": dh, "forwards": 0,
                                           "max_abs_err": 0.0, "max_scaled_err": 0.0})
        entry["forwards"] += 1
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["max_scaled_err"] = max(entry["max_scaled_err"], scaled)
        if "ms" not in entry:
            lengths = mask.sum(dim=1)
            keys = int(torch.where(lengths > 0, lengths, s).sum())
            entry["rows_real"] = int((lengths > 0).sum())
            entry["ms"] = cuda_ms(torch, lambda: blocked_attention(q, k, v, mask))

            def plain():
                for i in range(0, b, 16):
                    attention_reference(*(t[i : i + 16] for t in (q, k, v, mask)))

            entry["plain_ms"] = cuda_ms(torch, plain, iters=5, warmup=1)
            bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(q.dtype)
            entry["library_ms"] = cuda_ms(torch, lambda: sdpa(q, k, v, attn_mask=bias))
            entry.update(bound(nbytes(q, out, mask) + nbytes(k, v) * keys // (b * s), 4 * nh * s * dh * keys))
            del bias
        del q, k, v, out
    torch.cuda.empty_cache()
    for e in shapes.values():
        log(f"kernel blocked_attention on the {path} path B={e['b']} NH={e['nh']} S={e['s']} DH={e['dh']} ({e['forwards']} "
            f"forwards, {e['rows_real']} of {e['b']} rows real in the first): max_abs_err={e['max_abs_err']:.3g}, "
            f"over max(1, |plain|) {e['max_scaled_err']:.3g} (tol {ATTN_TOL}); kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, scaled_dot_product_attention {e['library_ms']:.4f} ms, bound "
            f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
    return list(shapes.values())


def check_tc_matmul(torch) -> dict[str, dict]:
    """B5 at the int8 probe's shape and on its inputs, bf16 and int8, both
    block orders, against its plain version; timed beside the library's
    product of the same operands into the same output type (``library_ms``).
    The int8 product is also timed beside ``torch._int_mm`` on a column-major
    copy of b (cuBLAS's int8 kernels take b K-major; the copy is made outside
    the timing), and its b^T kernel alone."""
    from tensortruth_tpu_torch.ops.matmul import tc_matmul, tc_matmul_plain, transpose_int8_cuda
    from tensortruth_tpu_torch.scripts.probe_int8_mma import K, M, N, make_inputs

    inputs = make_inputs(device="cuda")
    library = {"bf16": lambda a, b: torch.mm(a, b, out_dtype=torch.float32), "int8": torch._int_mm}
    out = {}
    for name, operands in (("tc_matmul", "bf16"), ("tc_matmul_int8", "int8")):
        a, b = inputs[operands]
        want = tc_matmul_plain(a, b)
        err = 0.0
        for n_outer in (False, True):
            got = tc_matmul(a, b, n_outer=n_outer)
            torch.cuda.synchronize()
            check(got.dtype == want.dtype and got.shape == want.shape, f"{name}: {got.dtype} {tuple(got.shape)}")
            if operands == "int8":
                check(torch.equal(got, want), f"{name} (n_outer={n_outer}): not bit-exact")
            else:
                err = max(err, (got - want).abs().max().item())
                check(err <= MATMUL_TOL, f"{name} (n_outer={n_outer}): max |err| {err} > {MATMUL_TOL}")
            del got
        lib = library[operands]
        lib_err = (lib(a, b).double() - want.double()).abs().max().item()
        ms, plain_ms = in_turns(torch, lambda: tc_matmul(a, b), lambda: tc_matmul_plain(a, b))
        n_outer_ms = cuda_ms(torch, lambda: tc_matmul(a, b, n_outer=True))
        library_ms = cuda_ms(torch, lambda: lib(a, b))
        bnd = bound(nbytes(a, b, want), 2 * M * K * N, operands)
        extra = ""
        if operands == "int8":
            b_cm = b.t().contiguous().t()
            check(torch.equal(torch._int_mm(a, b_cm), want), f"{name}: torch._int_mm on column-major b differs")
            extra = (f"; torch._int_mm with b column-major {cuda_ms(torch, lambda: torch._int_mm(a, b_cm)):.4f} ms "
                     f"(bit-exact); the kernel's b^T alone {queued_ms(torch, lambda: transpose_int8_cuda(b)):.4f} ms "
                     f"on the device ({cuda_ms(torch, lambda: transpose_int8_cuda(b)):.4f} ms a call from the host)")
            del b_cm
        log(
            f"kernel {name} M={M} K={K} N={N} {operands} -> {want.dtype}: max_abs_err={err:.3g} "
            f"({'bit-exact' if operands == 'int8' else f'tol {MATMUL_TOL}'}, both block orders); kernel "
            f"{ms:.4f} ms ({2 * M * K * N / ms / 1e9:.1f} TOPS), N-tile-major {n_outer_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), library {library_ms:.4f} ms "
            f"({2 * M * K * N / library_ms / 1e9:.1f} TOPS; max |err| {lib_err:.3g}, not asserted){extra}"
        )
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": library_ms}
        del want
        torch.cuda.empty_cache()
    bf16, int8 = out["tc_matmul"], out["tc_matmul_int8"]
    log(f"B5 int8 over bf16: {bf16['ms'] / int8['ms']:.3f}x measured; the bounds allow "
        f"{bf16['bound_ms'] / int8['bound_ms']:.3f}x at this shape")
    return out


# -- phase 4: the build path -------------------------------------------------

# The ``corpus`` module: measure_build.py's docs (measure_e2e_build.py's
# generator) from SEED, 192 docs of 11,000 words, about 2.1M words: the size of
# one large library's documentation.
BUILD_DOCS = 192
BUILD_MODULES = ("corpus", "docs", "docs_semantic")
SEMANTIC_QUESTIONS = [
    "How does the engine merge leaf chunks into their parents?",
    "How are documents chunked into a hierarchy before indexing?",
]


def docs_files() -> list[Path]:
    """This repository's docs: the text of the ``docs`` module."""
    return sorted((ROOT / "docs").glob("*.md")) + [ROOT / "README.md", ROOT / "SURVEY.md"]


@contextmanager
def build_stages():
    """Host seconds of ``build_module``'s stages as ``build_db.main`` drives
    it (load documents, chunk, embed, save), and the host's waits for the
    card (``Embedder.encode`` draining a slab) while it chunks: the
    references that ``indexing/builder.py`` holds to ``load_documents``,
    ``chunk_document`` and ``VectorIndex``, and the embedder module's
    ``to_host_async``, are wrapped while the block runs."""
    from tensortruth_tpu_torch.indexing import builder
    from tensortruth_tpu_torch.models import embedder

    stats = {"seconds": {}, "chunk_waits": 0}
    saved = {name: getattr(builder, name) for name in ("load_documents", "chunk_document", "VectorIndex")}
    to_host_async = embedder.to_host_async
    chunking = False

    def timed(stage, fn):
        def call(*args, **kwargs):
            nonlocal chunking
            t = time.perf_counter()
            chunking = stage == "chunk"
            try:
                return fn(*args, **kwargs)
            finally:
                chunking = False
                stats["seconds"][stage] = stats["seconds"].get(stage, 0.0) + time.perf_counter() - t
        return call

    def counted_to_host(x):
        wait = to_host_async(x)

        def counted_wait():
            stats["chunk_waits"] += chunking
            return wait()

        return counted_wait

    class TimedIndex(saved["VectorIndex"]):
        build = classmethod(timed("embed", saved["VectorIndex"].build.__func__))
        save = timed("save", saved["VectorIndex"].save)

    builder.load_documents = timed("load documents", saved["load_documents"])
    builder.chunk_document = timed("chunk", saved["chunk_document"])
    builder.VectorIndex = TimedIndex
    embedder.to_host_async = counted_to_host
    try:
        yield stats
    finally:
        for name, value in saved.items():
            setattr(builder, name, value)
        embedder.to_host_async = to_host_async


def bucket_histogram(embedder, texts) -> tuple[dict, int]:
    """({seq bucket: texts}, tokens) as ``Embedder.encode`` pads them."""
    from tensortruth_tpu_torch.models.embedder import bucket

    _, mask = embedder.tokenizer.encode_batch(list(texts), embedder.max_length)
    lengths = mask.sum(axis=1)
    hist = Counter(bucket(int(n), embedder.seq_buckets) for n in lengths)
    return dict(sorted(hist.items())), int(lengths.sum())


def lay_out(modules: dict[str, dict[str, str]]) -> None:
    """A ``sources.json`` naming each of ``modules`` as a library, and its
    files (name -> text) under ``library_docs/library_<module>/``."""
    from tensortruth_tpu_torch.app.paths import get_library_docs_dir
    from tensortruth_tpu_torch.app.sources import save_user_sources

    save_user_sources({"libraries": {m: {} for m in modules}, "papers": {}, "books": {}})
    for module, files in modules.items():
        folder = get_library_docs_dir() / f"library_{module}"
        folder.mkdir(parents=True)
        for name, text in files.items():
            (folder / name).write_text(text, encoding="utf-8")


def build(torch, module: str, *flags: str, profiled: bool = False) -> dict:
    """``build_db.main(["--modules", module, *flags])`` on the card, timed
    by stage, with B3's launches and the forwards that took it, the host's
    waits while chunking and the peak device memory of the build;
    ``profiled`` runs it under torch.profiler for the device's kernel time
    and B3's share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tensortruth_tpu_torch import build_db
    from tensortruth_tpu_torch.ops.attention import blocked_attention

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blocked_attention.launches = 0
    prof = profile(activities=[ProfilerActivity.CUDA]) if profiled else nullcontext()
    with build_stages() as stats, b3_forwards() as forwards, prof:
        t = time.perf_counter()
        rc = build_db.main(["--modules", module, *flags])
        stats["wall"] = time.perf_counter() - t
    check(rc == 0, f"build_db.main --modules {module} {' '.join(flags)}: exit code {rc}")
    stats["b3_launches"] = blocked_attention.launches
    stats["b3_forwards"] = forwards
    check(sum(cfg.num_layers for cfg, _ in forwards) == stats["b3_launches"],
          f"build {module}: {len(forwards)} forwards at S >= 512 do not account for {stats['b3_launches']} B3 launches")
    if profiled:
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        stats["device_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3
        stats["b3_ms"] = sum(e.self_device_time_total for e in kernels if "attention_kernel" in e.key) / 1e3
    stats["peak"] = torch.cuda.max_memory_allocated()
    stats["peak_reserved"] = torch.cuda.max_memory_reserved()
    return stats


def node_spans(nodes) -> set:
    """Each node as (doc_id, file, level, start, end, text) with its
    parent's span: what two chunkings share whatever their node ids."""
    by_id = {n.node_id: n for n in nodes}

    def span(n):
        return (n.doc_id, n.metadata["filename"], n.level, n.start, n.end, n.text)

    return {(span(n), span(by_id[n.parent_id]) if n.parent_id else None) for n in nodes}


def docs_texts() -> dict[str, str]:
    """The ``docs`` module's files: name -> text."""
    return {f.name: f.read_text(encoding="utf-8") for f in docs_files()}


def run_build_path(torch, card: str) -> tuple[int, list[dict]]:
    """Lay out a ``sources.json`` and ``library_docs/`` for three modules,
    build them with the port's ``build_db.main`` on the card, check what it
    wrote and B3 on the inputs the builds gave it, serve the semantic index,
    and time the embed loop alone and chunking + embedding (the port's
    ``scripts/measure_build.py``). Returns B3's launches during the builds
    and its check at their shapes."""
    import numpy as np

    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig
    from tensortruth_tpu_torch.app.paths import get_base_indexes_dir
    from tensortruth_tpu_torch.index import VectorIndex
    from tensortruth_tpu_torch.indexing import list_modules_for_model
    from tensortruth_tpu_torch.models.manager import ModelManager
    from tensortruth_tpu_torch.ops.topk import fused_topk
    from tensortruth_tpu_torch.scripts import measure_build
    from tensortruth_tpu_torch.services.rag_service import RAGService

    t0 = time.perf_counter()
    docs = measure_build.synth_docs(BUILD_DOCS, SEED)
    lay_out({"corpus": {f"doc_{i:03d}.md": text for i, text in enumerate(docs)},
             "docs": docs_texts(), "docs_semantic": docs_texts()})
    log(f"build inputs: sources.json with {len(BUILD_MODULES)} library modules; corpus {BUILD_DOCS} docs, "
        f"{sum(len(d.split()) for d in docs)} words; docs and docs_semantic {len(docs_files())} files each; "
        f"laid out in {time.perf_counter() - t0:.1f} s")

    model_dir = get_base_indexes_dir() / "bge-m3"
    b3_launches, b3_inputs = 0, []
    for module, flags in (("corpus", ()), ("docs", ()), ("docs_semantic", ("--chunking-strategy", "semantic"))):
        stats = build(torch, module, *flags, profiled=module == "docs_semantic")
        b3_launches += stats["b3_launches"]
        b3_inputs += stats["b3_forwards"]
        embedder = ModelManager.get_instance().get_embedder()  # the resident model the CLI loaded
        check(embedder.device.type == "cuda" and embedder.cfg.hidden_size == 1024 and embedder.cfg.num_layers == 24,
              f"build {module}: embedder on {embedder.device}, not BGE-M3 at full width on the card")
        index = VectorIndex.load(model_dir / f"library_{module}")
        hist, tokens = bucket_histogram(embedder, [n.text for n in index.rows_to_nodes(np.arange(index.n_rows))])
        n_nodes = len(index.store)
        stages = ", ".join(f"{k} {v:.2f} s" for k, v in stats["seconds"].items())
        log(f"build {module} ({' '.join(flags) or 'hierarchical'}): {n_nodes} nodes, {index.n_rows} leaves, "
            f"{tokens} leaf tokens; stages: {stages}; build_db.main {stats['wall']:.2f} s -> "
            f"{index.n_rows / stats['wall']:.1f} chunks/s ({index.n_rows / stats['seconds']['embed']:.1f} in the "
            f"embed stage); peak device memory {gib(stats['peak'])}, reserved {gib(stats['peak_reserved'])}; "
            f"B3 launches {stats['b3_launches']}; leaves by seq bucket {hist}; host waits while chunking "
            f"{stats['chunk_waits']} ({card})")
        if module == "corpus":
            check(index.n_rows >= 8000, f"build corpus: {index.n_rows} leaves, wanted >= 8000")
        if module == "docs":
            want = node_spans(docs_nodes(embedder.tokenizer))
            got = node_spans(list(index.store.nodes()))
            check(got == want, f"build docs: {len(got ^ want)} nodes differ from docs_nodes() by span")
        if module == "docs_semantic":
            check(stats["b3_launches"] > 0, "build docs_semantic: kernel blocked_attention was not launched")
            log(f"build docs_semantic: {stats['chunk_waits'] / len(docs_files()):.2f} host waits per document "
                f"while chunking (one encode per document, drained before the next); profiled: device kernel "
                f"time {stats['device_ms']:.1f} ms in {stats['wall'] * 1e3:.1f} ms of build_db.main, B3 "
                f"{stats['b3_ms']:.2f} ms of it ({100 * stats['b3_ms'] / stats['device_ms']:.1f}%)")

    check(list_modules_for_model(get_base_indexes_dir(), "BAAI/bge-m3") == [f"library_{m}" for m in BUILD_MODULES],
          f"list_modules_for_model: {list_modules_for_model(get_base_indexes_dir(), 'BAAI/bge-m3')}")
    for module in BUILD_MODULES:
        meta = json.loads((model_dir / f"library_{module}" / "index_metadata.json").read_text())
        missing = {"embedding_model", "chunking_strategy", "chunk_sizes", "gelu"} - set(meta)
        check(not missing and meta["embedding_model"] == "BAAI/bge-m3", f"{module} metadata: {meta}")
        emb = VectorIndex.load(model_dir / f"library_{module}").matrix()[0]
        norms = np.linalg.norm(emb, axis=1)
        check(emb.dtype == np.float32 and np.isfinite(emb).all() and np.abs(norms - 1).max() < 1e-3,
              f"{module}: embeddings {emb.dtype}, norms {norms.min()}..{norms.max()}")

    svc = RAGService(config=TensorTruthTPUConfig.default(), llm_factory=lambda params: StubLLM())
    engine = svc.load_engine(["docs_semantic", "corpus"], {"reranker_top_n": 5},
                             indexes_dir=get_base_indexes_dir(), device="cuda")
    check(engine.retriever._stacked.is_cuda and engine.pipeline is not None, "semantic index not served on the card")
    fused_topk.launches = 0
    for text in SEMANTIC_QUESTIONS:
        r = svc.retrieve(text)
        check(r.sources, f"docs_semantic: no sources for {text[:40]!r}")
        log(f"docs_semantic + corpus served: {len(r.sources)} sources from "
            f"{sorted({s.metadata['module'] for s in r.sources})}, confidence {r.confidence}")
    check(fused_topk.launches > 0, "docs_semantic: kernel fused_topk was not launched")
    svc.clear_engines()

    b3_shapes = check_attention_on_path(torch, "build", b3_inputs)

    # scripts/measure_build.py's own measurement, its numbers printed there.
    log(f"scripts/measure_build.py on the build's embedder ({card}):")
    measure_build.run(embedder)
    profile_encode(torch, embedder, measure_build.synth_chunks(measure_build.N_CHUNKS, SEED))
    return b3_launches, b3_shapes


def profile_encode(torch, embedder, texts) -> None:
    """Replay the encode-only measurement under torch.profiler: the device's
    kernel time against the wall time, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        embedder.encode(texts)
        wall = (time.perf_counter() - t) * 1e3
    kernels = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profiled encode of {len(texts)} leaves: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f}% of wall) in {sum(e.count for e in kernels)} kernel launches")
    for e in kernels[:8]:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")


# -- phase 6: the main path --------------------------------------------------


def docs_nodes(tokenizer) -> list:
    """The ``docs`` module chunked directly, each file's doc_id its name as
    ``indexing/builder.py::build_module`` gives it."""
    from tensortruth_tpu_torch.index import chunk_document

    nodes = []
    for f in docs_files():
        meta = {"filename": f.name, "doc_type": "library"}
        nodes += chunk_document(
            f.read_text(encoding="utf-8"), tokenizer, doc_id=f.name, module="docs", metadata=meta
        )
    return nodes


def synthetic_index(torch, n_rows: int, dim: int, device: str = "cuda"):
    """``n_rows`` leaves, two per ~512-token parent, texts from a shared pool
    of POOL_SIZE strings, rows random unit vectors from SEED."""
    import numpy as np

    from tensortruth_tpu_torch.index import HierarchyStore, Node, VectorIndex

    words = "retrieval engine shard merge index token kernel matmul embed chunk".split()
    pool = [
        " ".join(f"c{j}" if i == 0 else words[(i + j) % len(words)] for i in range(CHUNK_WORDS[j % len(CHUNK_WORDS)]))
        for j in range(POOL_SIZE)
    ]
    parents = [pool[2 * j] + " " + pool[2 * j + 1] for j in range(POOL_SIZE // 2)]
    store = HierarchyStore()
    for p in range(-(-n_rows // 2)):
        doc = f"synthetic_{p // 64}"
        meta = {"filename": f"{doc}.md", "doc_type": "library"}
        kids = [f"s{p}.{c}" for c in range(2) if 2 * p + c < n_rows]
        store.add(Node(node_id=f"s{p}", text=parents[p % len(parents)], level=0, doc_id=doc,
                       module="synthetic", child_ids=list(kids), metadata=meta))
        for c, kid in enumerate(kids):
            store.add(Node(node_id=kid, text=pool[(2 * p + c) % POOL_SIZE], level=1, doc_id=doc,
                           module="synthetic", parent_id=f"s{p}", metadata=meta))
    row_ids = store.finalize_leaves()
    check(len(row_ids) == n_rows, f"synthetic module has {len(row_ids)} leaves, wanted {n_rows}")
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    emb = unit_rows(torch, gen, n_rows, dim, torch.float32).cpu().numpy().astype(np.float32)
    meta = {"embedding_model": "BAAI/bge-m3", "gelu": "exact", "chunk_sizes": [512, 256]}
    return VectorIndex(emb, row_ids, store, meta)


@dataclass
class Delta:
    """One streamed chunk of the chat model's answer."""

    text: str = ""
    thinking: str = ""


class StubLLM:
    """Stands in for the chat model; echoes how much context it was given."""

    def __init__(self):
        self.prompts = []

    def complete(self, prompt):
        return prompt

    def stream_chat(self, messages, system=None):
        self.prompts.append(messages[-1]["content"])
        yield Delta(text=f"stub answer over {len(messages[-1]['content'])} prompt chars")


def long_passage(tokenizer, min_tokens: int = 640) -> str:
    """A pasted passage of SURVEY.md just over ``min_tokens`` tokens: its
    embedder bucket is 1024, and so are its rerank pairs'."""
    words = (ROOT / "SURVEY.md").read_text(encoding="utf-8").split()
    n = 64
    while len(tokenizer.encode(" ".join(words[:n]))) < min_tokens:
        n += 8
    return " ".join(words[:n])


def profile_request(torch, svc, text: str) -> None:
    """Replay one request (cache cleared, shapes warm) under torch.profiler:
    wall time against the device's kernel time, the kernels that dominate
    it, and the host's stream synchronises and copies. The rerank stage
    launches its batches (one ``aten::sigmoid`` each) without a stream
    synchronise between them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    svc.engine.retriever.clear_cache()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        svc.retrieve(text)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    n = sum(e.count for e in kernels)
    log(f"profiled replay of request 0: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f}% of wall) in {n} kernel launches")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    # The six that take the most time, and the main path's own kernels (B1's
    # topk_*, B3's attention_kernel) wherever they rank.
    for e in ranked[:6] + [e for e in ranked[6:] if "attention_kernel" in e.key or "topk_" in e.key]:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms  x{e.count:<5d} {e.key[:90]}")
    events = prof.events()
    syncs = [e for e in events if e.name == "cudaStreamSynchronize"]
    copies = sum(e.name == "cudaMemcpyAsync" for e in events)
    batches = sorted(e.time_range.start for e in events if e.name == "aten::sigmoid")
    check(batches, "profiled replay: no rerank batch was launched")
    between = [e for e in syncs if batches[0] < e.time_range.start < batches[-1]]
    log(f"  host: {len(syncs)} cudaStreamSynchronize, {copies} cudaMemcpyAsync, "
        f"{sum(e.name == 'cudaEventSynchronize' for e in events)} cudaEventSynchronize in the request; "
        f"{len(batches)} rerank batches, {len(between)} stream synchronises between their launches")
    runtime = sorted((e for e in prof.key_averages() if e.key.startswith("cuda")), key=lambda e: -e.cpu_time_total)
    log("  host time in CUDA runtime calls: "
        + ", ".join(f"{e.key} x{e.count} {e.cpu_time_total / 1e3:.1f} ms" for e in runtime[:6]))
    check(not between, f"profiled replay: {len(between)} stream synchronises between the rerank batches")


def run_main_path(torch, work: Path) -> tuple[dict, list[dict]]:
    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig
    from tensortruth_tpu_torch.index import VectorIndex
    from tensortruth_tpu_torch.models.manager import ModelManager, ModelSpec
    from tensortruth_tpu_torch.ops.attention import blocked_attention
    from tensortruth_tpu_torch.ops.topk import exact_topk, fused_topk
    from tensortruth_tpu_torch.services.rag_service import RAGService

    t0 = time.perf_counter()
    embedder = ModelManager.get_instance().get_embedder(ModelSpec("BAAI/bge-m3"), device="cuda")
    model_dir = work / "indexes" / "bge-m3"
    docs = VectorIndex.load(model_dir / "library_docs")  # what build_db.main wrote in the build path
    synthetic_index(torch, CORPUS_ROWS - docs.n_rows, embedder.dim).save(model_dir / "synthetic")
    log(f"index: docs {docs.n_rows} leaves ({len(docs.store)} nodes, built by build_db.main), "
        f"synthetic {CORPUS_ROWS - docs.n_rows} leaves, written in {time.perf_counter() - t0:.1f} s")

    llm = StubLLM()
    svc = RAGService(config=TensorTruthTPUConfig.default(), llm_factory=lambda params: llm)
    t0 = time.perf_counter()
    engine = svc.load_engine(["docs", "synthetic"], {"reranker_top_n": 5},
                             indexes_dir=work / "indexes", device="cuda")
    log(f"engine: loaded in {time.perf_counter() - t0:.1f} s")
    corpus = engine.retriever._stacked
    check(corpus.is_cuda and tuple(corpus.shape) == (CORPUS_ROWS, 1024) and engine.retriever.n_chunks == CORPUS_ROWS,
          f"corpus {tuple(corpus.shape)} on {corpus.device}, {engine.retriever.n_chunks} rows")
    for name, runtime in (("embedder", engine.embedder), ("reranker", engine.reranker)):
        n_params = sum(p.numel() for p in runtime.model.parameters())
        check(all(p.is_cuda for p in runtime.model.parameters()), f"{name} parameters off the card")
        check(runtime.cfg.hidden_size == 1024 and runtime.cfg.num_layers == 24, f"{name} not at full width")
        log(f"{name}: {runtime.model_id}, {n_params} parameters, {runtime.model.dtype} on {runtime.device}")
    check(engine.pipeline is not None and engine.retriever.use_fused, "fused query step not in use")

    questions = [
        "How does the engine merge leaf chunks into their parents?",
        "What does the confidence gate do when the best rerank score is low?",
        "How are multiple module indexes stacked into one corpus matrix?",
        "Which models embed queries and rerank candidates?",
        "How is the server's chat protocol framed over the websocket?",
        "What happens when a module index is missing or corrupt?",
        long_passage(embedder.tokenizer),
    ]
    n_long = len(embedder.tokenizer.encode(questions[-1]))
    questions.append("How are documents chunked into a hierarchy before indexing?")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_topk.launches = 0
    blocked_attention.launches = 0
    request_ms, results, b3_seen = [], [], []
    with b3_forwards() as b3_inputs:
        for text in questions:
            t = time.perf_counter()
            results.append(svc.retrieve(text))
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t) * 1e3)
            b3_seen.append(len(b3_inputs))
        t = time.perf_counter()
        gen = svc.query("Summarise how a query flows from embedding to the reranked answer.")
        try:
            while True:
                next(gen)
        except StopIteration as stop:
            response = stop.value
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t) * 1e3)
        b3_seen.append(len(b3_inputs))
    launches = {"fused_topk": fused_topk.launches, "blocked_attention": blocked_attention.launches}
    check(sum(cfg.num_layers for cfg, _ in b3_inputs) == launches["blocked_attention"],
          f"{len(b3_inputs)} forwards at S >= 512 do not account for {launches['blocked_attention']} B3 launches")
    peak = torch.cuda.max_memory_allocated()

    for text, r in zip(questions, results):
        check(r.sources, f"no sources for {text[:40]!r}")
        for s in r.sources:
            check(s.score is not None and 0.0 <= s.score <= 1.0, f"bad rerank score {s.score}")
        check(r.confidence in ("normal", "low"), f"confidence {r.confidence}")
    check(response.sources and response.text.startswith("stub answer"), "query() gave no answer")
    check(llm.prompts and "[1]" in llm.prompts[-1], "query() sent no retrieved context to the LLM")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    log(f"requests: {len(request_ms)} (8 retrieve + 1 query), longest request {n_long} tokens")
    log("request ms: " + ", ".join(f"{ms:.1f}" for ms in request_ms))
    log(f"sources per request: {[len(r.sources) for r in results] + [len(response.sources)]}, "
        f"confidence: {[r.confidence for r in results] + [response.confidence]}")
    for i, r in enumerate(results + [response]):
        stages = ", ".join(f"{k} {v:.1f}" for k, v in r.metrics["timings"].items() if isinstance(v, float))
        log(f"request {i} stage ms (host clock): {stages}")
    log(f"launches during the requests: {launches}")
    # Which request reranks (or embeds) at S >= 512, and at what batch and
    # sequence buckets: the traffic B3 sees, request by request.
    log("forwards at S >= 512 per request, (B, S): " + "; ".join(
        f"{i}: {[tuple(m.shape) for _, m in b3_inputs[lo:hi]]}"
        for i, (lo, hi) in enumerate(zip([0] + b3_seen, b3_seen))))
    log(f"peak device memory during the requests: {peak} bytes ({peak / 2**30:.2f} GiB)")

    profile_request(torch, svc, questions[0])

    # The fused top-k on this corpus against the exact one, same query embeddings.
    q = torch.from_numpy(engine.embedder.encode(questions, is_query=True)).to("cuda", corpus.dtype)
    _, fused_idx = fused_topk(q, corpus, 20, n_actual=CORPUS_ROWS)
    _, exact_idx = exact_topk(q, corpus, 20, n_valid=CORPUS_ROWS)
    hits = sum(len(set(f.tolist()) & set(x.tolist())) for f, x in zip(fused_idx.cpu(), exact_idx.cpu()))
    recall = hits / exact_idx.numel()
    check(recall >= MIN_RECALL, f"fused top-20 recall {recall} < {MIN_RECALL}")
    log(f"fused vs exact top-20 recall over the corpus: {recall:.4f}")
    # What the requests' traffic is made of, to tell two runs' traffic apart:
    # the docs index's rows, the questions' embeddings, their fused top-20.
    digests = {name: hashlib.sha1(a.tobytes()).hexdigest()[:12] for name, a in (
        ("docs rows", docs.matrix()[0]), ("query embeddings", q.float().cpu().numpy()),
        ("fused top-20 rows", fused_idx.cpu().numpy()))}
    log(f"traffic digests (sha1): {digests}")
    return launches, check_attention_on_path(torch, "main", b3_inputs)


# -- phase 5: the server path (it runs before the main path, whose stub LLM
# and long passage it shares) ---------------------------------------------------

# The session's own document: this repository's docs/, line by line up to
# about 2,000 words (the size of a pasted chapter), uploaded as Markdown.
UPLOAD_NAME = "pasted_docs.md"
UPLOAD_WORDS = 2000
SERVER_MODULES = ["corpus"]  # 13,824 leaves + the session's own index: B1
SERVER_QUESTION = "How does the engine merge leaf chunks into their parents?"
# The chats in the order they search the corpus (``/help`` does not).
SERVER_SEARCHES = ["REST chat", "leaf question", "passage", "profiled chat"]
# This phase holds the direct RAG path, with a stub chat model seated in the
# service; the orchestrator's path, which a default session takes when its
# model reports tool calling, is driven by its own phase against a fake
# Ollama (run_orchestrator_path).
SERVER_PARAMS = {"orchestrator_enabled": False}


class ServerLLM(StubLLM):
    """The stub chat model behind the server: as a condenser it returns the
    follow-up unchanged (each message is already a standalone query), as a
    titler the prompt's first words."""

    def complete(self, prompt):
        if prompt.rstrip().endswith("Standalone Query:"):
            return prompt.rsplit("User Input: ", 1)[1].split("\n\nRewrite rules:", 1)[0]
        return " ".join(prompt.split()[:6])


def upload_text() -> str:
    """docs/*.md, line by line, until UPLOAD_WORDS words."""
    lines, words = [], 0
    for f in sorted((ROOT / "docs").glob("*.md")):
        for line in f.read_text(encoding="utf-8").splitlines():
            lines.append(line)
            words += len(line.split())
            if words >= UPLOAD_WORDS:
                return "\n".join(lines)
    raise RuntimeError(f"docs/ holds {words} words, fewer than {UPLOAD_WORDS}")


@contextmanager
def timed_loads(rag):
    """Seconds of each ``RAGService.load_engine`` call while the block runs
    (a cached engine returns at once; the first call builds it)."""
    seconds = []
    load = rag.load_engine

    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return load(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t)

    rag.load_engine = timed
    try:
        yield seconds
    finally:
        del rag.load_engine


def from_upload(sources) -> int:
    """How many of a message's sources come from the uploaded document."""
    return sum((s.get("metadata") or {}).get("filename") == UPLOAD_NAME for s in sources)


def trace_names_b1(path: str) -> int:
    """Events of B1's kernel (``topk_stream_kernel<Bf16Rows>``, demangled
    with its namespace) in a Chrome trace the server wrote."""
    return len(re.findall(r'"name": "[^"]*topk_stream_kernel<[^"]*Bf16Rows', Path(path).read_text(encoding="utf-8")))


@contextmanager
def b1_searches():
    """(query, k, returned scores, returned rows, corpus, keyword arguments)
    of every B1 search while the block runs: ``pipeline.py``'s
    ``fused_topk``, through which the server's queries reach the corpus, is
    wrapped."""
    from tensortruth_tpu_torch import pipeline

    searches = []
    search = pipeline.fused_topk

    def recorded(q, emb, k, **kwargs):
        vals, idx = search(q, emb, k, **kwargs)
        searches.append((q.clone(), k, vals.clone(), idx.clone(), emb, kwargs))
        return vals, idx

    pipeline.fused_topk = recorded
    try:
        yield searches
    finally:
        pipeline.fused_topk = search


def check_searches_against_plain(torch, path: str, searches) -> list[dict]:
    """Each captured B1 search against ``fused_topk_plain`` on the same
    query batch, corpus and arguments (TOPK_TOL, ties as in the kernel
    check). Returns one entry per query-batch shape: its count, max |err|
    and index swaps."""
    from tensortruth_tpu_torch.ops.topk import fused_topk_plain

    shapes = {}
    for i, (q, k, vals, idx, emb, kwargs) in enumerate(searches):
        err, swaps = check_topk_agrees(f"{path}: B1 search {i} (B={q.shape[0]}, N={emb.shape[0]}, k={k})",
                                       (vals, idx), fused_topk_plain(q, emb, k, **kwargs))
        entry = shapes.setdefault((q.shape[0], emb.shape[0], k), {"searches": 0, "max_abs_err": 0.0, "swaps": 0})
        entry.update(searches=entry["searches"] + 1, max_abs_err=max(entry["max_abs_err"], err),
                     swaps=entry["swaps"] + swaps)
    return [{"b": b, "b_pad": -(-b // 32) * 32, "n": n, "k": k, **e} for (b, n, k), e in sorted(shapes.items())]


def check_server_searches(torch, retriever, searches, leaf_id: str, names=SERVER_SEARCHES,
                          modules=SERVER_MODULES, path: str = "server") -> list[dict]:
    """Each B1 search of a server phase (``names``, in order) against a
    plain search of its query over the engine's indexes, stacked here from
    each index's own matrix (in bf16, as the engine holds them), rows named
    by node id: each returned score must be the plain score of its node, and
    the returned nodes must hold MIN_RECALL of the plain top-k (B1 keeps one
    candidate per bucket). The nodes of indexes outside ``modules`` (the
    session's own) are counted among both; the leaf question must return
    its leaf."""
    import numpy as np

    check(len(searches) == len(names), f"{path}: {len(searches)} B1 searches, not {len(names)}")
    ids, session = [], []
    pieces = []
    for mod in retriever.modules:
        index = retriever.indexes[mod]
        matrix, row_map = index.matrix()
        pieces.append(matrix)
        ids += [index.node_of_row(int(r)).node_id for r in row_map]
        session += [mod not in modules] * len(row_map)
    rows = torch.from_numpy(np.concatenate(pieces)).to("cuda", torch.bfloat16).float()
    plain_row = {nid: i for i, nid in enumerate(ids)}
    session = np.array(session)

    def engine_node(r: int) -> str:
        mod = retriever.modules[int(retriever._module_of_row[r])]
        return retriever.indexes[mod].node_of_row(int(retriever._row_map[r])).node_id

    out = []
    for name, (q, k, vals, idx, *_) in zip(names, searches):
        scores = (q.float() @ rows.T)[0]
        got = [engine_node(r) for r in idx[0].tolist()]
        at = torch.tensor([plain_row[n] for n in got], device="cuda")
        err = (vals[0] - scores[at]).abs().max().item()
        want = scores.topk(k).indices.tolist()
        recall = len({ids[i] for i in want} & set(got)) / k
        out.append({"chat": name, "k": k, "max_abs_err": err, "recall": recall,
                    "session_rows": int(session[at.tolist()].sum()), "plain_session_rows": int(session[want].sum())})
        check(err <= TOPK_TOL and recall >= MIN_RECALL,
              f"{path}: the {name}'s B1 search against the plain one: max |err| {err}, recall {recall}")
    check(leaf_id in {engine_node(r) for r in searches[names.index("leaf question")][3][0].tolist()},
          f"{path}: the leaf question's search does not return its leaf")
    return out


async def drive_http(torch, app, passage: str, work: Path) -> dict:
    """The server phase over HTTP and WebSocket: ``app`` served on
    127.0.0.1 in this process, driven as the SPA drives it."""
    from aiohttp import ClientSession, ClientTimeout, web

    from tensortruth_tpu_torch.app.paths import get_session_dir
    from tensortruth_tpu_torch.index.store import VectorIndex

    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    base = f"http://{host}:{port}"
    out = {"address": base}
    try:
        async with ClientSession(timeout=ClientTimeout(total=900)) as http:
            async def call(method, path, **kwargs):
                async with http.request(method, base + path, **kwargs) as r:
                    body = await r.json()
                    check(r.status == 200, f"{method} {path}: HTTP {r.status} {body}")
                    return body

            check(await call("GET", "/health") == {"status": "ok"}, "/health")
            devices = await call("GET", "/api/config/devices")
            kind = torch.cuda.get_device_name(0)
            check(devices["default_backend"] == "gpu" and [d["kind"] for d in devices["devices"]] == [kind],
                  f"/api/config/devices: {devices}, card {kind}")
            log(f"server: {base}, /api/config/devices {devices}")
            sid = (await call("POST", "/api/sessions", json={"modules": SERVER_MODULES, "params": SERVER_PARAMS}))["id"]

            t = time.perf_counter()
            up = await call("POST", f"/api/sessions/{sid}/documents", json={"filename": UPLOAD_NAME, "text": upload_text()})
            out["upload_s"], out["upload_chunks"] = time.perf_counter() - t, up["chunks"]
            check(up["status"] == "success" and up["chunks"] > 0, f"upload: {up}")
            # The leaf question: the upload's longest leaf, asked verbatim.
            index = VectorIndex.load(get_session_dir(sid) / "index")
            leaf = max((index.node_of_row(r) for r in range(index.n_alive)), key=lambda n: len(n.text.split()))
            out["leaf_id"] = leaf.node_id
            messages = ["/help", leaf.text.strip(), passage]

            t = time.perf_counter()
            rest = await call("POST", f"/api/sessions/{sid}/chat", json={"message": SERVER_QUESTION})
            out["rest_chat_s"] = time.perf_counter() - t
            check(rest["sources"] and rest["response"].startswith("stub answer"), f"REST chat: {rest}")
            out["rest_sources"] = [len(rest["sources"]), from_upload(rest["sources"])]

            out["messages"] = []
            async with http.ws_connect(f"{base}/ws/chat/{sid}") as ws:
                for text in messages:
                    t = time.perf_counter()
                    await ws.send_json({"message": text})
                    seen, frames = {}, []
                    while not frames or frames[-1]["type"] not in ("done", "error"):
                        frames.append(await ws.receive_json(timeout=600))
                        seen.setdefault(frames[-1]["type"], time.perf_counter() - t)
                    check("error" not in seen, f"WS {text[:40]!r}: error frame {frames[-1]}")
                    sources = next((f["sources"] for f in frames if f["type"] == "sources"), None)
                    out["messages"].append({"message": text[:40], "sources_s": seen.get("sources"),
                                            "done_s": seen["done"], "frames": sorted(seen),
                                            "sources": None if sources is None else [len(sources), from_upload(sources)]})
            for m in out["messages"][1:]:  # past /help
                check(m["sources"] and m["sources"][1] > 0,
                      f"WS {m['message']!r}: sources {m['sources']} (count, from the upload)")

            before = torch.cuda.memory_allocated()
            memory = await call("GET", "/api/system/memory")
            after = torch.cuda.memory_allocated()
            (dev,) = memory["devices"]
            check(min(before, after) <= dev["bytes_in_use"] <= max(before, after)
                  and dev["bytes_limit"] == torch.cuda.mem_get_info()[1],
                  f"/api/system/memory {dev}: memory_allocated {before}..{after}")
            out["memory"] = dev

            await call("POST", "/api/system/profile/start", json={"log_dir": str(work / "profiles")})
            profiled = await call("POST", f"/api/sessions/{sid}/chat", json={"message": SERVER_QUESTION + " (profiled)"})
            check(profiled["sources"], "profiled chat: no sources")
            stopped = await call("POST", "/api/system/profile/stop")
            out["trace_b1_events"] = trace_names_b1(stopped["trace"])
            out["trace_mb"] = Path(stopped["trace"]).stat().st_size / 2**20
    finally:
        await runner.cleanup()
    return out


def run_server_path(torch, work: Path) -> tuple[dict, dict, list[dict]]:
    """The port's server on the card over the indexes the build path wrote,
    over HTTP and WebSocket: a session over ``corpus`` with an uploaded
    document, one REST chat, three WS messages (``/help``, a leaf of the
    upload, a 640-token passage), the memory route, and one profiled chat.
    Returns (the phase's numbers, B1 and B3 launches, B3's check at the
    phase's shapes)."""
    import asyncio

    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig
    from tensortruth_tpu_torch.models.manager import ModelManager
    from tensortruth_tpu_torch.ops.attention import blocked_attention
    from tensortruth_tpu_torch.ops.topk import fused_topk
    from tensortruth_tpu_torch.server.app import create_app

    app = create_app(config=TensorTruthTPUConfig.default(), device="cuda")
    services = app["services"]
    check(services.device == "cuda", f"server on {services.device}")
    services.rag_service._llm_factory = lambda params: ServerLLM()
    resident = ModelManager.get_instance()._embedder
    passage = long_passage(ModelManager.get_instance().get_embedder().tokenizer)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_topk.launches = 0
    blocked_attention.launches = 0
    with timed_loads(services.rag_service) as loads, b3_forwards() as b3_inputs, b1_searches() as searches:
        out = asyncio.run(drive_http(torch, app, passage, work))
        torch.cuda.synchronize()
    launches = {"fused_topk": fused_topk.launches, "blocked_attention": blocked_attention.launches}
    engine = services.rag_service.engine
    uploaded = [out["rest_sources"][1]] + [m["sources"][1] for m in out["messages"] if m["sources"]]
    out["from_upload"] = uploaded
    out.update(engine_load_s=loads, peak_bytes=torch.cuda.max_memory_allocated(), launches=launches,
               embedder_reused=ModelManager.get_instance()._embedder is resident)
    log(f"server path (HTTP + WebSocket on {out['address']}): "
        f"corpus + session index {engine.retriever.n_chunks} rows; upload of {UPLOAD_WORDS} words {out['upload_s']:.2f} s "
        f"-> {out['upload_chunks']} chunks ({out['upload_chunks'] / out['upload_s']:.1f} chunks/s; embedder reused: "
        f"{out['embedder_reused']}); engine loads (s): {', '.join(f'{s:.3f}' for s in loads)}; REST chat "
        f"{out['rest_chat_s']:.3f} s ({out['rest_sources'][0]} sources, {out['rest_sources'][1]} from the upload)")
    for m in out["messages"]:
        at = "no sources" if m["sources_s"] is None else f"sources at {m['sources_s']:.3f} s"
        log(f"  message {m['message']!r}: {at}, done at {m['done_s']:.3f} s; "
            f"sources {m['sources']} (count, from the upload)")
    log(f"  peak device memory {gib(out['peak_bytes'])}; launches {launches}; profiled chat's trace "
        f"{out['trace_mb']:.1f} MiB, {out['trace_b1_events']} B1 kernel events; /api/system/memory {out['memory']}")
    log("forwards at S >= 512 on the server path, (B, S): " + str([tuple(m.shape) for _, m in b3_inputs]))
    check(sum(cfg.num_layers for cfg, _ in b3_inputs) == launches["blocked_attention"],
          f"server: {len(b3_inputs)} forwards at S >= 512 do not account for {launches['blocked_attention']} B3 launches")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the server path")
    check(engine is not None and engine.retriever._stacked.is_cuda and engine.retriever.use_fused
          and len(engine.retriever.modules) == 2, "server: the session's engine is not corpus + its index, fused, on the card")
    check(out["trace_b1_events"] > 0, "server: the profiled chat's trace does not name B1's kernel")
    check(len(searches) == launches["fused_topk"], f"server: {len(searches)} B1 searches, {launches['fused_topk']} launches")
    out["searches"] = check_server_searches(torch, engine.retriever, searches, out["leaf_id"])
    for s in out["searches"]:
        log(f"  B1 search of the {s['chat']} against the plain one: max |err| {s['max_abs_err']:.3g}, recall "
            f"{s['recall']:.2f} of {s['k']}; session index rows {s['session_rows']} (plain: {s['plain_session_rows']})")
    services.rag_service.clear_engines()
    return out, launches, check_attention_on_path(torch, "server", b3_inputs)


# -- phases 7-9: serving under load, the orchestrator, B1's recall --------------

# Concurrent WebSocket sessions over the main path's 262,144-row index (the
# ``docs`` index the build path wrote + the synthetic module), served by the
# port's app in this process through the port's serving driver
# (``scripts/measure_serving_e2e.py``): 32 sessions (the batcher's default
# query_batching_max_batch), 2 warm-up messages each, a 10 s window.
SERVING = {"concurrency": 32, "measure_s": 10.0, "warmup": 2}
SERVING_MODULES = ["docs", "synthetic"]
# The orchestrator's expected leaf: the first of the longest ``docs`` leaves
# whose own text, asked through the direct path, returns it among its
# sources (the random-weight reranker decides which 5 of the candidates
# stay, so not every leaf's own text keeps it).
ORCHESTRATOR_TRIES = 16
ORCHESTRATOR_SEARCHES = ["leaf question"]
# B1's measured recall may fall this far below the prediction
# 1 - k(k-1)/(2 c_out)/k: 0.01 is one item in 100 per query at k = 100, more
# than five standard deviations of a mean over 32 queries at either k (the
# lost items per query are about Poisson with mean k(k-1)/(2 c_out)).
RECALL_MARGIN = 0.01


async def orchestrate(base: str, modules: list[str], message: str) -> list[dict]:
    """One WS message through a session whose model (``fake-tools``)
    reports tool calling: the orchestrator's path."""
    from aiohttp import ClientSession, ClientTimeout

    from tensortruth_tpu_torch.scripts.measure_serving_e2e import TOOLS_MODEL, ask

    async with ClientSession(timeout=ClientTimeout(total=600)) as http:
        r = await http.post(f"{base}/api/sessions", json={"modules": modules, "params": {"model": TOOLS_MODEL}})
        check(r.status == 200, f"orchestrator: POST /api/sessions: HTTP {r.status}")
        sid = (await r.json())["id"]
        async with http.ws_connect(f"{base.replace('http', 'ws', 1)}/ws/chat/{sid}") as ws:
            return await ask(ws, message, timeout=600)


def run_orchestrator_path(torch, served) -> tuple[dict, dict, list]:
    """A session with the fake Ollama's tool-calling model, through the
    port's real provider code (the registry probes ``/api/show``,
    ``create_llm`` builds the Ollama provider; no LLM factory is seated):
    one leaf asked verbatim must give a ``tool_phase`` naming ``rag_query``,
    then ``sources`` holding the leaf and equal to the direct path's, then
    ``done``. Its B1 search is held against a plain search. Returns (the
    phase's numbers, B1 and B3 launches, B3's forwards)."""
    import asyncio

    from tensortruth_tpu_torch.ops.attention import blocked_attention
    from tensortruth_tpu_torch.ops.topk import fused_topk

    rag = served.services.rag_service
    check(rag._llm_factory is None, "orchestrator: an LLM factory is seated; the provider would be skipped")
    engine = rag.engine
    docs = engine.retriever.indexes["docs"]
    leaves = sorted((docs.node_of_row(r) for r in range(docs.n_alive)), key=lambda n: -len(n.text.split()))
    leaf, direct = None, None
    for node in leaves[:ORCHESTRATOR_TRIES]:
        direct = [s.id for s in rag.retrieve(node.text.strip(), engine=engine).sources]
        if node.node_id in direct:
            leaf = node
            break
    check(leaf is not None, f"orchestrator: none of the {ORCHESTRATOR_TRIES} longest docs leaves retrieves itself")

    torch.cuda.synchronize()
    fused_topk.launches = 0
    blocked_attention.launches = 0
    t = time.perf_counter()
    with b3_forwards() as b3_inputs, b1_searches() as searches:
        frames = asyncio.run(orchestrate(served.base, SERVING_MODULES, leaf.text.strip()))
        torch.cuda.synchronize()
    done_s = time.perf_counter() - t
    launches = {"fused_topk": fused_topk.launches, "blocked_attention": blocked_attention.launches}
    kinds = [f["type"] for f in frames]
    check("error" not in kinds, f"orchestrator: error frame {frames[-1]}")
    phase = next((f for f in frames if f["type"] == "tool_phase"), None)
    check(phase is not None and phase["tools"] == ["rag_query"]
          and phase["calls"] == [{"tool": "rag_query", "params": {"query": leaf.text.strip()}}],
          f"orchestrator: tool_phase {phase}")
    check("sources" in kinds and kinds.index("tool_phase") < kinds.index("sources") < kinds.index("done")
          and kinds[-1] == "done", f"orchestrator: frames {kinds}")
    sources = [s["id"] for s in next(f for f in frames if f["type"] == "sources")["sources"]]
    check(leaf.node_id in sources, f"orchestrator: sources {sources} do not hold the leaf {leaf.node_id}")
    check(sources == direct, f"orchestrator: sources {sources}, the direct path's {direct}")
    check(launches["fused_topk"] > 0, "kernel fused_topk was not launched on the orchestrator path")
    check(len(searches) == launches["fused_topk"],
          f"orchestrator: {len(searches)} B1 searches, {launches['fused_topk']} launches")
    check(sum(cfg.num_layers for cfg, _ in b3_inputs) == launches["blocked_attention"],
          f"orchestrator: {len(b3_inputs)} forwards at S >= 512 do not account for "
          f"{launches['blocked_attention']} B3 launches")
    out = {"leaf_id": leaf.node_id, "leaf_words": len(leaf.text.split()), "frames": kinds, "done_s": done_s,
           "sources": sources, "launches": launches,
           "searches": check_server_searches(torch, engine.retriever, searches, leaf.node_id,
                                             names=ORCHESTRATOR_SEARCHES, modules=SERVING_MODULES,
                                             path="orchestrator"),
           "shapes": check_searches_against_plain(torch, "orchestrator", searches)}
    log(f"orchestrator path: leaf {leaf.node_id} ({out['leaf_words']} words) asked verbatim through fake-tools: "
        f"frames {kinds}, done at {done_s:.3f} s; sources {sources} (the direct path's); launches {launches}")
    for s in out["searches"]:
        log(f"  B1 search of the {s['chat']} against the plain one: max |err| {s['max_abs_err']:.3g}, "
            f"recall {s['recall']:.2f} of {s['k']}")
    return out, launches, list(b3_inputs)


def run_serving_path(torch, work: Path) -> tuple[dict, dict, list[dict], dict, dict, list[dict]]:
    """Serving under load, then the orchestrator on the same fake Ollama and
    server. Every B1 search of the serving phase is held against its plain
    version. Returns (serving numbers, serving launches, B3's check at the
    serving shapes, orchestrator numbers, its launches, its B3 check)."""
    import asyncio

    from tensortruth_tpu_torch.ops.attention import blocked_attention
    from tensortruth_tpu_torch.ops.topk import fused_topk
    from tensortruth_tpu_torch.scripts import card_line, measure_serving_e2e as serving

    data_dir = work / "serving"
    data_dir.mkdir()
    with serving.launch(data_dir, work / "indexes", "cuda", in_process=True, tiny=False) as served:
        asyncio.run(serving.wait_health(served.base, timeout=600))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_topk.launches = 0
        blocked_attention.launches = 0
        with b3_forwards() as forwards, b1_searches() as searches:
            out = asyncio.run(serving.drive(served.base, SERVING_MODULES, **SERVING, tiny=False))
            torch.cuda.synchronize()
        launches = {"fused_topk": fused_topk.launches, "blocked_attention": blocked_attention.launches}
        peak_bytes = torch.cuda.max_memory_allocated()
        orchestrator, orch_launches, orch_forwards = run_orchestrator_path(torch, served)
    batcher, compared = out["batcher"], out["batched_vs_sequential"]
    check(len(searches) == launches["fused_topk"], f"serving: {len(searches)} B1 searches, {launches['fused_topk']} launches")
    out.update(launches=launches, peak_bytes=peak_bytes, card=card_line(),
               mean_batch=batcher["requests_served"] / max(1, batcher["batches_run"]),
               searches=check_searches_against_plain(torch, "serving", searches))
    del searches
    log(f"serving path ({SERVING['concurrency']} WS sessions over {out['n_chunks']} rows, "
        f"{SERVING['measure_s']} s window): {out['qps']:.2f} messages/s, p50 {out['p50_ms']:.1f} ms, p95 {out['p95_ms']:.1f} ms; {out['answered']} "
        f"answered, {out['sourceless']} without sources; batcher {batcher} (mean batch {out['mean_batch']:.2f}); "
        f"batched vs sequential over {compared['queries']} queries: max score diff {compared['max_score_diff']}, "
        f"{compared['swaps']} swaps, disagree {compared['disagree']}; launches {launches}; "
        f"peak {gib(out['peak_bytes'])}")
    for e in out["searches"]:
        log(f"  B1 searches at B={e['b']} (b_pad {e['b_pad']}) N={e['n']} k={e['k']} against fused_topk_plain: "
            f"{e['searches']}, max |err| {e['max_abs_err']:.3g}, index swaps {e['swaps']}")
    log("forwards at S >= 512 on the serving path, (B, S): "
        + str(sorted(Counter(tuple(m.shape) for _, m in forwards).items())))
    check(out["sourceless"] == 0, f"serving: {out['sourceless']} of {out['answered']} answers without sources")
    check(batcher["batches_run"] < batcher["requests_served"], f"serving: the batcher did not coalesce: {batcher}")
    check(compared["queries"] == serving.CHECK_QUERIES and not compared["disagree"],
          f"serving: batched answers differ from sequential ones: {compared}")
    check(launches["fused_topk"] > 0, "kernel fused_topk was not launched on the serving path")
    check(sum(cfg.num_layers for cfg, _ in forwards) == launches["blocked_attention"],
          f"serving: {len(forwards)} forwards at S >= 512 do not account for "
          f"{launches['blocked_attention']} B3 launches")
    return (out, launches, check_attention_on_path(torch, "serving", forwards),
            orchestrator, orch_launches, check_attention_on_path(torch, "orchestrator", orch_forwards))


def run_recall_path() -> tuple[dict, int]:
    """``scripts/measure_recall.py``'s ``run()``: B1 against the exact top-k
    over 1,000,000 x 1024 bf16 rows, k = 10 and 100. Returns (its numbers,
    B1's launches)."""
    from tensortruth_tpu_torch.ops.topk import fused_topk
    from tensortruth_tpu_torch.scripts import measure_recall

    fused_topk.launches = 0
    out = measure_recall.run(device="cuda")
    launches = fused_topk.launches
    check(launches == len(measure_recall.KS), f"recall: {launches} B1 launches, not {len(measure_recall.KS)}")
    for k in measure_recall.KS:
        got, want = out[f"recall@{k}"], out[f"predicted@{k}"]
        check(got >= want - RECALL_MARGIN, f"recall@{k} {got} < predicted {want} - {RECALL_MARGIN}")
    log(f"recall path: N={out['n']} D={out['d']} B={out['b']} c_out={out['c_out']}: " + ", ".join(
        f"recall@{k} {out[f'recall@{k}']:.5f} (predicted {out[f'predicted@{k}']:.5f})" for k in measure_recall.KS))
    return out, launches


# -- phase 10: the capacity path ------------------------------------------------

CAPACITY_QUESTIONS = [
    "How does the IVF tier pick the clusters it probes?",
    "What does an int8 corpus cost in recall against bfloat16?",
    "How are spilled rows placed when their best cluster is full?",
    "Which module answers questions about the chunk hierarchy?",
]


def drive_requests(torch, svc, questions) -> list[float]:
    """``retrieve()`` each question (synchronised); check reranked sources."""
    request_ms = []
    for text in questions:
        t = time.perf_counter()
        r = svc.retrieve(text)
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t) * 1e3)
        check(r.sources and all(0.0 <= s.score <= 1.0 for s in r.sources), f"no reranked sources for {text[:40]!r}")
        check(r.confidence in ("normal", "low"), f"confidence {r.confidence}")
    return request_ms


def corpus_rows(retriever, rows):
    """f32 vectors of stacked rows ``rows``, read from the loaded indexes
    (an array index: a sharded matrix then reads only those rows)."""
    import numpy as np

    out = np.empty((len(rows), retriever._stacked.shape[-1]), np.float32)
    mods = retriever._module_of_row[rows]
    for mi in np.unique(mods):
        sel = mods == mi
        matrix = retriever.indexes[retriever.modules[mi]].matrix()[0]
        out[sel] = matrix[retriever._row_map[rows[sel]].astype(np.int64)]
    return out


def check_self_retrieval(ivf, rows, vecs, nprobe: int, name: str) -> float:
    from tensortruth_tpu_torch.ops.ivf import ivf_search

    vals, got = ivf_search(ivf, vecs, 1, nprobe=nprobe)
    rate = float((got[:, 0] == rows).mean())
    check(rate >= MIN_SELF_RETRIEVAL, f"{name}: self-retrieval {rate} < {MIN_SELF_RETRIEVAL}")
    log(f"{name}: {len(rows)} corpus rows as queries come back at rank 0 for {rate:.4f} of them "
        f"(score {vals[:, 0].min():.4f}..{vals[:, 0].max():.4f})")
    return rate


def check_ivf_placement(torch, retriever, dtype, dim: int, name: str) -> None:
    import numpy as np

    ivf = retriever._ivf
    check(ivf is not None and retriever._stacked is ivf.blocks, f"{name}: the engine did not take the IVF tier")
    blocks = ivf.blocks
    shape = (retriever.ivf_clusters, ivf.rows_per_cluster, dim)
    check(blocks.is_cuda and blocks.dtype == dtype and tuple(blocks.shape) == shape,
          f"{name}: blocks {tuple(blocks.shape)} {blocks.dtype} on {blocks.device}")
    check((ivf.scales is not None) == (dtype == torch.int8), f"{name}: scales do not match the block dtype")
    placed = ivf.row_map[ivf.row_map >= 0]
    check(np.array_equal(np.sort(placed), np.arange(CAPACITY_ROWS)), f"{name}: rows not placed exactly once")
    nbytes = blocks.numel() * blocks.element_size()
    log(f"{name}: {ivf.n_clusters} clusters x {ivf.rows_per_cluster} rows, {blocks.dtype} blocks "
        f"{gib(nbytes)}, padding waste {100 * ivf.padding_waste:.2f}%; build seconds "
        + ", ".join(f"{k} {v:.2f}" for k, v in retriever.placement_seconds.items()))


def run_capacity_path(torch, work: Path) -> tuple[dict, dict]:
    """(a) int8 flat tier, (b) IVF over bf16 blocks, (c) IVF over int8 blocks,
    all at 2,097,152 rows x 1024. Returns the launches counted on each, and
    what the mesh path is held against: the single-device embedder, its
    embeddings of the 8 questions (f32, and bf16 on the card), their exact
    top-20 over the bf16 and the dequantised int8 corpus, and 32 corpus rows
    (ids and f32 vectors) for self-retrieval; and what the multislice path
    splits into groups: the IVF indexes of (b) and (c), still on the card,
    with their build seconds and nprobe."""
    import numpy as np

    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig
    from tensortruth_tpu_torch.index import VectorIndex
    from tensortruth_tpu_torch.models.manager import ModelManager, ModelSpec
    from tensortruth_tpu_torch.ops.ivf import group_probes, ivf_search, probe_scores
    from tensortruth_tpu_torch.ops.matmul import mm_f32
    from tensortruth_tpu_torch.ops.topk import exact_topk, fused_topk_int8
    from tensortruth_tpu_torch.retrieval.engine import MultiIndexEngine
    from tensortruth_tpu_torch.services.rag_service import RAGService

    model_dir = work / "indexes" / "bge-m3"
    docs_rows = VectorIndex.load(model_dir / "library_docs").n_rows
    embedder = ModelManager.get_instance().get_embedder(ModelSpec("BAAI/bge-m3"), device="cuda")
    t0 = time.perf_counter()
    synthetic_index(torch, CAPACITY_ROWS - docs_rows, embedder.dim).save(model_dir / "capacity")
    log(f"capacity index: docs {docs_rows} + {CAPACITY_ROWS - docs_rows} synthetic leaves = {CAPACITY_ROWS} "
        f"rows, built and written in {time.perf_counter() - t0:.1f} s")
    svc = RAGService(config=TensorTruthTPUConfig.default(), llm_factory=lambda params: StubLLM())
    load = dict(indexes_dir=work / "indexes", device="cuda")
    launches = {}

    # (a) the int8 flat tier: kernel B2
    t0 = time.perf_counter()
    engine = svc.load_engine(["docs", "capacity"], {"reranker_top_n": 5, "corpus_dtype": "int8"}, **load)
    r = engine.retriever
    log(f"(a) int8 flat tier: loaded in {time.perf_counter() - t0:.1f} s; "
        + ", ".join(f"{k} {v:.2f} s" for k, v in r.placement_seconds.items()))
    stacked, scales = r._stacked, r._stacked_scales
    check(stacked.is_cuda and stacked.dtype == torch.int8 and tuple(stacked.shape) == (CAPACITY_ROWS, embedder.dim)
          and scales is not None and scales.is_cuda and scales.dtype == torch.float32 and r._ivf is None,
          f"(a) corpus {tuple(stacked.shape)} {stacked.dtype} on {stacked.device}")
    check(engine.pipeline is None, "(a) the fused query step is on for an int8 corpus")
    log(f"(a) corpus {gib(stacked.numel() + scales.numel() * 4)} on the card, "
        f"{gib(torch.cuda.memory_allocated())} allocated in all")
    torch.cuda.synchronize()
    fused_topk_int8.launches = 0
    request_ms = drive_requests(torch, svc, CAPACITY_QUESTIONS)
    launches["fused_topk_int8"] = fused_topk_int8.launches
    check(launches["fused_topk_int8"] > 0, "(a) kernel fused_topk_int8 was not launched on the int8 tier")
    log("(a) request ms: " + ", ".join(f"{ms:.1f}" for ms in request_ms)
        + f"; launches {launches['fused_topk_int8']}")

    q_f32 = embedder.encode(CAPACITY_QUESTIONS * 2, is_query=True)
    q = torch.from_numpy(q_f32).to("cuda", torch.bfloat16)
    _, got = fused_topk_int8(q, stacked, scales, 20, n_actual=CAPACITY_ROWS)
    deq = mm_f32(q, stacked.to(torch.bfloat16).t()) * scales  # B2's own scores, exactly
    _, exact = torch.sort(deq, dim=1, descending=True, stable=True)
    del deq
    exact_int8 = exact[:, :20]
    bf16 = torch.empty((CAPACITY_ROWS, embedder.dim), dtype=torch.bfloat16, device="cuda")
    row = 0
    for mod in r.modules:
        for piece in r.indexes[mod].iter_matrix_pieces():
            bf16[row : row + len(piece)] = torch.from_numpy(np.asarray(piece, np.float32))
            row += len(piece)
    _, exact_bf16 = exact_topk(q, bf16, 20)
    del bf16
    torch.cuda.empty_cache()

    def recall(a, b):
        return sum(len(set(x.tolist()) & set(y.tolist())) for x, y in zip(a.cpu(), b.cpu())) / b.numel()

    rec = recall(got, exact_int8)
    check(rec >= MIN_RECALL, f"(a) B2 top-20 recall {rec} < {MIN_RECALL} against its own exact scores")
    log(f"(a) B2 top-20 recall: {rec:.4f} against the exact top-20 over the dequantised corpus, "
        f"{recall(got, exact_bf16):.4f} against the exact top-20 over the bf16 corpus (not asserted)")
    svc.clear_engines()
    del engine, r, stacked, scales
    torch.cuda.empty_cache()

    # (b) the IVF tier over bf16 blocks: kernel B4
    t0 = time.perf_counter()
    engine = svc.load_engine(["docs", "capacity"], {"reranker_top_n": 5}, **load)
    r = engine.retriever
    ivf_build_s = {"bfloat16": time.perf_counter() - t0}
    log(f"(b) IVF tier (bf16 blocks): loaded in {ivf_build_s['bfloat16']:.1f} s")
    check_ivf_placement(torch, r, torch.bfloat16, embedder.dim, "(b)")
    check(engine.pipeline is None, "(b) the fused query step is on for the IVF tier")
    log(f"(b) {gib(torch.cuda.memory_allocated())} allocated on the card")
    torch.cuda.synchronize()
    probe_scores.launches = 0
    request_ms = drive_requests(torch, svc, CAPACITY_QUESTIONS)
    launches["ivf_probe"] = probe_scores.launches
    check(launches["ivf_probe"] > 0, "(b) kernel ivf_probe was not launched on the IVF tier")
    log("(b) request ms: " + ", ".join(f"{ms:.1f}" for ms in request_ms) + f"; launches {launches['ivf_probe']}")
    # 32 rows of the synthetic module as queries (the docs rows, embedded
    # by a random-weight model, lie close together and may outrank each other)
    synthetic = np.flatnonzero(r._module_of_row == r.modules.index("capacity"))
    rows = np.random.default_rng(SEED).choice(synthetic, 32, replace=False)
    vecs = corpus_rows(r, rows)
    check_self_retrieval(r._ivf, rows, vecs, r.ivf_nprobe, "(b)")
    _, ivf_rows = ivf_search(r._ivf, q, 20, nprobe=r.ivf_nprobe)
    log(f"(b) IVF top-20 recall against the exact bf16 top-20: "
        f"{recall(torch.from_numpy(ivf_rows), exact_bf16):.4f} (not asserted: over random rows it would be "
        f"about nprobe/clusters; these queries' top rows are docs rows, which the random-weight encoder "
        f"puts close together)")
    indexes, ivf_bf16 = r.indexes, r._ivf
    svc.clear_engines()
    del engine, r
    torch.cuda.empty_cache()

    # (c) the IVF tier over int8 blocks: kernel B4's int8 variant
    t0 = time.perf_counter()
    r = MultiIndexEngine(indexes, corpus_dtype="int8", ivf_threshold=1_048_576, device="cuda")
    ivf_build_s["int8"] = time.perf_counter() - t0
    log(f"(c) IVF tier (int8 blocks): built in {ivf_build_s['int8']:.1f} s")
    check_ivf_placement(torch, r, torch.int8, embedder.dim, "(c)")
    log(f"(c) {gib(torch.cuda.memory_allocated())} allocated on the card")
    torch.cuda.synchronize()
    probe_scores.launches_int8 = group_probes.launches = 0
    t = time.perf_counter()
    results = r.retrieve_batch(vecs)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t) * 1e3
    launches["ivf_probe_int8"] = probe_scores.launches_int8
    launches["ivf_group_probes"] = group_probes.launches
    for name in ("ivf_probe_int8", "ivf_group_probes"):
        check(launches[name] > 0, f"(c) kernel {name} was not launched on the IVF tier")
    check(len(results) == 32 and all(results), "(c) a query of the batch got no nodes")
    log(f"(c) retrieve_batch of 32 queries: {batch_ms:.1f} ms; launches {launches['ivf_probe_int8']} "
        f"(grouping {launches['ivf_group_probes']})")
    check_self_retrieval(r._ivf, rows, vecs, r.ivf_nprobe, "(c)")
    reference = {"embedder": embedder, "q_f32": q_f32, "q": q, "exact_bf16": exact_bf16, "exact_int8": exact_int8.clone(),
                 "rows": rows, "vecs": vecs, "indexes": indexes, "nprobe": r.ivf_nprobe,
                 "ivf": {"bfloat16": ivf_bf16, "int8": r._ivf}, "ivf_build_s": ivf_build_s}
    return launches, reference


# -- phase 11: the mesh path --------------------------------------------------

# Every slot of the mesh sits on the one card: the shards run one after
# another, so no number of this phase is a multi-GPU figure.
MESH = {"n_shards": 4, "n_data": 2}
# The DP query embeddings (each forward split into 8 slices of the batch)
# against the single-device embedder's: the same bf16 model, whose GEMMs may
# sum in another order at another batch size; unit-norm f32 outputs whose
# components are about 0.03, so this is a few bf16 steps of one component.
DP_EMBED_TOL = 1e-3
MIN_DP_COSINE = 0.999
WORKER_TIMEOUT_S = 300


def recall_of(got, want) -> float:
    """Share of ``want``'s ids (rows of (B, k)) that ``got`` holds too."""
    return sum(len(set(x.tolist()) & set(y.tolist())) for x, y in zip(got, want)) / want.numel()


def check_rows_agree(name: str, got, want) -> tuple[float, int]:
    """(scores, row ids) of a sharded IVF search against its plain twin, as
    :func:`check_topk_agrees` holds the flat tiers."""
    import numpy as np

    (vals, rows), (pvals, prows) = got, want
    finite = np.isfinite(pvals)
    check(np.array_equal(finite, np.isfinite(vals)), f"{name}: -inf slots differ")
    diff = np.abs(np.where(finite, vals - pvals, 0.0))
    bad = int(((rows != prows) & (diff > PROBE_TOL)).sum())
    check(diff.max() <= PROBE_TOL and bad == 0, f"{name}: max |err| {diff.max()}, {bad} row mismatches")
    return float(diff.max()), int((rows != prows).sum())


def corpus_pieces(retriever):
    """The engine's stack as row-contiguous f32 pieces, in order."""
    for mod in retriever.modules:
        yield from retriever.indexes[mod].iter_matrix_pieces()


def flat_shard_shapes(corpus, n_actual: int, b: int) -> list[dict]:
    """What each shard of a flat sharded corpus gives B1 / B2 for a batch of
    ``b`` queries."""
    return [{"shard": s, "q": [b, corpus.shape[1]], "rows": [corpus.per_shard, corpus.shape[1]],
             "n_valid": int(min(max(n_actual - s * corpus.per_shard, 0), corpus.per_shard)),
             "devices": [str(d) for d in by_dev]} for s, by_dev in sorted(corpus.parts.items())]


def run_flat_mesh_tier(torch, svc, load, mesh, ref, dtype: str) -> dict:
    """(a) bf16 / (b) int8: the flat tier sharded over ``mesh`` through
    ``load_engine``, 4 ``retrieve()`` requests (DP embed -> B1 / B2 per shard
    -> DP rerank), then its sharded search of the 8 questions against the
    same sharding through the plain version and against the exact top-20."""
    from tensortruth_tpu_torch.ops.topk import fused_topk, fused_topk_int8
    from tensortruth_tpu_torch.parallel.sharded_topk import ShardedCorpus, shard_corpus_streaming, sharded_topk

    name, kernel = ("(a)", fused_topk) if dtype == "bfloat16" else ("(b)", fused_topk_int8)
    params = {"reranker_top_n": 5} | ({"corpus_dtype": "int8"} if dtype == "int8" else {})
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = svc.load_engine(["docs", "capacity"], params, mesh=mesh, **load)
    load_s = time.perf_counter() - t0
    r = engine.retriever
    corpus = r._stacked
    want_dtype = torch.int8 if dtype == "int8" else torch.bfloat16
    check(isinstance(corpus, ShardedCorpus) and corpus.dtype == want_dtype and corpus.shape == (CAPACITY_ROWS, 1024)
          and (corpus.scales is not None) == (dtype == "int8"), f"{name} corpus {corpus!r:.200}")
    check(all(list(by_dev) == [torch.device("cuda", 0)] for by_dev in corpus.parts.values())
          and len(corpus.parts) == MESH["n_shards"], f"{name}: not one buffer per shard on the card")
    row_bytes = CAPACITY_ROWS * 1024 * corpus.dtype.itemsize + (CAPACITY_ROWS * 4 if dtype == "int8" else 0)
    check(corpus.nbytes() == row_bytes, f"{name}: {corpus.nbytes()} corpus bytes, one copy is {row_bytes}")
    check(engine.embedder.mesh is mesh and engine.reranker.mesh is mesh and engine.pipeline is None,
          f"{name}: the models are not on the mesh, or the fused query step is on")
    log(f"{name} {dtype} flat tier on the {MESH['n_data']} x {MESH['n_shards']} mesh: loaded in {load_s:.1f} s "
        f"(shard {r.placement_seconds['shard']:.2f} s); corpus {gib(corpus.nbytes())}, "
        f"{gib(torch.cuda.memory_allocated() - before)} more allocated")
    torch.cuda.synchronize()
    kernel.launches = 0
    request_ms = drive_requests(torch, svc, CAPACITY_QUESTIONS)
    launches = kernel.launches
    check(launches == MESH["n_shards"] * len(CAPACITY_QUESTIONS),
          f"{name}: {launches} launches of {kernel.__name__}, wanted one per shard per request")
    log(f"{name} request ms: " + ", ".join(f"{ms:.1f}" for ms in request_ms) + f"; launches {launches}")

    q = ref["q"]
    kw = dict(k=20, n_actual=CAPACITY_ROWS, use_fused=True)
    got = sharded_topk(q, corpus, **kw)
    err, swaps = check_topk_agrees(f"{name} sharded {kernel.__name__}", got, sharded_topk(q, corpus, plain=True, **kw))
    exact = ref["exact_int8"] if dtype == "int8" else ref["exact_bf16"]
    rec = recall_of(got[1].cpu(), exact.cpu())
    check(rec >= MIN_RECALL, f"{name}: sharded top-20 recall {rec} < {MIN_RECALL} against the exact top-20")
    ms, plain_ms = in_turns(torch, lambda: sharded_topk(q, corpus, **kw), lambda: sharded_topk(q, corpus, plain=True, **kw))
    # The same search with the host ahead of the card, and one shard's launch
    # alone beside its bound: what the search costs beyond its launches.
    queued = queued_ms(torch, lambda: sharded_topk(q, corpus, **kw))
    rows, scales = corpus.parts[0][mesh.lead], corpus.scales[0][mesh.lead] if dtype == "int8" else None
    shard_ms = cuda_ms(torch, lambda: kernel(q, rows, scales, 20) if scales is not None else kernel(q, rows, 20))
    shard_bound = bound(nbytes(q, rows) + (nbytes(scales) if scales is not None else 0), 2 * q.numel() * rows.shape[0],
                        "int8" if dtype == "int8" else "bf16")
    log(f"{name} sharded search of 8 queries: {ms:.4f} ms device ({queued:.4f} ms queued behind a sleep; "
        f"{MESH['n_shards']} launches, one after another; one shard's launch {shard_ms:.4f} ms, bound "
        f"{shard_bound['bound_ms']:.4f} ms), plain {plain_ms:.4f} ms; max |err| {err:.2e} ({swaps} index swaps "
        f"within tolerance); recall {rec:.4f} against the exact top-20")
    out = {"load_s": load_s, "placement_s": r.placement_seconds, "device_bytes": corpus.nbytes(),
           "request_ms": request_ms, "launches": launches, "search_ms": ms, "search_queued_ms": queued,
           "plain_ms": plain_ms, "shard_ms": shard_ms, "shard_bound": shard_bound, "max_abs_err": err,
           "recall": rec, "shards": flat_shard_shapes(corpus, CAPACITY_ROWS, 1), "ids": got[1].cpu(),
           "scores": got[0].cpu()}
    if dtype == "bfloat16":
        # The placement alone: the 2 x 4 mesh holds each row shard once.
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        again, _ = shard_corpus_streaming(corpus_pieces(r), CAPACITY_ROWS, corpus.shape[1], mesh, torch.bfloat16, 2048)
        grew = torch.cuda.memory_allocated() - before
        check(grew == corpus.nbytes(), f"{name}: placing the rows again allocated {grew} bytes, not one copy")
        del again
        out["placement_allocated"] = grew
        # the DP query embeddings against the single-device embedder's
        dp = engine.embedder.encode(CAPACITY_QUESTIONS * 2, is_query=True)
        diff = float(abs(dp - ref["q_f32"]).max())
        cos = float((dp * ref["q_f32"]).sum(axis=1).min())
        check(diff <= DP_EMBED_TOL and cos >= MIN_DP_COSINE, f"{name}: DP embeddings off by {diff}, cosine {cos}")
        log(f"{name} DP query embeddings (8 slices of each batch) against the single-device embedder: "
            f"max |diff| {diff:.2e}, least cosine {cos:.6f}")
        out["dp_embed"] = {"max_abs_diff": diff, "min_cosine": cos}
    svc.clear_engines()
    return out


def run_ivf_mesh_tier(torch, mesh, ref, dtype: str) -> dict:
    """(c) a ``MultiIndexEngine`` on the mesh with ``ivf_threshold`` lowered
    so that the cluster-sharded IVF builds: one 32-query batch (B4, over int8
    blocks with its grouping, on each shard's own clusters), then the
    sharded search against the plain probe of every shard, and
    self-retrieval."""
    import numpy as np

    from tensortruth_tpu_torch.ops.ivf import ShardedIVF, group_probes, ivf_search_sharded, probe_scores
    from tensortruth_tpu_torch.retrieval.engine import MultiIndexEngine

    name = f"(c) {dtype}"
    int8 = dtype == "int8"
    t0 = time.perf_counter()
    r = MultiIndexEngine(ref["indexes"], mesh=mesh, corpus_dtype=dtype, ivf_threshold=262_144)
    build_s = time.perf_counter() - t0
    sidx = r._ivf_sharded
    check(isinstance(sidx, ShardedIVF) and r._stacked is sidx and sidx.quantized == int8
          and sidx.cpl == r.ivf_clusters // MESH["n_shards"], f"{name}: the engine did not take the sharded IVF tier")
    placed = sidx.row_map[sidx.row_map >= 0]
    check(np.array_equal(np.sort(placed), np.arange(CAPACITY_ROWS)), f"{name}: rows not placed exactly once")
    log(f"{name} sharded IVF: built in {build_s:.1f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in r.placement_seconds.items())
        + f"); {MESH['n_shards']} shards x {sidx.cpl} clusters x {sidx.rows_per_cluster} rows, {gib(sidx.nbytes())}")
    torch.cuda.synchronize()
    probe_scores.launches = probe_scores.launches_int8 = group_probes.launches = 0
    t = time.perf_counter()
    results = r.retrieve_batch(ref["vecs"])
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t) * 1e3
    launches = ({"ivf_probe_int8": probe_scores.launches_int8, "ivf_group_probes": group_probes.launches} if int8
                else {"ivf_probe": probe_scores.launches})
    check(all(n == MESH["n_shards"] for n in launches.values()), f"{name}: launches {launches}, wanted one per shard")
    check(len(results) == 32 and all(results), f"{name}: a query of the batch got no nodes")
    nprobe = r.ivf_nprobe
    got = ivf_search_sharded(sidx, ref["vecs"], 20, nprobe=nprobe)
    err, swaps = check_rows_agree(name, got, ivf_search_sharded(sidx, ref["vecs"], 20, nprobe=nprobe, plain=True))
    rate = float((ivf_search_sharded(sidx, ref["vecs"], 1, nprobe=nprobe)[1][:, 0] == ref["rows"]).mean())
    check(rate >= MIN_SELF_RETRIEVAL, f"{name}: self-retrieval {rate} < {MIN_SELF_RETRIEVAL}")
    log(f"{name} retrieve_batch of 32 queries: {batch_ms:.1f} ms; launches {launches}; against the plain probe: "
        f"max |err| {err:.2e} ({swaps} row swaps within tolerance); self-retrieval {rate:.4f}")
    shards = [{"shard": s, "probe": [32, min(nprobe, sidx.cpl)], "centroids": list(arrays[0].shape),
               "blocks": list(arrays[1].shape), "dtype": str(arrays[1].dtype)}
              for s, by_dev in sorted(sidx.parts.items()) for arrays in by_dev.values()]
    out = {"build_s": build_s, "placement_s": r.placement_seconds, "device_bytes": sidx.nbytes(), "batch_ms": batch_ms,
           "launches": launches, "max_abs_err": err, "self_retrieval": rate, "shards": shards}
    del r, sidx
    torch.cuda.empty_cache()
    return out


def run_config_mesh(torch, work: Path) -> dict:
    """(d) ``rag.mesh.enabled`` with the default shape through
    ``RAGService.load_engine``: a 1 x 1 mesh on the card over the main
    path's 262,144-row corpus, 2 requests, and its sharded search against
    the plain version."""
    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig
    from tensortruth_tpu_torch.ops.topk import fused_topk
    from tensortruth_tpu_torch.parallel.sharded_topk import sharded_topk
    from tensortruth_tpu_torch.services.rag_service import RAGService

    cfg = TensorTruthTPUConfig.default()
    cfg.rag.mesh = {"enabled": True, "n_data": 1, "n_shards": 0}
    svc = RAGService(config=cfg, llm_factory=lambda params: StubLLM())
    t0 = time.perf_counter()
    engine = svc.load_engine(["docs", "synthetic"], {"reranker_top_n": 5}, indexes_dir=work / "indexes")
    load_s = time.perf_counter() - t0
    r = engine.retriever
    check(r.mesh is not None and r.mesh.shape == {"data": 1, "shards": 1} and r.mesh.lead == torch.device("cuda", 0)
          and r._stacked.shape == (CORPUS_ROWS, 1024), f"(d) mesh {r.mesh}, corpus {getattr(r._stacked, 'shape', None)}")
    torch.cuda.synchronize()
    fused_topk.launches = 0
    request_ms = drive_requests(torch, svc, CAPACITY_QUESTIONS[:2])
    launches = fused_topk.launches
    check(launches == 2, f"(d) {launches} launches of fused_topk, wanted 2")
    q = torch.from_numpy(engine.embedder.encode(CAPACITY_QUESTIONS[:2], is_query=True)).to("cuda", torch.bfloat16)
    kw = dict(k=20, n_actual=CORPUS_ROWS, use_fused=True)
    err, _ = check_topk_agrees("(d) sharded fused_topk", sharded_topk(q, r._stacked, **kw),
                               sharded_topk(q, r._stacked, plain=True, **kw))
    log(f"(d) rag.mesh.enabled, default shape: {r.mesh}; loaded in {load_s:.1f} s; request ms "
        + ", ".join(f"{ms:.1f}" for ms in request_ms) + f"; launches {launches}; max |err| {err:.2e}")
    svc.clear_engines()
    return {"load_s": load_s, "request_ms": request_ms, "launches": launches, "max_abs_err": err,
            "shards": flat_shard_shapes(r._stacked, CORPUS_ROWS, 1)}


def run_global_mesh(torch, work: Path, flat: dict, q_f32) -> dict:
    """(e) two processes on the card form a gloo world of 2, each with a
    local mesh of 2 shards (4 in all, the (a) / (b) sharding): each reads
    and places only its half of the rows through ``GlobalMeshSearch``, bf16
    then int8, and the last rank serves the 8 questions. Both ranks must
    return the same ids and scores as each other and as the single-process
    sharded searches of (a) and (b)."""
    import numpy as np

    from tensortruth_tpu_torch.scripts.global_mesh_worker import run_world

    world_dir = work / "mesh_world"
    world_dir.mkdir()
    np.save(world_dir / "q.npy", q_f32)
    model_dir = work / "indexes" / "bge-m3"
    args = ["--backend", "gloo", "--device", "cuda:0", "--local-shards", "2", "--index", str(model_dir / "library_docs"),
            "--index", str(model_dir / "capacity"), "--queries", str(world_dir / "q.npy"), "--k", "20",
            "--dtype", "bfloat16", "--fused", "--timeout", str(WORKER_TIMEOUT_S / 4)]
    t0 = time.perf_counter()
    # a worker prints its stacks and exits after 4 x its --timeout
    reports = run_world([args, args], world_dir, timeout=WORKER_TIMEOUT_S + 30)
    wall_s = time.perf_counter() - t0
    for dtype, key in (("bfloat16", "a"), ("int8", "b")):
        ids, scores = (np.asarray(reports[1]["searches"][dtype][f]) for f in ("ids", "scores"))
        check(all(rep["searches"][dtype] == reports[1]["searches"][dtype] for rep in reports),
              f"(e) {dtype}: the two ranks disagree")
        check(np.array_equal(ids, flat[key]["ids"].numpy()) and np.array_equal(scores, flat[key]["scores"].numpy()),
              f"(e) {dtype}: the global mesh's top-20 differs from the single-process sharded search")
    check([rep["row_range"] for rep in reports] == [[0, CAPACITY_ROWS // 2, CAPACITY_ROWS],
                                                    [CAPACITY_ROWS // 2, CAPACITY_ROWS, CAPACITY_ROWS]],
          f"(e) row ranges {[rep['row_range'] for rep in reports]}")
    for rep in reports:
        check(rep["launches"]["fused_topk"] == 2 and rep["launches"]["fused_topk_int8"] == 2,
              f"(e) rank {rep['rank']} launches {rep['launches']}, wanted 2 per search")
    log(f"(e) gloo world of 2 on the card: {wall_s:.1f} s wall; per rank seconds "
        + "; ".join(f"{rep['rank']}: " + ", ".join(f"{k} {v:.2f}" for k, v in rep["seconds"].items()) for rep in reports)
        + "; both ranks return (a)'s and (b)'s top-20 exactly")
    return {"wall_s": wall_s, "seconds": [rep["seconds"] for rep in reports], "launches": [rep["launches"] for rep in reports],
            "row_ranges": [rep["row_range"] for rep in reports]}


def run_mesh_path(torch, work: Path, ref: dict) -> tuple[dict, dict]:
    """(a)-(e) over the capacity path's 2,097,152-row indexes, at BGE-M3 /
    bge-reranker-v2-m3 width. Returns the phase's numbers and the launches
    counted while (a)-(d) were driven."""
    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig
    from tensortruth_tpu_torch.parallel import make_mesh
    from tensortruth_tpu_torch.services.rag_service import RAGService

    mesh = make_mesh(**MESH, devices=[torch.device("cuda", 0)] * (MESH["n_shards"] * MESH["n_data"]))
    svc = RAGService(config=TensorTruthTPUConfig.default(), llm_factory=lambda params: StubLLM())
    load = dict(indexes_dir=work / "indexes")
    flat = {"a": run_flat_mesh_tier(torch, svc, load, mesh, ref, "bfloat16"),
            "b": run_flat_mesh_tier(torch, svc, load, mesh, ref, "int8")}
    torch.cuda.empty_cache()
    ivf = {dtype: run_ivf_mesh_tier(torch, mesh, ref, dtype) for dtype in ("bfloat16", "int8")}
    config = run_config_mesh(torch, work)
    torch.cuda.empty_cache()
    workers = run_global_mesh(torch, work, flat, ref["q_f32"])
    launches = {"fused_topk": flat["a"]["launches"] + config["launches"], "fused_topk_int8": flat["b"]["launches"],
                **ivf["bfloat16"]["launches"], **ivf["int8"]["launches"]}
    for part in flat.values():
        del part["ids"], part["scores"]
    return {"mesh": str(mesh), "flat": flat, "ivf": ivf, "config": config, "global": workers}, launches


# -- phase 12: the multislice path --------------------------------------------

# The capacity path's IVF indexes (1024 clusters x 3072 rows x 1024, bf16 and
# int8) split into cluster groups routed by the host; groups 2 and 3 are
# served by worker processes on the same card.
MULTISLICE_GROUPS = 4
MULTISLICE_REMOTE = (2, 3)
MULTISLICE_MESH = {"n_shards": 2, "n_data": 1}  # (d): 2 groups, each on a 1 x 2 mesh
MULTISLICE_K = 20
# Remote against in-process scores: the reference's cross-process tolerance
# (tests/unit/test_transport.py); the ids must be equal.
REMOTE_RTOL, REMOTE_ATOL = 1e-4, 1e-5


def route_shapes(ms, q, nprobe: int) -> list[dict]:
    """What the coordinator sends each group for ``q``: the queries routed to
    it and its ``nprobe_g`` (0 and 0 for a group it skips)."""
    probe_groups = ms.route(q, nprobe)
    out = []
    for g in range(len(ms.groups)):
        hits = probe_groups == g
        out.append({"group": g, "queries": int(hits.any(axis=1).sum()), "nprobe": int(hits.sum(axis=1).max())})
    return out


def group_rows(ivf, ms) -> list[dict]:
    """Each group's cluster range, its rows and the block shape its B4 reads."""
    lo = [g.cluster_lo for g in ms.groups] + [ivf.n_clusters]
    return [{"group": g, "clusters": [lo[g], lo[g + 1]], "rows": int((ivf.row_map[lo[g] : lo[g + 1]] >= 0).sum()),
             "blocks": [lo[g + 1] - lo[g], *ivf.blocks.shape[1:]], "dtype": str(ivf.blocks.dtype).removeprefix("torch.")}
            for g in range(len(ms.groups))]


def timed_search(torch, ms, q, nprobe: int, repeats: int = 3) -> tuple[tuple, list[float], dict]:
    """The routed search, its launches counted from 0 before the first call;
    returns (the first call's result, host ms of each call, synchronised,
    and host ms of each touched group's transport call in each search: its
    whole search, the copy back and, for a worker, the round trip)."""
    from tensortruth_tpu_torch.ops.ivf import group_probes, probe_scores

    group_ms = {}

    def timed(g, search):
        def call(*args, **kw):
            t0 = time.perf_counter()
            result = search(*args, **kw)
            group_ms.setdefault(g, []).append((time.perf_counter() - t0) * 1e3)
            return result

        return call

    for g, t in enumerate(ms.transports):
        t.search = timed(g, t.search)
    torch.cuda.synchronize()
    probe_scores.launches = probe_scores.launches_int8 = group_probes.launches = 0
    times, first = [], None
    try:
        for _ in range(repeats):
            t = time.perf_counter()
            got = ms.search(q, MULTISLICE_K, nprobe=nprobe)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            first = first or got
            check(ms.last_failed_groups == [], f"multislice: groups {ms.last_failed_groups} failed")
    finally:
        for t in ms.transports:
            del t.search
    return first, times, group_ms


def group_medians(group_ms: dict) -> str:
    return ", ".join(f"group {g} {statistics.median(v):.1f}" for g, v in sorted(group_ms.items()))


def b4_launches(dtype: str) -> dict:
    from tensortruth_tpu_torch.ops.ivf import group_probes, probe_scores

    if dtype == "int8":
        return {"ivf_probe_int8": probe_scores.launches_int8, "ivf_group_probes": group_probes.launches}
    return {"ivf_probe": probe_scores.launches}


def start_workers(ms, dtype: str, part_dir: Path, transports: list) -> dict:
    """(b) / (c): write the remote groups' parts, start a supervised worker on
    the card for each (all at once), attach them and drop the local copies.
    Every transport started is appended to ``transports``."""
    from tensortruth_tpu_torch.parallel.transport import SupervisedTransport

    paths = {g: part_dir / f"{dtype}_group{g}.npz" for g in MULTISLICE_REMOTE}
    t0 = time.perf_counter()
    for g, path in paths.items():
        ms.save_part(g, path)
    write_s = time.perf_counter() - t0

    def start(g):
        return SupervisedTransport(paths[g], cluster_lo=ms.groups[g].cluster_lo, startup_timeout=WORKER_TIMEOUT_S,
                                   device="cuda:0", log_path=part_dir / f"{dtype}_worker{g}.log")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(paths)) as pool:
        futures = {g: pool.submit(start, g) for g in paths}
    errors = []
    for g, fut in futures.items():
        try:
            transports.append(fut.result())
            ms.attach_transport(g, transports[-1])
        except Exception as e:  # every started worker is in ``transports`` before this raises
            errors.append(f"group {g}: {e}")
    check(not errors, f"multislice {dtype}: workers did not start: {errors}; logs "
          + "; ".join((part_dir / f"{dtype}_worker{g}.log").read_text()[-2000:] for g in paths
                      if (part_dir / f"{dtype}_worker{g}.log").exists()))
    start_s = time.perf_counter() - t0
    check(all(ms.groups[g].index is None for g in paths), f"multislice {dtype}: a remote group kept its local copy")
    load_s = {}
    for g in paths:
        found = re.findall(r"in ([0-9.]+) s$", (part_dir / f"{dtype}_worker{g}.log").read_text(), re.M)
        load_s[g] = float(found[-1]) if found else None
    return {"part_bytes": {g: p.stat().st_size for g, p in paths.items()}, "part_write_s": write_s,
            "worker_start_s": start_s, "worker_load_s": load_s, "paths": paths}


def run_multislice_dtype(torch, ivf, dtype: str, q, ref, part_dir: Path, transports: list) -> dict:
    """(a) the 4 groups in process, held against the plain probe, by
    self-retrieval and beside the single-device search; (b) / (c) groups 2
    and 3 in worker processes on the card: the same ids as (a)."""
    import numpy as np

    from tensortruth_tpu_torch.ops.ivf import ivf_search
    from tensortruth_tpu_torch.parallel.multislice import MultiSliceIVF

    name = f"multislice {dtype}"
    nprobe, n_self = ref["nprobe"], len(ref["rows"])
    ms = MultiSliceIVF(ivf, MULTISLICE_GROUPS)
    base = ivf.blocks.untyped_storage().data_ptr()
    check(all(g.index.blocks.untyped_storage().data_ptr() == base for g in ms.groups),
          f"{name}: a group's blocks are not a view of the index")
    t = time.perf_counter()
    shapes = route_shapes(ms, q, nprobe)
    route_ms = (time.perf_counter() - t) * 1e3
    touched = [s["group"] for s in shapes if s["queries"]]

    # (a) in process
    got, times, group_ms = timed_search(torch, ms, q, nprobe)
    launches = b4_launches(dtype)
    check(ms.last_touched_groups == touched and all(n == len(touched) * 3 for n in launches.values()),
          f"{name} (a): launches {launches} over 3 searches, groups touched {ms.last_touched_groups} (routing {touched})")
    err, swaps = check_rows_agree(f"{name} (a)", got, ms.search(q, MULTISLICE_K, nprobe=nprobe, plain=True))
    rate = float((got[1][:n_self, 0] == ref["rows"]).mean())
    check(rate >= MIN_SELF_RETRIEVAL, f"{name} (a): self-retrieval {rate} < {MIN_SELF_RETRIEVAL}")
    single = ivf_search(ivf, q, MULTISLICE_K, nprobe=nprobe)  # also its warm-up
    overlap = recall_of(torch.from_numpy(got[1]), torch.from_numpy(single[1]))
    single_ms = []  # timed as often as the routed batch
    for _ in times:
        torch.cuda.synchronize()
        t = time.perf_counter()
        ivf_search(ivf, q, MULTISLICE_K, nprobe=nprobe)
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t) * 1e3)
    ratio = statistics.median(times) / statistics.median(single_ms)
    groups = group_rows(ivf, ms)
    for g, s in zip(groups, shapes):
        g.update(queries=s["queries"], nprobe=s["nprobe"])
    log(f"{name} (a): {MULTISLICE_GROUPS} groups in process, rows "
        + ", ".join(f"{g['rows']} in clusters {g['clusters'][0]}..{g['clusters'][1]}" for g in groups)
        + f"; routing {route_ms:.3f} ms (host, f32), batch of {len(q)} ms " + ", ".join(f"{x:.1f}" for x in times)
        + " (single-device search ms " + ", ".join(f"{x:.1f}" for x in single_ms)
        + f"; ratio of the medians {ratio:.2f}; median ms of each group's call in the batch: "
        + group_medians(group_ms) + f"); launches {launches} over 3 batches; against the plain "
        f"probe max |err| {err:.2e} ({swaps} row swaps within tolerance); self-retrieval {rate:.4f}; top-20 overlap "
        f"with the single-device search {overlap:.4f}")
    out = {"route_ms": route_ms, "batch_ms": times, "single_device_ms": single_ms, "median_ratio": ratio,
           "group_ms": {str(g): v for g, v in group_ms.items()}, "groups": groups,
           "launches": launches, "max_abs_err": err, "row_swaps": swaps,
           "self_retrieval": rate, "overlap_single_device": overlap}

    # (b) / (c): groups 2 and 3 through worker processes
    started = start_workers(ms, dtype, part_dir, transports)
    sup = transports[-len(MULTISLICE_REMOTE):]
    remote, times, group_ms = timed_search(torch, ms, q, nprobe)
    launches = b4_launches(dtype)
    local_touched = [g for g in touched if g not in MULTISLICE_REMOTE]
    check(all(n == len(local_touched) * 3 for n in launches.values()),
          f"{name} (remote): coordinator launches {launches}, wanted {len(local_touched)} per batch")
    check(all(st.respawn_count == 0 for st in sup), f"{name}: a worker respawned")
    check(np.array_equal(remote[1], got[1]), f"{name}: remote ids differ from the in-process ids")
    np.testing.assert_allclose(remote[0], got[0], rtol=REMOTE_RTOL, atol=REMOTE_ATOL)
    bit_equal = bool(np.array_equal(remote[0], got[0]))
    owner = np.full(ivf.n_actual, -1, np.int64)
    for g in groups:
        rows = ivf.row_map[g["clusters"][0] : g["clusters"][1]]
        owner[rows[rows >= 0]] = g["group"]
    from_remote = int(np.isin(owner[remote[1][remote[1] >= 0]], MULTISLICE_REMOTE).sum())
    check(from_remote > 0, f"{name}: no returned row came from a worker's clusters")
    held = sum(t.numel() * t.element_size() for g in ms.groups if g.index is not None
               for t in (g.index.blocks, g.index.valid, g.index.scales) if t is not None)
    log(f"{name} (remote): groups {list(MULTISLICE_REMOTE)} in worker processes on the card: parts "
        + ", ".join(f"{gib(n)}" for n in started["part_bytes"].values())
        + f" written in {started['part_write_s']:.1f} s; workers up in {started['worker_start_s']:.1f} s (loads "
        + ", ".join(f"{s} s" for s in started["worker_load_s"].values()) + "); batch ms "
        + ", ".join(f"{x:.1f}" for x in times) + " (median ms of each group's call: " + group_medians(group_ms)
        + f"); ids equal to (a), scores bit-equal: {bit_equal}; "
        f"{from_remote} of {remote[1].size} rows from the workers' clusters; coordinator launches {launches} "
        f"(the workers' launches are theirs, not counted here); groups held in process {gib(held)}, "
        f"{gib(torch.cuda.memory_allocated())} allocated by the coordinator in all")
    out["remote"] = {"batch_ms": times, "group_ms": {str(g): v for g, v in group_ms.items()},
                     "coordinator_launches": launches,
                     "bit_equal": bit_equal, "rows_from_workers": from_remote,
                     "coordinator_group_bytes": held, "coordinator_allocated": torch.cuda.memory_allocated(),
                     **{k: {str(g): v for g, v in started[k].items()} if isinstance(started[k], dict) else started[k]
                        for k in ("part_bytes", "part_write_s", "worker_start_s", "worker_load_s")}}
    return out, ms, remote, started["paths"]


def run_multislice_path(torch, work: Path, ref: dict) -> tuple[dict, dict]:
    """(a)-(e) over the capacity path's IVF indexes at BGE-M3 width: 40
    queries (32 corpus rows, self-retrieval, and the 8 questions), nprobe 32,
    top-20, 3 batches per step. Returns the phase's numbers and the
    coordinator's B4 launches (counted from 0 before each step's batches and
    read after them, summed over (a)-(d))."""
    import signal

    import numpy as np

    from tensortruth_tpu_torch.ops.ivf import ShardedIVF
    from tensortruth_tpu_torch.parallel import make_mesh
    from tensortruth_tpu_torch.parallel.multislice import MultiSliceIVF

    q = np.concatenate([ref["vecs"], ref["q_f32"]]).astype(np.float32)
    nprobe = ref["nprobe"]
    part_dir = work / "multislice"
    part_dir.mkdir()
    transports = []
    out = {"queries": len(q), "k": MULTISLICE_K, "nprobe": nprobe, "n_groups": MULTISLICE_GROUPS, "batches_per_step": 3,
           "remote_groups": list(MULTISLICE_REMOTE), "ivf_build_s": ref["ivf_build_s"],
           "workers_launches": "not visible to the coordinator: proved by the remote ids equal to (a)'s"}
    log(f"multislice: reusing the capacity path's IVF indexes (built in "
        + ", ".join(f"{k} {v:.1f} s" for k, v in ref["ivf_build_s"].items()) + ")")
    t_phase = time.perf_counter()
    try:
        # (a) + (b) bf16
        out["bfloat16"], ms, _, paths = run_multislice_dtype(torch, ref["ivf"]["bfloat16"], "bfloat16", q, ref,
                                                             part_dir, transports)
        ms.close()  # shuts the bf16 workers down
        for path in paths.values():
            path.unlink()
        # (c) int8: (a) and (b) again
        out["int8"], ms8, remote8, _ = run_multislice_dtype(torch, ref["ivf"]["int8"], "int8", q, ref, part_dir,
                                                           transports)

        # (e) elastic recovery: SIGKILL group 3's worker; the next batch respawns it
        sup = {g: ms8.transports[g] for g in MULTISLICE_REMOTE}
        victim = sup[MULTISLICE_REMOTE[-1]]
        pid = victim.worker_pid
        os.kill(pid, signal.SIGKILL)
        victim._proc.wait(timeout=60)
        t = time.perf_counter()
        again = ms8.search(q, MULTISLICE_K, nprobe=nprobe)
        torch.cuda.synchronize()
        recover_ms = (time.perf_counter() - t) * 1e3
        check(victim.respawn_count == 1 and victim.worker_pid not in (None, pid),
              f"multislice (e): respawns {victim.respawn_count}, pid {victim.worker_pid} (was {pid})")
        check(all(st.respawn_count == 0 for g, st in sup.items() if st is not victim), "multislice (e): another worker respawned")
        check(ms8.last_failed_groups == [], f"multislice (e): groups {ms8.last_failed_groups} failed")
        check(np.array_equal(again[1], remote8[1]), "multislice (e): ids after the respawn differ from (c)'s")
        log(f"multislice (e): worker of group {MULTISLICE_REMOTE[-1]} (pid {pid}) killed; the next int8 batch "
            f"respawned it (pid {victim.worker_pid}) and answered in {recover_ms:.1f} ms with (c)'s ids")
        out["elastic"] = {"recover_ms": recover_ms, "respawns": victim.respawn_count, "failed_groups": []}
        ms8.close()
        del ms8

        # (d) 2 groups, each held on a 1 x 2 mesh of the card, bf16
        mesh = make_mesh(**MULTISLICE_MESH, devices=[torch.device("cuda", 0)] * MULTISLICE_MESH["n_shards"])
        t = time.perf_counter()
        msd = MultiSliceIVF(ref["ivf"]["bfloat16"], 2, meshes=[mesh, mesh])
        place_s = time.perf_counter() - t
        check(all(isinstance(g.index, ShardedIVF) for g in msd.groups), "multislice (d): a group is not sharded")
        touched = [s["group"] for s in route_shapes(msd, q, nprobe) if s["queries"]]
        got, times, group_ms = timed_search(torch, msd, q, nprobe)
        launches = b4_launches("bfloat16")
        n_shards = MULTISLICE_MESH["n_shards"]
        check(launches["ivf_probe"] == 3 * n_shards * len(touched),
              f"multislice (d): launches {launches} over 3 batches, wanted one per shard per group touched ({touched})")
        err, swaps = check_rows_agree("multislice (d)", got, msd.search(q, MULTISLICE_K, nprobe=nprobe, plain=True))
        rate = float((got[1][: len(ref["rows"]), 0] == ref["rows"]).mean())
        check(rate >= MIN_SELF_RETRIEVAL, f"multislice (d): self-retrieval {rate} < {MIN_SELF_RETRIEVAL}")
        shards = [{"group": g.group_id, "shard": s, "blocks": list(arrays[1].shape), "centroids": list(arrays[0].shape)}
                  for g in msd.groups for s, by_dev in sorted(g.index.parts.items()) for arrays in by_dev.values()]
        nbytes_d = sum(g.index.nbytes() for g in msd.groups)
        log(f"multislice (d): 2 groups, each on a 1 x {n_shards} mesh of the card: placed in {place_s:.1f} s "
            f"({gib(nbytes_d)}); batch ms " + ", ".join(f"{x:.1f}" for x in times) + " (median ms of each group's "
            "call: " + group_medians(group_ms) + f"); launches {launches} over 3 "
            f"batches; against the plain probe max |err| {err:.2e} ({swaps} row swaps); self-retrieval {rate:.4f}")
        out["mesh"] = {"place_s": place_s, "device_bytes": nbytes_d, "batch_ms": times,
                       "group_ms": {str(g): v for g, v in group_ms.items()},
                       "launches": launches, "max_abs_err": err, "self_retrieval": rate,
                       "shards": shards}
        del msd
    finally:
        for st in transports:
            try:
                st.close()
            finally:
                st._kill()
        shutil.rmtree(part_dir, ignore_errors=True)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    launches = {"ivf_probe": out["bfloat16"]["launches"]["ivf_probe"] + out["mesh"]["launches"]["ivf_probe"]
                + out["bfloat16"]["remote"]["coordinator_launches"]["ivf_probe"],
                **{k: out["int8"]["launches"][k] + out["int8"]["remote"]["coordinator_launches"][k]
                   for k in ("ivf_probe_int8", "ivf_group_probes")}}
    return out, launches


# -- phase 13: the probe path -------------------------------------------------


def run_probe_path() -> dict:
    """The int8 tensor-core probe, as ``python -m
    tensortruth_tpu_torch.scripts.probe_int8_mma`` runs it. Returns the
    launches of B5 counted while it ran."""
    import math

    from tensortruth_tpu_torch.ops.matmul import tc_matmul
    from tensortruth_tpu_torch.scripts import probe_int8_mma

    tc_matmul.launches = tc_matmul.launches_int8 = 0
    result = probe_int8_mma.run(device="cuda")
    launches = {"tc_matmul": tc_matmul.launches, "tc_matmul_int8": tc_matmul.launches_int8}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the probe path")
    check(set(result["variants"]) == set(probe_int8_mma.VARIANTS)
          and all(math.isfinite(v["ms"]) and v["ms"] > 0 for v in result["variants"].values()),
          f"probe variants {result['variants']}")
    log(f"probe path: int8 over bf16 {result['int8_over_bf16']:.3f}x (rule >= {probe_int8_mma.DECISION_RATIO}x), "
        f"quantized rerank pays: {result['quantized_rerank_pays']}; launches {launches}")
    return launches


def main() -> None:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from tensortruth_tpu_torch import _build  # fails here outside a checkout
    from tensortruth_tpu_torch.scripts import card_line

    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT))
    for var, sub in (
        ("TENSOR_TRUTH_TPU_DATA_DIR", "data"),
        ("TENSOR_TRUTH_TPU_INDEXES_DIR", "indexes"),
        ("TENSOR_TRUTH_TPU_NATIVE_CACHE", "native"),
        ("TENSOR_TRUTH_TPU_MODELS_DIR", "models"),
        ("HF_HUB_CACHE", "hf"),
    ):
        os.environ[var] = str(work / sub)
    try:
        card = card_line()
        check(card is not None, "nvidia-smi is missing")
        log(f"card: {card}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

        t0 = time.perf_counter()
        _build.load()
        built = f"compiled in {_build.build_seconds:.1f} s" if _build.build_seconds else "already built"
        log(f"build: {_build.library_path().relative_to(ROOT)} {built}, ready in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        measured = {
            "fused_topk": check_fused_topk(torch),
            "fused_topk_int8": check_fused_topk_int8(torch),
            "blocked_attention": check_attention(torch),
            **check_ivf_probe(torch),
            **check_tc_matmul(torch),
        }
        log(f"kernel checks: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        build_launches, build_shapes = run_build_path(torch, card)
        log(f"build path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        server, server_launches, server_shapes = run_server_path(torch, work)
        log(f"server path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches, main_shapes = run_main_path(torch, work)
        log(f"main path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        (serving, serving_launches, serving_shapes,
         orchestrator, orch_launches, orch_shapes) = run_serving_path(torch, work)
        log(f"serving and orchestrator paths: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        recall, recall_launches = run_recall_path()
        log(f"recall path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        capacity_launches, reference = run_capacity_path(torch, work)
        launches |= capacity_launches
        log(f"capacity path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        mesh, mesh_launches = run_mesh_path(torch, work, reference)
        log(f"mesh path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        multislice, multislice_launches = run_multislice_path(torch, work, reference)
        del reference
        log(f"multislice path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches |= run_probe_path()
        log(f"probe path: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # B3 runs on the build's long leaves and on every serving path's long
    # pairs; each was also held against its plain version at that path's
    # shapes and masks. B1 serves every serving path and the recall driver.
    b3 = measured["blocked_attention"]
    b3_paths = {"build": (build_launches, build_shapes),
                "server": (server_launches["blocked_attention"], server_shapes),
                "main": (launches["blocked_attention"], main_shapes),
                "serving": (serving_launches["blocked_attention"], serving_shapes),
                "orchestrator": (orch_launches["blocked_attention"], orch_shapes)}
    b3["launches_by_path"] = {path: n for path, (n, _) in b3_paths.items()}
    b3["by_path"] = {path: shapes for path, (_, shapes) in b3_paths.items()}
    b3["max_abs_err"] = max([b3["max_abs_err"]] + [e["max_abs_err"] for _, shapes in b3_paths.values() for e in shapes])
    launches["blocked_attention"] = sum(b3["launches_by_path"].values())
    measured["fused_topk"]["launches_by_path"] = {
        "server": server_launches["fused_topk"], "main": launches["fused_topk"],
        "serving": serving_launches["fused_topk"], "orchestrator": orch_launches["fused_topk"], "recall": recall_launches}
    launches["fused_topk"] = sum(measured["fused_topk"]["launches_by_path"].values())
    # Every B1 search of the serving and orchestrator paths was held against
    # fused_topk_plain at its query-batch shape.
    b1 = measured["fused_topk"]
    b1["by_path"] = {"serving": serving["searches"], "orchestrator": orchestrator["shapes"]}
    b1["max_abs_err"] = max([b1["max_abs_err"]] + [e["max_abs_err"] for shapes in b1["by_path"].values() for e in shapes])
    # The mesh path runs B1, B2 and B4 once per shard, on the shapes its
    # shards give them (``mesh_shards``).
    shards = {"fused_topk": mesh["flat"]["a"]["shards"], "fused_topk_int8": mesh["flat"]["b"]["shards"],
              "ivf_probe": mesh["ivf"]["bfloat16"]["shards"], "ivf_probe_int8": mesh["ivf"]["int8"]["shards"],
              "ivf_group_probes": mesh["ivf"]["int8"]["shards"]}
    for name, n in mesh_launches.items():
        by_path = measured[name].setdefault("launches_by_path", {"capacity": launches[name]})
        by_path["mesh"] = n
        measured[name]["mesh_shards"] = shards[name]
        launches[name] += n
    # The multislice path runs B4 in every in-process group and in every
    # worker; only the coordinator's own launches are counted here, on the
    # shapes each group gave it (``multislice_groups``).
    ms_groups = {"ivf_probe": {"groups": multislice["bfloat16"]["groups"], "mesh_shards": multislice["mesh"]["shards"]},
                 "ivf_probe_int8": {"groups": multislice["int8"]["groups"]},
                 "ivf_group_probes": {"groups": multislice["int8"]["groups"]}}
    ms_err = {"ivf_probe": max(multislice["bfloat16"]["max_abs_err"], multislice["mesh"]["max_abs_err"]),
              "ivf_probe_int8": multislice["int8"]["max_abs_err"]}
    for name, n in multislice_launches.items():
        measured[name].setdefault("launches_by_path", {})["multislice"] = n
        measured[name]["multislice_groups"] = {**ms_groups[name], "workers": "launches not visible to the coordinator"}
        if name in ms_err:
            measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"], ms_err[name])
        launches[name] += n
    kernels = [
        {"name": name, **KERNELS[name], "launches": launches[name], **measured[name]}
        for name in KERNELS
    ]
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"server": {k: server[k] for k in (
        "upload_s", "upload_chunks", "engine_load_s", "rest_chat_s", "messages", "from_upload", "searches",
        "peak_bytes", "launches", "trace_b1_events")}}))
    print(json.dumps({"multislice": multislice}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"orchestrator": orchestrator}))
    print(json.dumps({"recall": recall}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
