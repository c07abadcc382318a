"""Drive the PyTorch/CUDA port's online query path once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each of which raises (exit code 1, no result line) when it fails:

1. card: the card's name and power limit, as nvidia-smi reports them;
2. build: compile the hand-written kernels (``tensortruth_tpu_torch/csrc``)
   with nvcc into ``tensortruth_tpu_torch/_build/``;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its path gives it, with the tolerance stated below, and both
   timed with CUDA events, each beside its bound (the least time the card
   could take for the same work, from this run's inputs) and, where one
   PyTorch call computes the same function, beside that call: B1 fused
   top-k, B2 its int8 variant, B3 attention at S = 512, 1024 and 2048
   (beside ``scaled_dot_product_attention``; the ``kernels`` line gives
   S = 1024's numbers and every S under ``by_seq``), B4 the IVF probe over bf16 and over
   int8 blocks (the int8 path also bit for bit on integer rows at scale 1,
   and its grouping of the (query, probe) pairs by cluster against the plain
   grouping), B5 the tensor-core product at the int8 probe's shape, bf16
   and int8, both block orders (beside ``torch.mm`` and ``torch._int_mm``;
   the int8 product also beside ``torch._int_mm`` on a column-major copy of
   b, made outside the timing, and with the time of its own b^T kernel);
4. main path: write a two-module index (this repository's own docs, chunked
   and embedded by the port, plus a synthetic module that brings the
   stacked corpus to 262,144 leaf rows), load it with the port's
   ``load_engine_for_modules`` under the default BGE-M3 /
   bge-reranker-v2-m3 architectures (random weights at full width, seeded),
   answer 8 requests through ``RAGService.retrieve()`` and one through
   ``query()`` with a stub LLM, and check the answers, the placement on the
   card, the recall of the fused top-k against the exact one, that every
   kernel of the path was launched during the requests, and, in a profiled
   replay of one request, that no stream synchronise falls between the
   rerank stage's batch launches;
5. capacity path: one more module brings the docs to 2,097,152 rows (the
   smallest power of two above the 2M-row IVF threshold). Through
   ``load_engine`` it is served (a) as the int8 flat tier (``corpus_dtype:
   int8``: kernel B2) and (b) with default params as the IVF tier over bf16
   blocks (B4), each answering 4 ``retrieve()`` requests; (c) a
   ``MultiIndexEngine`` over the same indexes with ``corpus_dtype="int8"``
   and ``ivf_threshold=1_048_576`` takes the IVF tier over int8 blocks (B4's
   int8 variant and its grouping kernel) and answers one 32-query batch. Each checks its placement,
   its answers, a recall or self-retrieval rate, and that its kernel was
   launched while it was driven;
6. probe path: the int8 tensor-core probe
   (``tensortruth_tpu_torch.scripts.probe_int8_mma.run()``) times B5's four
   variants at M=16384, K=1024, N=4096 and applies the reference's decision
   rule; B5 must have been launched, bf16 and int8, while it ran.

The last three lines are the card's name and power limit, a JSON object
describing each kernel, and the final ``{"ok": true, "device": ...}`` line.
Nothing here imports JAX or the JAX package; the host code (index, chunker,
config) is the port's own. All scratch files go to a temporary directory
inside the checkout that is removed at exit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
# the output to bf16 (ulp 2^-8 below 1.0). Inputs are N(0, 1).
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


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
    (vals, idx), (pvals, pidx) = got, want
    diff = (vals - pvals).abs()
    err = diff.max().item()
    bad = int(((idx != pidx) & (diff > TOPK_TOL)).sum())
    check(err <= TOPK_TOL and bad == 0, f"{name}: max |err| {err}, {bad} index mismatches")
    return err, int((idx != pidx).sum())


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
        f"kernel fused_topk B={b} N={n} D={d} k={k} bf16: max_abs_err={err:.3g} "
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
        err = (out.float() - ref.float()).abs().max().item()
        check(torch.isfinite(out.float()).all().item(), f"blocked_attention S={s}: non-finite output")
        check(err <= ATTN_TOL, f"blocked_attention S={s}: max |err| {err} > {ATTN_TOL}")
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
            f"kernel blocked_attention B={b} NH={nh} S={s} DH={dh} bf16: max_abs_err={err:.3g} "
            f"(tol {ATTN_TOL}), padded-row err={pad_err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, {keys} of {b * s} keys real), "
            f"scaled_dot_product_attention {library_ms:.4f} ms (max |err| {lib_err:.3g}, not asserted)"
        )
        worst = max(worst, err)
        timing[s] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd, "library_ms": library_ms}
        del q, k, v, out, ref, bias
        torch.cuda.empty_cache()
    # The top-level numbers are S=1024's, the bucket the main path's long
    # request lands in; every S measured is under "by_seq".
    top = {key: val for key, val in timing[1024].items() if key != "max_abs_err"}
    return {"max_abs_err": worst, **top, "by_seq": {str(s): t for s, t in timing.items()}}


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


# -- phase 4: the main path --------------------------------------------------


def docs_nodes(tokenizer) -> list:
    from tensortruth_tpu_torch.index import chunk_document

    files = sorted((ROOT / "docs").glob("*.md")) + [ROOT / "README.md", ROOT / "SURVEY.md"]
    nodes = []
    for f in files:
        meta = {"filename": f.name, "doc_type": "library"}
        nodes += chunk_document(
            f.read_text(encoding="utf-8"), tokenizer, doc_id=f.stem, module="docs", metadata=meta
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


def run_main_path(torch, work: Path) -> dict:
    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig
    from tensortruth_tpu_torch.index import VectorIndex
    from tensortruth_tpu_torch.models.manager import ModelManager, ModelSpec
    from tensortruth_tpu_torch.ops.attention import blocked_attention
    from tensortruth_tpu_torch.ops.topk import exact_topk, fused_topk
    from tensortruth_tpu_torch.services.rag_service import RAGService

    t0 = time.perf_counter()
    embedder = ModelManager.get_instance().get_embedder(ModelSpec("BAAI/bge-m3"), device="cuda")
    model_dir = work / "indexes" / "bge-m3"
    nodes = docs_nodes(embedder.tokenizer)
    docs = VectorIndex.build(nodes, embedder.encode, embedding_model="BAAI/bge-m3",
                             chunk_sizes=[2048, 512, 256], gelu_flavor=embedder.gelu_flavor)
    docs.save(model_dir / "docs")
    synthetic_index(torch, CORPUS_ROWS - docs.n_rows, embedder.dim).save(model_dir / "synthetic")
    log(f"index: docs {docs.n_rows} leaves ({len(nodes)} nodes), synthetic "
        f"{CORPUS_ROWS - docs.n_rows} leaves, written in {time.perf_counter() - t0:.1f} s")

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
    request_ms, results = [], []
    for text in questions:
        t = time.perf_counter()
        results.append(svc.retrieve(text))
        torch.cuda.synchronize()
        request_ms.append((time.perf_counter() - t) * 1e3)
    t = time.perf_counter()
    gen = svc.query("Summarise how a query flows from embedding to the reranked answer.")
    try:
        while True:
            next(gen)
    except StopIteration as stop:
        response = stop.value
    torch.cuda.synchronize()
    request_ms.append((time.perf_counter() - t) * 1e3)
    launches = {"fused_topk": fused_topk.launches, "blocked_attention": blocked_attention.launches}
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
    return launches


# -- phase 5: the capacity path ------------------------------------------------

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


def run_capacity_path(torch, work: Path) -> dict:
    """(a) int8 flat tier, (b) IVF over bf16 blocks, (c) IVF over int8 blocks,
    all at 2,097,152 rows x 1024. Returns the launches counted on each."""
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
    docs_rows = VectorIndex.load(model_dir / "docs").n_rows
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

    q = torch.from_numpy(embedder.encode(CAPACITY_QUESTIONS * 2, is_query=True)).to("cuda", torch.bfloat16)
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
    log(f"(b) IVF tier (bf16 blocks): loaded in {time.perf_counter() - t0:.1f} s")
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
    indexes = r.indexes
    svc.clear_engines()
    del engine, r
    torch.cuda.empty_cache()

    # (c) the IVF tier over int8 blocks: kernel B4's int8 variant
    t0 = time.perf_counter()
    r = MultiIndexEngine(indexes, corpus_dtype="int8", ivf_threshold=1_048_576, device="cuda")
    log(f"(c) IVF tier (int8 blocks): built in {time.perf_counter() - t0:.1f} s")
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
    return launches


# -- phase 6: the probe path --------------------------------------------------


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

    work = Path(tempfile.mkdtemp(prefix=".chip_smoke_", dir=ROOT))
    for var, sub in (
        ("TENSOR_TRUTH_TPU_DATA_DIR", "data"),
        ("TENSOR_TRUTH_TPU_NATIVE_CACHE", "native"),
        ("TENSOR_TRUTH_TPU_MODELS_DIR", "models"),
        ("HF_HUB_CACHE", "hf"),
    ):
        os.environ[var] = str(work / sub)
    try:
        card = card_line()
        log(f"card: {card}")
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

        t0 = time.perf_counter()
        _build.load()
        built = f"compiled in {_build.build_seconds:.1f} s" if _build.build_seconds else "already built"
        log(f"build: {_build.library_path().relative_to(ROOT)} {built}, ready in {time.perf_counter() - t0:.1f} s")

        measured = {
            "fused_topk": check_fused_topk(torch),
            "fused_topk_int8": check_fused_topk_int8(torch),
            "blocked_attention": check_attention(torch),
            **check_ivf_probe(torch),
            **check_tc_matmul(torch),
        }
        t0 = time.perf_counter()
        launches = run_main_path(torch, work)
        log(f"main path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches |= run_capacity_path(torch, work)
        log(f"capacity path: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        launches |= run_probe_path()
        log(f"probe path: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [
        {"name": name, **KERNELS[name], "launches": launches[name], **measured[name]}
        for name in KERNELS
    ]
    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
