"""Time design variants of kernels B1, B2, B3, B4 (int8 blocks) and B5 side
by side on one card.

    python -m tensortruth_tpu_torch.scripts.kernel_variants [NAME ...]   # needs one CUDA card

Each variant is a copy of a ``csrc/`` source with some of its text changed
(``VARIANTS``; the first of each source is the source as it stands; a text
that the source lacks is changed in ``hopper.cuh``, which every copy carries).
All are compiled together, one ``nvcc -Xptxas -v`` each, into libraries of
their own under ``_build/variants/``, loaded side by side with ctypes, and
timed in turns with CUDA events in one process: the products (bf16 and int8)
beside ``torch.mm(out_dtype=float32)`` and ``torch._int_mm``; the attention
variants, the top-k variants (B1 over bf16 rows for ``topk`` and the
``topk_bf16_*`` rows, B2 over int8 rows for the others) and the int8 IVF
probe variants only against each other (``chip_smoke.py`` times the
library's attention). Each build line
gives ptxas's registers and spills, and SERIALIZED where ptxas reports that it
serialised the wgmmas (C75xx). Every variant's result is held against the
kernel's plain version; none is asserted. Names on the command line pick
variants; none picks all. ``NAME@DIR`` builds variant NAME from the
``csrc/`` directory DIR of another checkout instead (a parent commit
unpacked with ``git archive``), so two commits' kernels are timed in turns
in one process; the top-k and the probe take only sources with today's C
interface.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from tensortruth_tpu_torch import _build
from tensortruth_tpu_torch.scripts import card_line

VARIANTS = {  # name: (source, {text in the source: its replacement})
    "gemm": ("tc_matmul.cu", {}),
    "gemm_epi64x1": ("tc_matmul.cu", {"constexpr int kEpiCols = 32;": "constexpr int kEpiCols = 64;",
                                      "kEpiBufs = 2;  // bf16": "kEpiBufs = 1;  // bf16",
                                      "kEpiBufs = 4;  // int8": "kEpiBufs = 2;  // int8"}),
    "gemm_stages3": ("tc_matmul.cu", {"kStages = 4, kEpiBufs = 2;  // bf16": "kStages = 3, kEpiBufs = 2;  // bf16"}),
    "gemm_int8_s4": ("tc_matmul.cu", {"kStages = 5, kEpiBufs = 4;  // int8": "kStages = 4, kEpiBufs = 4;  // int8"}),
    "gemm_int8_e2": ("tc_matmul.cu", {"kStages = 5, kEpiBufs = 4;  // int8": "kStages = 5, kEpiBufs = 2;  // int8"}),
    "topk": ("fused_topk.cu", {}),
    "topk_stages8": ("fused_topk.cu", {"constexpr int kInt8Stages = 6;": "constexpr int kInt8Stages = 8;"}),
    "topk_stages4": ("fused_topk.cu", {"constexpr int kInt8Stages = 6;": "constexpr int kInt8Stages = 4;"}),
    "topk_stages2": ("fused_topk.cu", {"constexpr int kInt8Stages = 6;": "constexpr int kInt8Stages = 2;"}),
    "topk_wg3": ("fused_topk.cu", {"constexpr int kInt8Consumers = 2;": "constexpr int kInt8Consumers = 3;"}),
    "topk_wg1x2": ("fused_topk.cu", {"constexpr int kInt8Consumers = 2;": "constexpr int kInt8Consumers = 1;",
                                     "constexpr int kInt8Stages = 6;": "constexpr int kInt8Stages = 5;"}),
    "topk_i2f": ("fused_topk.cu", {  # the first design's conversion: __int2bfloat16_rn per byte
        "l = __floats2bfloat162_rn(f0, f1), h = __floats2bfloat162_rn(f2, f3);":
        "l = __halves2bfloat162(__int2bfloat16_rn((signed char)w), __int2bfloat16_rn((signed char)(w >> 8))),"
        " h = __halves2bfloat162(__int2bfloat16_rn((signed char)(w >> 16)), __int2bfloat16_rn((signed char)(w >> 24)));"}),
    "topk_bf16_stages3": ("fused_topk.cu", {"constexpr int kBf16Stages = 6;": "constexpr int kBf16Stages = 3;"}),
    "topk_bf16_stages8": ("fused_topk.cu", {"constexpr int kBf16Stages = 6;": "constexpr int kBf16Stages = 8;"}),
    "topk_bf16_wg3": ("fused_topk.cu", {"constexpr int kBf16Consumers = 2;": "constexpr int kBf16Consumers = 3;"}),
    "topk_bf16_wait0": ("fused_topk.cu", {  # a box's stage freed only once its own wgmmas retire
        "wgmma_wait<1>();  // B1: the box before has been read": "wgmma_wait<0>();"}),
    "probe": ("ivf_probe.cu", {}),
    "probe_stages4": ("ivf_probe.cu", {"constexpr int kProbeStages = 6;": "constexpr int kProbeStages = 4;"}),
    "probe_items8": ("ivf_probe.cu", {"constexpr int kProbeItemsPerBlock = 4;": "constexpr int kProbeItemsPerBlock = 8;"}),
    "probe_items16": ("ivf_probe.cu", {"constexpr int kProbeItemsPerBlock = 4;": "constexpr int kProbeItemsPerBlock = 16;"}),
    "attn": ("attention.cu", {}),
    "attn_stages4": ("attention.cu", {"constexpr int kStages = 3;": "constexpr int kStages = 4;"}),
    "attn_q256": ("attention.cu", {"constexpr int kBQ = 128;": "constexpr int kBQ = 256;",
                                   "constexpr int kMinBlocks = 2;": "constexpr int kMinBlocks = 1;"}),
}
GEMM_SHAPES = [(16384, 1024, 4096), (16384, 2048, 4096), (16384, 128, 4096)]  # (M, K, N)
TOPK_SHAPES = [(32, 2_097_152, 1024), (32, 262_144, 1024), (64, 262_144, 2048)]  # (B, N, D), k = 100, int8 rows
TOPK_BF16_SHAPES = [(32, 262_144, 1024), (32, 1_048_576, 1024), (64, 262_144, 2048)]  # (B, N, D), k = 100, bf16 rows
# (B, nprobe, clusters, rpc, D): chip_smoke.py's PROBE_SHAPE, then rpc not a
# multiple of 64; each with chip_smoke.py's random 70% mask and with a prefix
# mask as build_ivf fills clusters.
PROBE_SHAPES = [(32, 32, 1024, 3072, 1024), (32, 32, 1024, 3000, 1024)]
ATTN_SHAPES = [(16, 512, False), (16, 1024, False), (16, 2048, False), (16, 1024, True), (2, 16384, False)]  # B, S, dense


def _variant(name: str) -> tuple[str, dict, Path]:
    """(source file, substitutions, source directory) of ``name``:
    ``NAME`` from the package's csrc, ``NAME@DIR`` from another checkout's
    (a parent commit's, unpacked with ``git archive``), e.g. ``gemm@DIR``."""
    base, _, where = name.partition("@")
    src, subs = VARIANTS[base]
    return src, subs, Path(where) if where else _build.CSRC_DIR


def sources(name: str) -> dict[str, str]:
    """{file name: text} of variant ``name``: its source and hopper.cuh, each
    substitution made in the one of them that holds its text."""
    src, subs, csrc = _variant(name)
    texts = {src: (csrc / src).read_text(), "hopper.cuh": (csrc / "hopper.cuh").read_text()}
    for old, new in subs.items():
        where = [f for f, text in texts.items() if old in text]
        if len(where) != 1:
            raise ValueError(f"{name}: {old!r} is in {where or 'neither'} of {list(texts)}")
        texts[where[0]] = texts[where[0]].replace(old, new, 1)
    return texts


def build(name: str) -> tuple[ctypes.CDLL | None, str]:
    src = _variant(name)[0]
    out = _build.BUILD_DIR / "variants" / name.replace("@", "_at_").replace("/", "_")
    out.mkdir(parents=True, exist_ok=True)
    for file, text in sources(name).items():
        (out / file).write_text(text)
    so = out / "lib.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(so), str(out / src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    notes, kernel = [], "?"
    for line in log.splitlines():  # each kernel's name, then its registers and spills
        if "Compiling entry function" in line:
            kernel = line.split("'")[1][:40]
        elif "Used" in line or "spill stores" in line:
            notes.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    errors = [line for line in log.splitlines() if "error" in line][:12] or log.splitlines()[:12]
    report = f"rc={proc.returncode}; " + " | ".join(notes if proc.returncode == 0 else errors)
    if "C75" in log:  # ptxas serialised wgmmas: say why and in which kernel
        report += " SERIALIZED: " + " | ".join(sorted({_demangle(line.split(")", 1)[-1].strip())
                                                      for line in log.splitlines() if "C75" in line}))
    if proc.returncode != 0:
        return None, report
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib, report


def _demangle(text: str) -> str:
    """``text`` with the quoted kernel name demangled (cu++filt, beside nvcc)."""
    name = text.rsplit("'", 2)[-2] if text.count("'") >= 2 else ""
    filt = Path(_build._nvcc()).parent / "cu++filt"
    if name and filt.exists():
        plain = subprocess.run([str(filt), name], capture_output=True, text=True).stdout.strip()
        text = text.replace(name, plain[:120])
    return text


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def gemm(lib, a, b, n_outer=0):
    (m, k), n = a.shape, b.shape[1]
    int8 = a.dtype == torch.int8
    out = torch.empty((m, n), dtype=torch.int32 if int8 else torch.float32, device=a.device)
    if int8 and hasattr(lib, "tt_transpose_s8"):  # b^T, as the wrapper makes it (a source before it took b)
        b_t = torch.empty((n, k), dtype=torch.int8, device=a.device)
        _build.check(lib.tt_transpose_s8(b.data_ptr(), b_t.data_ptr(), k, n, _build.stream_of(b)), "transpose variant")
        b = b_t
    _build.check(lib.tt_tc_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, int(int8), n_outer,
                                  _build.stream_of(a)), "tc_matmul variant")
    return out


def topk_stream(lib, q, e, scales, k):
    """B2 (``scales`` given) or B1 through variant ``lib``, scheduled as
    ``ops/topk.py`` schedules it."""
    from tensortruth_tpu_torch.ops import topk as t

    n, int8 = e.shape[0], scales is not None
    q, e, scales, (b, b_pad, d, c, c_out, n_rot, inner) = t._kernel_operands(
        q, e, scales, tile_n=2048, m=1, c_out=2048, n_actual=n, name="fused_topk variant")
    occupancy = (ctypes.c_int * 2)()
    _build.check(lib.tt_fused_topk_occupancy(int(int8), d, occupancy), "fused_topk variant occupancy")
    blocks, n_ranges = t.stream_schedule(b_pad, c, n_rot, inner, 1, *occupancy)
    (pv, pi), (cv, ci) = t._candidate_buffers(n_ranges, b_pad, c_out, q.device)
    if int8:
        q = t.permute_dims(q)
    _build.check(lib.tt_fused_topk_candidates(
        q.data_ptr(), e.data_ptr(), scales.data_ptr() if int8 else None, pv.data_ptr(), pi.data_ptr(),
        cv.data_ptr(), ci.data_ptr(), b_pad, d, n, 2048, 1, n_rot, inner, n_ranges, blocks, _build.stream_of(q)),
        "fused_topk variant")
    return t.select_topk(cv[:b], ci[:b], k, n)


def group(lib, probe, n_clusters):
    """B4's grouping of the (query, probe) pairs through variant ``lib``."""
    n_pairs, dev = probe.numel(), probe.device
    scratch = torch.empty(2 * n_clusters, dtype=torch.int32, device=dev)
    order = torch.empty(n_pairs, dtype=torch.int32, device=dev)
    chunks = torch.empty((n_pairs, 3), dtype=torch.int32, device=dev)
    n_chunks = torch.empty(1, dtype=torch.int32, device=dev)
    _build.check(lib.tt_ivf_group_probes(probe.data_ptr(), scratch.data_ptr(), order.data_ptr(), chunks.data_ptr(),
                                         n_chunks.data_ptr(), n_pairs, n_clusters, _build.stream_of(probe)),
                 "group variant")
    return order, chunks, n_chunks


def probe_int8(lib, probe, q, blocks, valid, scales):
    """B4 over int8 blocks through variant ``lib``: the grouping, then the
    scores, as ``ops/ivf.py`` launches them."""
    (n_clusters, rpc, d), (b, nprobe) = blocks.shape, probe.shape
    dev, stream = q.device, _build.stream_of(q)
    order, chunks, n_chunks = group(lib, probe, n_clusters)
    out = torch.empty((b, nprobe, rpc), dtype=torch.float32, device=dev)
    _build.check(lib.tt_ivf_probe_scores_int8(
        q.data_ptr(), blocks.data_ptr(), valid.data_ptr(), scales.data_ptr(), order.data_ptr(), chunks.data_ptr(),
        n_chunks.data_ptr(), out.data_ptr(), nprobe, n_clusters, rpc, d, stream), "ivf_probe_int8 variant")
    return out


def attn(lib, q, k, v, mask):
    b, nh, s, dh = q.shape
    sb, sh, ss, _ = q.stride()
    out = torch.empty_like(q)
    _build.check(lib.tt_blocked_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                                          b, nh, s, sb, sh, ss, 1.0 / math.sqrt(dh), _build.stream_of(q)),
                 "blocked_attention variant")
    return out


def time_gemms(libs: dict) -> None:
    from tensortruth_tpu_torch.ops.matmul import tc_matmul_plain
    from tensortruth_tpu_torch.scripts.probe_int8_mma import make_inputs

    for (m, k, n), operands in ((shape, op) for shape in GEMM_SHAPES for op in ("bf16", "int8")):
        a, b = make_inputs(m, k, n, device="cuda")[operands]
        if operands == "int8":
            b_cm = b.t().contiguous().t()  # column-major: the layout torch._int_mm takes without a copy
            library, lib_name = (lambda: torch._int_mm(a, b_cm)), "torch._int_mm (b column-major)"
        else:
            library, lib_name = (lambda: torch.mm(a, b, out_dtype=torch.float32)), "torch.mm"
        want = tc_matmul_plain(a, b)
        lines = [f"GEMM {operands} M={m} K={k} N={n}: {lib_name} {device_ms(library):.4f} ms"]
        for name, lib in libs.items():
            err = max((gemm(lib, a, b, no) - want).abs().max().item() for no in (0, 1))
            t1 = device_ms(lambda: gemm(lib, a, b))
            t2 = device_ms(lambda: gemm(lib, a, b, 1))
            t3 = device_ms(lambda: gemm(lib, a, b))
            lines.append(f"{name} {min(t1, t3):.4f}/{max(t1, t3):.4f} ms (N-tile-major {t2:.4f}) max |err| {err:.2g}")
        lines.append(f"{lib_name} again {device_ms(library):.4f} ms")
        print("\n  ".join(lines), flush=True)
        del a, b, want
        torch.cuda.empty_cache()


def _is_bf16_topk(name: str) -> bool:
    """Whether variant ``name`` of fused_topk.cu is timed as B1 (bf16 rows)."""
    base = name.partition("@")[0]
    return base == "topk" or base.startswith("topk_bf16")


def time_topk(libs: dict) -> None:
    """B1 variants over bf16 rows and B2 variants over int8 rows (the int8
    flat tier's shape and smaller ones): random rows and scales (the
    kernels' times do not depend on the values), each against its plain
    version, timed in turns."""
    from tensortruth_tpu_torch.ops.topk import fused_topk_int8_plain, fused_topk_plain

    gen = torch.Generator(device="cuda").manual_seed(2)
    runs = [(shape, True) for shape in TOPK_BF16_SHAPES] + [(shape, False) for shape in TOPK_SHAPES]
    for (b, n, d), bf16 in runs:
        chosen = {name: lib for name, lib in libs.items() if _is_bf16_topk(name) or not bf16}
        if not chosen:
            continue
        q = torch.randn((b, d), generator=gen, device="cuda").to(torch.bfloat16)
        if bf16:
            e, scales = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16), None
            want = fused_topk_plain(q, e, 100)
        else:
            e = torch.randint(-127, 128, (n, d), generator=gen, device="cuda", dtype=torch.int8)
            scales = torch.rand(n, generator=gen, device="cuda") / 127
            want = fused_topk_int8_plain(q, e, scales, 100)
        nbytes = n * d * e.element_size()
        lines = [f"TOPK {'bf16' if bf16 else 'int8'} B={b} N={n} D={d} k=100: corpus {nbytes} bytes"]
        for name, lib in chosen.items():
            vals, idx = topk_stream(lib, q, e, scales, 100)
            err = (vals - want[0]).abs().max().item()
            same = (idx == want[1]).float().mean().item()
            t1 = device_ms(lambda: topk_stream(lib, q, e, scales, 100))
            t2 = device_ms(lambda: topk_stream(lib, q, e, scales, 100))
            lines.append(f"{name} {min(t1, t2):.4f}/{max(t1, t2):.4f} ms ({nbytes / min(t1, t2) / 1e9:.3f} TB/s) "
                         f"max |err| {err:.3g}, same index {same:.4f}")
        print("\n  ".join(lines), flush=True)
        del q, e, scales, want
        torch.cuda.empty_cache()


def time_probe(libs: dict) -> None:
    """B4 variants over int8 blocks at the IVF tier's shape: random int8
    rows, scales and probe ids shared across queries as in chip_smoke.py,
    each mask against the plain version, timed in turns."""
    from tensortruth_tpu_torch.ops.ivf import probe_scores_plain

    gen = torch.Generator(device="cuda").manual_seed(4)
    for b, nprobe, c, rpc, d in PROBE_SHAPES:
        q = torch.randn((b, d), generator=gen, device="cuda").to(torch.bfloat16)
        blocks = torch.randint(-127, 128, (c, rpc, d), generator=gen, device="cuda", dtype=torch.int8)
        scales = torch.rand((c, rpc), generator=gen, device="cuda") / 127
        probe = torch.randint(0, c, (b, nprobe), generator=gen, device="cuda", dtype=torch.int32)
        probe[:, 0] = probe[0, 0].item()
        probe[1::2, 1] = probe[0, 1].item()
        random = (torch.rand((c, rpc), generator=gen, device="cuda") > 0.3).to(torch.int32)
        random[:, -128:] = 0
        fill = torch.randint(rpc // 2, rpc, (c, 1), generator=gen, device="cuda")
        prefix = (torch.arange(rpc, device="cuda")[None, :] < fill).to(torch.int32)
        for mask_name, valid in (("random 70%", random), ("prefix", prefix)):
            probed = torch.unique(probe.long())
            rows = int(valid[probed].sum())
            want = probe_scores_plain(probe, q, blocks, valid, scales)
            lines = [f"PROBE int8 B={b} nprobe={nprobe} clusters={c} rpc={rpc} D={d}, {mask_name} valid: "
                     f"{probed.numel()} clusters probed, {rows} valid rows in them ({rows * d} bytes)"]
            for name, lib in libs.items():
                lines.append(f"{name} grouping alone {device_ms(lambda: group(lib, probe, c)):.4f} ms")
                got = probe_int8(lib, probe, q, blocks, valid, scales)
                fin = torch.isfinite(want)
                same_pad = torch.equal(fin, torch.isfinite(got))
                err = (got[fin] - want[fin]).abs().max().item()
                t1 = device_ms(lambda: probe_int8(lib, probe, q, blocks, valid, scales))
                t2 = device_ms(lambda: probe_int8(lib, probe, q, blocks, valid, scales))
                lines.append(f"{name} {min(t1, t2):.4f}/{max(t1, t2):.4f} ms "
                             f"({rows * d / min(t1, t2) / 1e9:.3f} TB/s of valid rows) max |err| {err:.3g}, "
                             f"-inf on the padding: {same_pad}")
            print("\n  ".join(lines), flush=True)
            del want
        del q, blocks, scales, probe
        torch.cuda.empty_cache()


def time_attention(libs: dict) -> None:
    from tensortruth_tpu_torch.ops.attention import attention_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    nh, dh = 16, 64
    for b, s, dense in ATTN_SHAPES:
        q, k, v = (torch.randn((b, nh, s, dh), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
        if dense:
            lengths[:] = s
        elif b > 3:
            lengths[0], lengths[3] = s, 0  # one full row, one fully padded row
        mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
        # The plain version's (B, NH, S, S) scores do not fit at S = 16384:
        # there the first variant is the yardstick.
        ref = attention_reference(q, k, v, mask) if s < 16384 else attn(next(iter(libs.values())), q, k, v, mask)
        lines = [f"ATTN B={b} S={s} {'dense' if dense else 'ragged'}, {int(mask.sum())} real keys"]
        for name, lib in libs.items():
            err = (attn(lib, q, k, v, mask).float() - ref.float()).abs().max().item()
            t1 = device_ms(lambda: attn(lib, q, k, v, mask))
            t2 = device_ms(lambda: attn(lib, q, k, v, mask))
            lines.append(f"{name} {min(t1, t2):.4f}/{max(t1, t2):.4f} ms max |err| {err:.3g}")
        print("\n  ".join(lines), flush=True)
        del q, k, v, ref
        torch.cuda.empty_cache()


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("kernel_variants needs a CUDA card", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    unknown = {n for n in names if n.partition("@")[0] not in VARIANTS}
    if unknown:
        print(f"unknown variants: {sorted(unknown)}; known: {list(VARIANTS)}", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build, names)))
    for name, (_, report) in built.items():
        print(f"build {name}: {report}", flush=True)
    libs = {name: lib for name, (lib, _) in built.items() if lib is not None}
    gemms = {n: lib for n, lib in libs.items() if _variant(n)[0] == "tc_matmul.cu"}
    attns = {n: lib for n, lib in libs.items() if _variant(n)[0] == "attention.cu"}
    topks = {n: lib for n, lib in libs.items() if _variant(n)[0] == "fused_topk.cu"}
    probes = {n: lib for n, lib in libs.items() if _variant(n)[0] == "ivf_probe.cu"}
    if gemms:
        time_gemms(gemms)
    if topks:
        time_topk(topks)
    if probes:
        time_probe(probes)
    if attns:
        time_attention(attns)
    return 0 if len(libs) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
