"""Time design variants of kernels B3 and B5 (bf16) side by side on one card.

    python -m tensortruth_tpu_torch.scripts.kernel_variants [NAME ...]   # needs one CUDA card

Each variant is a copy of a ``csrc/`` source with some of its constants
changed (``VARIANTS``; the first of each kernel is the source as it stands).
All are compiled together, one ``nvcc -Xptxas -v`` each, into libraries of
their own under ``_build/variants/``, loaded side by side with ctypes, and
timed in turns with CUDA events in one process; the products beside
``torch.mm(out_dtype=float32)``, the attention variants only against each
other (``chip_smoke.py`` times the library's attention). Each build line
gives ptxas's registers and spills, and SERIALIZED where ptxas reports that it
serialised the wgmmas (C75xx). Every variant's result is held against the
kernel's plain version; none is asserted. Names on the command line pick
variants; none picks all.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from tensortruth_tpu_torch import _build

VARIANTS = {  # name: (source, {text in the source: its replacement})
    "gemm": ("tc_matmul.cu", {}),
    "gemm_epi64x1": ("tc_matmul.cu", {"kEpiCols = 32, kEpiBufs = 2;": "kEpiCols = 64, kEpiBufs = 1;"}),
    "gemm_stages3": ("tc_matmul.cu", {"constexpr int kStages = 4;": "constexpr int kStages = 3;"}),
    "attn": ("attention.cu", {}),
    "attn_stages4": ("attention.cu", {"constexpr int kStages = 3;": "constexpr int kStages = 4;"}),
    "attn_q256": ("attention.cu", {"constexpr int kBQ = 128;": "constexpr int kBQ = 256;",
                                   "constexpr int kMinBlocks = 2;": "constexpr int kMinBlocks = 1;"}),
}
GEMM_SHAPES = [(16384, 1024, 4096), (16384, 2048, 4096), (16384, 128, 4096)]  # (M, K, N)
ATTN_SHAPES = [(16, 512, False), (16, 1024, False), (16, 2048, False), (16, 1024, True), (2, 16384, False)]  # B, S, dense


def build(name: str) -> tuple[ctypes.CDLL | None, str]:
    src, subs = VARIANTS[name]
    out = _build.BUILD_DIR / "variants" / name
    out.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC_DIR / src).read_text()
    for old, new in subs.items():
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {src}")
        text = text.replace(old, new, 1)
    (out / src).write_text(text)
    (out / "hopper.cuh").write_text((_build.CSRC_DIR / "hopper.cuh").read_text())
    so = out / "lib.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(so), str(out / src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    notes = [line.strip() for line in log.splitlines() if "Used" in line or "spill" in line]
    report = f"rc={proc.returncode}; " + " | ".join(notes[-2:] if proc.returncode == 0 else log.splitlines()[:6])
    if "C75" in log:
        report += " SERIALIZED"
    if proc.returncode != 0:
        return None, report
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib, report


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
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _build.check(lib.tt_tc_matmul(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, 0, n_outer,
                                  _build.stream_of(a)), "tc_matmul variant")
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

    for m, k, n in GEMM_SHAPES:
        a, b = make_inputs(m, k, n, device="cuda")["bf16"]
        want = tc_matmul_plain(a, b)
        lines = [f"GEMM M={m} K={k} N={n}: torch.mm {device_ms(lambda: torch.mm(a, b, out_dtype=torch.float32)):.4f} ms"]
        for name, lib in libs.items():
            err = max((gemm(lib, a, b, no) - want).abs().max().item() for no in (0, 1))
            t1 = device_ms(lambda: gemm(lib, a, b))
            t2 = device_ms(lambda: gemm(lib, a, b, 1))
            t3 = device_ms(lambda: gemm(lib, a, b))
            lines.append(f"{name} {min(t1, t3):.4f}/{max(t1, t3):.4f} ms (N-tile-major {t2:.4f}) max |err| {err:.2g}")
        lines.append(f"torch.mm again {device_ms(lambda: torch.mm(a, b, out_dtype=torch.float32)):.4f} ms")
        print("\n  ".join(lines), flush=True)
        del a, b, want
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
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"unknown variants: {sorted(unknown)}; known: {list(VARIANTS)}", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build, names)))
    for name, (_, report) in built.items():
        print(f"build {name}: {report}", flush=True)
    libs = {name: lib for name, (lib, _) in built.items() if lib is not None}
    gemms = {n: lib for n, lib in libs.items() if VARIANTS[n][0] == "tc_matmul.cu"}
    attns = {n: lib for n, lib in libs.items() if VARIANTS[n][0] == "attention.cu"}
    if gemms:
        time_gemms(gemms)
    if attns:
        time_attention(attns)
    return 0 if len(libs) == len(names) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
