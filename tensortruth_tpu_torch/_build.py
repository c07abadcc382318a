"""Build the package's CUDA kernels with ``nvcc`` at first use; load via ctypes.

Every ``*.cu`` under ``csrc/`` compiles into ONE shared library with a plain
C interface (no PyTorch headers, so a build takes seconds, not minutes): one
``nvcc -c`` per source, all started together, then one link. The
library lands in ``tensortruth_tpu_torch/_build/<hash>/`` keyed by a hash of
the sources and the flags, so an edited kernel rebuilds and an unchanged one
loads from disk. Nothing here runs at import time: ``load()`` is called by
the kernel wrappers on their first CUDA launch.

Each C entry point takes raw device pointers (``c_void_p``), integer shapes
and the current CUDA stream, launches on that stream without synchronising,
and returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into
an exception naming the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Seconds the last compile in this process took; None if the library was
# already on disk (or not loaded yet).
build_seconds: float | None = None

_vp, _i32, _i64, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "tt_fused_topk_candidates": [
        _vp, _vp, _vp,                           # q (int8 rows: dims permuted), e, scales (null: bf16 rows)
        _vp, _vp, _vp, _vp,                      # part vals/idx, cand vals/idx
        _i32, _i32, _i64,                        # b_pad, d, n_actual
        _i32, _i32, _i32, _i32, _i32, _i32,      # tile_n, m, n_rot, inner, n_ranges, blocks
        _vp,                                     # stream
    ],
    "tt_fused_topk_occupancy": [_i32, _i32, ctypes.POINTER(ctypes.c_int)],  # int8, d, out[2]
    "tt_ivf_probe_scores": [
        _vp, _vp, _vp, _vp, _vp,                 # probe, q, blocks (bf16), valid, out
        _i32, _i32, _i32, _i32,                  # b, nprobe, rpc, d
        _vp,                                     # stream
    ],
    "tt_ivf_group_probes": [
        _vp, _vp, _vp, _vp, _vp,                 # probe, scratch, order, chunks, n_chunks
        _i32, _i32,                              # n_pairs, n_clusters
        _vp,                                     # stream
    ],
    "tt_ivf_probe_scores_int8": [
        _vp, _vp, _vp, _vp,                      # q, blocks (int8), valid, scales
        _vp, _vp, _vp, _vp,                      # order, chunks, n_chunks, out
        _i32, _i32, _i32, _i32,                  # nprobe, n_clusters, rpc, d
        _vp,                                     # stream
    ],
    "tt_transpose_s8": [_vp, _vp, _i32, _i32, _vp],  # b, b^T, k, n, stream
    "tt_tc_matmul": [
        _vp, _vp, _vp,                           # a, b (int8: b^T), out
        _i32, _i32, _i32,                        # m, k, n
        _i32, _i32,                              # int8, n_outer
        _vp,                                     # stream
    ],
    "tt_blocked_attention": [
        _vp, _vp, _vp, _vp, _vp,                 # q, k, v, mask, out
        _i32, _i32, _i32,                        # b, nh, s
        _i64, _i64, _i64,                        # strides of b, h, s (elements)
        _f32,                                    # scale
        _vp,                                     # stream
    ],
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME to a toolkit with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libtt_kernels.so"


def _compile(target: Path) -> None:
    global build_seconds
    target.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    srcs = [src for src in _sources() if src.suffix == ".cu"]
    objs = [target.parent / f"{src.stem}.{tag}.o" for src in srcs]
    tmp = target.with_suffix(f".{tag}.so")
    t0 = time.perf_counter()
    try:
        compiles = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(srcs, objs)]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
                 for cmd in compiles]
        failed = []
        for cmd, proc in procs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        link = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        tmp.replace(target)  # atomic: a concurrent build sees old-or-new
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, compiled first if its sources changed. The first
    load is set-up phase ``kernels`` of ``utils/profiling.py``'s ``SETUP``."""
    global _lib
    with _lock:
        if _lib is None:
            from tensortruth_tpu_torch.utils import profiling

            with profiling.SETUP.phase("kernels"):
                path = library_path()
                if not path.exists():
                    _compile(path)
                lib = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaError_t code)."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch")


def stream_of(tensor) -> int:
    """Handle of PyTorch's current CUDA stream on ``tensor``'s device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
