"""Probe: does an int8 product on the H100's tensor cores run 1.6x a bf16 one
at the reranker's FFN shape?

    python -m tensortruth_tpu_torch.scripts.probe_int8_mma    # needs one CUDA card

Counterpart of ``scripts/probe_int8_mxu_pallas.py``, the JAX package's probe
of the TPU's int8 matrix unit. The question is the same: would a quantized
cross-encoder (weights quantized at load, activations in the preceding
kernel) pay? The H100's dense peaks are 989 TFLOP/s bf16 and 1,979 TOPS int8,
but at this shape the int32 output (256 MiB) bounds the int8 product by
memory, and the best ratio the shape allows is 1.61x (``csrc/tc_matmul.cu``).

Shape: the reranker FFN's hot product, M = B*S = 16384, K = 1024, N = 4096,
from the reference's inputs (``np.random.default_rng(0)``, N(0, 1), and
``clip(x * 20, -127, 127)`` for int8). Each variant is timed with CUDA events
over ITERS back-to-back launches after one warm-up launch, the counterpart of
the reference's chained loop inside one jit.

Variants, all kernel B5 (``ops/matmul.py::tc_matmul``):
  tc_bf16        bf16 in / f32 out, output tiles M-tile-major
  tc_int8        int8 in / int32 out, the same order
  tc_bf16_resB   bf16, N-tile-major (the reference's resident-B order)
  tc_int8_resB   int8, N-tile-major
The reference's XLA variants and its TPU tile sizes have no counterpart; the
library products (cuBLAS) are timed beside the kernel by ``chip_smoke.py``.

Decision rule (the reference's): tc_int8 at least 1.6x tc_bf16 in TOPS ->
build the quantized rerank path; otherwise record the rejection. Unlike the
reference, which reports a failing variant and goes on, a failure here raises.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tensortruth_tpu_torch.ops.matmul import tc_matmul

M, K, N = 16384, 1024, 4096
ITERS = 32
FLOPS = 2 * M * K * N
DECISION_RATIO = 1.6
VARIANTS = {  # name: (operand type, n_outer)
    "tc_bf16": ("bf16", False),
    "tc_int8": ("int8", False),
    "tc_bf16_resB": ("bf16", True),
    "tc_int8_resB": ("int8", True),
}


def make_inputs(m: int = M, k: int = K, n: int = N, device="cuda") -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """The reference probe's operands: {"bf16": (a, b), "int8": (a, b)}."""
    rng = np.random.default_rng(0)
    a_f = rng.standard_normal((m, k), dtype=np.float32)
    b_f = rng.standard_normal((k, n), dtype=np.float32)
    out = {}
    for name, (a, b) in (("bf16", (a_f, b_f)),
                         ("int8", (np.clip(a_f * 20, -127, 127).astype(np.int8),
                                   np.clip(b_f * 20, -127, 127).astype(np.int8)))):
        dtype = torch.bfloat16 if name == "bf16" else torch.int8
        out[name] = tuple(torch.from_numpy(x).to(dtype).to(device) for x in (a, b))
    return out


def _device_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def run(device="cuda", iters: int = ITERS) -> dict:
    """Time every variant on ``device`` (a CUDA device: the probe measures the
    card and has no CPU fallback), print one line each and the decision, and
    return them."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"the int8 probe times a CUDA card, not {device}")
    inputs = make_inputs(device=device)
    variants = {}
    print(f"device={torch.cuda.get_device_name(device)} shape=({M},{K})x({K},{N}) iters={iters}", flush=True)
    for name, (operands, n_outer) in VARIANTS.items():
        a, b = inputs[operands]
        ms = _device_ms(lambda: tc_matmul(a, b, n_outer=n_outer), iters)
        tops = FLOPS / ms / 1e9
        variants[name] = {"ms": ms, "tops": tops}
        print(f"{name:14s} {ms:8.4f} ms/matmul  {tops:7.1f} TOPS", flush=True)
    ratio = variants["tc_int8"]["tops"] / variants["tc_bf16"]["tops"]
    pays = ratio >= DECISION_RATIO
    print(f"int8 / bf16 = {ratio:.3f}x (rule: >= {DECISION_RATIO}x): "
          f"{'build the quantized rerank path' if pays else 'a quantized rerank path does not pay'}", flush=True)
    return {"device": torch.cuda.get_device_name(device), "shape": [M, K, N], "iters": iters,
            "variants": variants, "int8_over_bf16": ratio, "quantized_rerank_pays": pays}


if __name__ == "__main__":
    print(json.dumps(run()))
