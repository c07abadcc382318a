"""Matrix products that return float32, as ``preferred_element_type=f32`` does
in the reference, and kernel B5, the tensor-core product of the int8 probe.

``mm_f32`` / ``bmm_f32``: on CUDA, bf16/fp16 operands go to cuBLAS with a
float32 output (f32 accumulation, one rounding at the end). Elsewhere the
operands are upcast first: a product of two bf16 values is exact in float32,
so only the order of the float32 sums differs from the reference.

``tc_matmul``: port of ``scripts/probe_int8_mxu_pallas.py::pallas_matmul``,
bf16 -> f32 or int8 -> int32 over the whole K, on the hand-written kernel
``csrc/tc_matmul.cu`` for CUDA tensors and on :func:`tc_matmul_plain` for CPU
tensors.
"""

from __future__ import annotations

import torch

from tensortruth_tpu_torch import _build

_HALF = (torch.bfloat16, torch.float16)
# csrc/tc_matmul.cu: M and N in steps of 128 (tiles of 128 x 256 bf16, with
# a half tile at N's end, or 128 x 128 int8), K in steps of 64 bytes of an a
# row (TMA zero-fills the rest of a 128-byte slice).
_TC_TILE = 128
_TC_SLICE_BYTES = 64
_TC_OUT = {torch.bfloat16: torch.float32, torch.int8: torch.int32}


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) float32."""
    if a.is_cuda and a.dtype in _HALF:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(G, M, K) @ (G, K, N) -> (G, M, N) float32."""
    if a.is_cuda and a.dtype in _HALF:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def tc_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`tc_matmul` (what the kernel is held
    against), on any device: bf16 operands multiply in float32 (each product
    exact), int8 operands in float64 and round to int32, which is exact:
    |sum| <= 128 * 128 * K stays far below 2**53."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def transpose_int8_cuda(b: torch.Tensor) -> torch.Tensor:
    """b^T of a contiguous (K, N) int8 CUDA matrix, K and N multiples of 64,
    as a new contiguous (N, K) tensor: the K-major B operand that 8-bit wgmma
    takes, written by the small kernel beside B5 (``tt_transpose_s8``). Part
    of every int8 :func:`tc_matmul` launch."""
    k, n = b.shape
    b_t = torch.empty((n, k), dtype=torch.int8, device=b.device)
    _build.check(_build.load().tt_transpose_s8(b.data_ptr(), b_t.data_ptr(), k, n, _build.stream_of(b)),
                 "tc_matmul_int8 transpose")
    return b_t


def tc_matmul_cuda(a: torch.Tensor, b: torch.Tensor, *, n_outer: bool = False) -> torch.Tensor:
    """Kernel B5 on the card: same contract as :func:`tc_matmul_plain`.
    Raises on any input the kernel does not take."""
    if a.dtype not in _TC_OUT or b.dtype != a.dtype:
        raise TypeError(f"tc_matmul kernel takes two bfloat16 or two int8 operands, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tc_matmul shapes {tuple(a.shape)} x {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    k_step = _TC_SLICE_BYTES // a.element_size()
    if m % _TC_TILE or n % _TC_TILE or k % k_step:
        raise ValueError(
            f"tc_matmul kernel needs M and N multiples of {_TC_TILE} and K a multiple of {k_step}, "
            f"got M={m}, K={k}, N={n}"
        )
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"tc_matmul kernel needs both operands on one CUDA device, got {a.device}, {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("tc_matmul kernel needs contiguous (row-major) operands")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("tc_matmul kernel needs 16-byte aligned operands")
    int8 = a.dtype == torch.int8
    out = torch.empty((m, n), dtype=_TC_OUT[a.dtype], device=a.device)
    err = _build.load().tt_tc_matmul(
        a.data_ptr(), transpose_int8_cuda(b).data_ptr() if int8 else b.data_ptr(), out.data_ptr(), m, k, n,
        int(int8), int(n_outer), _build.stream_of(a),
    )
    _build.check(err, "tc_matmul_int8" if int8 else "tc_matmul")
    if int8:
        tc_matmul.launches_int8 += 1
    else:
        tc_matmul.launches += 1
    return out


def tc_matmul(a: torch.Tensor, b: torch.Tensor, *, n_outer: bool = False) -> torch.Tensor:
    """(M, K) @ (K, N): bf16 -> float32, int8 -> int32, summed over the
    whole K. ``n_outer`` walks the output tiles N-tile-major (the reference's
    resident-b grid order); it changes no result. On CUDA tensors this
    launches kernel B5; on CPU tensors it runs the plain version."""
    if a.is_cuda or b.is_cuda:
        return tc_matmul_cuda(a, b, n_outer=n_outer)
    return tc_matmul_plain(a, b)


tc_matmul.launches = 0  # kernel launches over bf16 operands (CUDA path only)
tc_matmul.launches_int8 = 0  # kernel launches over int8 operands (CUDA path only)
