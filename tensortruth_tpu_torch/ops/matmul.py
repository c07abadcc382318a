"""Matrix products that return float32, as ``preferred_element_type=f32`` does
in the reference.

On CUDA, bf16/fp16 operands go to cuBLAS with a float32 output (f32
accumulation, one rounding at the end). Elsewhere the operands are upcast
first: a product of two bf16 values is exact in float32, so only the order of
the float32 sums differs from the reference.
"""

from __future__ import annotations

import torch

_HALF = (torch.bfloat16, torch.float16)


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
