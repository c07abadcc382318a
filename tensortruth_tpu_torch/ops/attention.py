"""Padding-masked bidirectional attention for the encoder (kernel B3).

Port of ``tensortruth_tpu/ops/attention.py``. ``blocked_attention`` is exact
softmax attention with an additive -1e9 padding bias and f32 math; a fully
padded row becomes the uniform average of V, never NaN. On CUDA tensors it
launches the hand-written online-softmax kernel (``csrc/attention.cu``) or
raises; only CPU tensors take the plain version, :func:`attention_reference`.
"""

from __future__ import annotations

import math

import torch

from tensortruth_tpu_torch import _build
from tensortruth_tpu_torch.ops.matmul import bmm_f32

BLK_Q = 256  # the reference's query block; S must be a multiple of it
_KERNEL_DH = 64  # csrc/attention.cu is specialised to head dim 64
_KERNEL_MAX_S = 16384  # its per-block table of key tiles holds 256


def attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: full (B, NH, S, S) f32 scores, softmax, p
    rounded to V's dtype, P . V accumulated in f32. Returns q.dtype."""
    b, nh, s, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(torch.float32)
    scores = bmm_f32(q.reshape(b * nh, s, dh), k.reshape(b * nh, s, dh).transpose(1, 2))
    p = torch.softmax(scores.view(b, nh, s, s) * scale + bias, dim=-1).to(q.dtype)
    o = bmm_f32(p.view(b * nh, s, s), v.reshape(b * nh, s, dh))
    return o.view(b, nh, s, dh).to(q.dtype)


def tma_operands(q, k, v):
    """q, k, v as the kernel's 4-D tensor maps take them, with their (batch,
    head, row) strides in elements. TMA takes no zero stride: a broadcast view
    (stride 0 along more than one element) is copied dense first, and a
    dimension of extent 1, whose stride is never used, gets the row stride."""
    b, nh, s, _ = q.shape
    strides = q.stride()[:3]
    if any(st == 0 and n > 1 for st, n in zip(strides, (b, nh, s))):
        q, k, v = (t.contiguous() for t in (q, k, v))
        strides = q.stride()[:3]
    ss = strides[2]
    sb, sh = (st if n > 1 else ss for st, n in zip(strides[:2], (b, nh)))
    return q, k, v, (sb, sh, ss)


def blocked_attention_cuda(q, k, v, mask) -> torch.Tensor:
    """Kernel B3 on the card. Raises on any input the kernel does not take."""
    b, nh, s, dh = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"blocked_attention kernel takes bfloat16, got {name} {t.dtype}")
        if t.shape != q.shape or t.stride() != q.stride():
            raise ValueError("blocked_attention kernel needs q, k, v of one shape and stride")
    if dh != _KERNEL_DH:
        raise ValueError(f"blocked_attention kernel needs head dim {_KERNEL_DH}, got {dh}")
    if s % 64 or s > _KERNEL_MAX_S:
        raise ValueError(f"blocked_attention kernel needs S % 64 == 0 and S <= {_KERNEL_MAX_S}, got {s}")
    sb, sh, ss, sd = q.stride()
    if sd != 1 or sb % 8 or sh % 8 or ss % 8:
        raise ValueError(f"blocked_attention kernel needs a contiguous head dim and 16-byte row strides, got {q.stride()}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("blocked_attention kernel needs 16-byte aligned q, k, v")
    if mask.dtype != torch.int32 or mask.shape != (b, s) or not mask.is_contiguous():
        raise ValueError("blocked_attention kernel needs a contiguous int32 (B, S) mask")
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v, mask)):
        raise ValueError("blocked_attention kernel needs q, k, v and mask on one CUDA device")
    q, k, v, (sb, sh, ss) = tma_operands(q, k, v)
    out = torch.empty((b, nh, s, dh), dtype=q.dtype, device=q.device)
    err = _build.load().tt_blocked_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
        b, nh, s, sb, sh, ss, 1.0 / math.sqrt(dh), _build.stream_of(q),
    )
    _build.check(err, "blocked_attention")
    blocked_attention.launches += 1
    return out


def blocked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """q/k/v (B, NH, S, DH), mask (B, S) 1=real/0=pad -> (B, NH, S, DH) in
    q.dtype. S must be a multiple of ``BLK_Q`` (callers pad via seq buckets)."""
    s = q.shape[2]
    if s % BLK_Q != 0:
        raise ValueError(f"seq {s} must be a multiple of {BLK_Q}")
    if q.is_cuda or k.is_cuda or v.is_cuda or mask.is_cuda:
        return blocked_attention_cuda(q, k, v, mask)
    return attention_reference(q, k, v, mask)


blocked_attention.launches = 0  # kernel launches (CUDA path only)
