"""Parity of the port's attention (tensortruth_tpu_torch/ops/attention.py)
with the reference's Pallas ``blocked_attention`` (interpret mode on the CPU)
and its ``attention_reference``.

Inputs are float32 from a seeded numpy generator, with a ragged padding mask
that includes one fully padded row. Tolerance 2e-6 absolute: the same f32
math, summed in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensortruth_tpu.ops import attention as ref
from tensortruth_tpu_torch.ops import attention as port

torch.set_num_threads(1)

ATOL = 2e-6


def _inputs(s, b=3, nh=2, dh=16, seed=0):
    rng = np.random.default_rng(seed + s)
    q, k, v = (rng.standard_normal((b, nh, s, dh)).astype(np.float32) for _ in range(3))
    mask = np.zeros((b, s), np.int32)
    mask[0, :] = 1
    mask[1, : s // 3 + 5] = 1  # ragged
    # row 2 fully padded: uniform average of V, never NaN
    return q, k, v, mask


@pytest.mark.parametrize("s", [256, 512])
def test_plain_blocked_attention_matches_pallas_interpret(s):
    q, k, v, mask = _inputs(s)
    want = np.asarray(ref.blocked_attention(*(jnp.asarray(a) for a in (q, k, v, mask))))
    got = port.blocked_attention(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("s", [256, 512])
def test_attention_reference_matches_reference(s):
    q, k, v, mask = _inputs(s, seed=1)
    want = np.asarray(ref.attention_reference(*(jnp.asarray(a) for a in (q, k, v, mask))))
    got = port.attention_reference(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fully_padded_row_is_mean_of_v():
    q, k, v, mask = _inputs(256, seed=2)
    out = port.blocked_attention(*(torch.from_numpy(a) for a in (q, k, v, mask))).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[2], np.broadcast_to(v[2].mean(axis=1, keepdims=True), out[2].shape), atol=1e-5)


def test_strided_inputs_match_contiguous():
    """The encoder hands (B, S, NH, DH) projections in as transposed views."""
    q, k, v, mask = _inputs(256, seed=3)
    views = [torch.from_numpy(a.transpose(0, 2, 1, 3).copy()).transpose(1, 2) for a in (q, k, v)]
    assert not views[0].is_contiguous()
    got = port.blocked_attention(*views, torch.from_numpy(mask))
    want = port.blocked_attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask))
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_bf16_plain_rounds_p_to_v_dtype():
    """bf16 in, bf16 out, against the reference computed on the same bf16 values
    (loose: bf16 rounds at different places in the two frameworks)."""
    q, k, v, mask = _inputs(256, seed=4)
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(ref.attention_reference(jq, jk, jv, jnp.asarray(mask)).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = port.blocked_attention(tq, tk, tv, torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


def test_sequence_must_be_a_block_multiple():
    q = torch.zeros((1, 1, 300, 16))
    with pytest.raises(ValueError):
        port.blocked_attention(q, q, q, torch.ones((1, 300), dtype=torch.int32))
