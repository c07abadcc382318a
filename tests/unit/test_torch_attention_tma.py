"""The host side of kernel B3's launch (tensortruth_tpu_torch/ops/attention.py
``tma_operands``): the (batch, head, row) strides its 4-D tensor maps are
built from, for every layout the wrapper accepts. Runs on the CPU; the kernel
itself is held against its plain version in test_torch_kernels.py on a card.

The tensor map reads element (b, h, s, d) at base + b*sb + h*sh + s*ss + d, so
each case checks that those strides address exactly the tensor's values, and
that no stride is 0 (TMA takes none).
"""

import numpy as np
import pytest
import torch

from tensortruth_tpu_torch.ops.attention import tma_operands


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(3)]


def _check(views):
    q, k, v, (sb, sh, ss) = tma_operands(*views)
    assert min(sb, sh, ss) > 0
    for got, want in zip((q, k, v), views):
        addressed = torch.as_strided(got, want.shape, (sb, sh, ss, 1), got.storage_offset())
        torch.testing.assert_close(addressed, want, atol=0, rtol=0)
    return q, (sb, sh, ss)


@pytest.mark.parametrize("b,nh,s", [(2, 4, 64), (3, 16, 512), (1, 1, 128)])
def test_contiguous_operands_pass_as_they_are(b, nh, s):
    views = [t.contiguous() for t in _qkv((b, nh, s, 64), seed=s)]
    q, strides = _check(views)
    assert q.data_ptr() == views[0].data_ptr()
    if b > 1 and nh > 1:
        assert strides == views[0].stride()[:3]


@pytest.mark.parametrize("b,nh,s", [(2, 4, 256), (1, 16, 1024), (3, 2, 64)])
def test_the_encoders_transposed_projections_are_not_copied(b, nh, s):
    """models/xlmr.py hands (B, S, NH, DH) projections over as (B, NH, S, DH)
    views: the row stride is NH * DH, the head stride DH."""
    views = [t.transpose(1, 2) for t in _qkv((b, s, nh, 64), seed=s + 1)]
    assert not views[0].is_contiguous()
    q, (sb, sh, ss) = _check(views)
    assert q.data_ptr() == views[0].data_ptr()
    assert ss == nh * 64 and sh == 64 and sb == (s * nh * 64 if b > 1 else ss)


def test_broadcast_views_are_copied_dense():
    """A stride of 0 along more than one element (an expanded head) has no
    tensor map: the operands are made contiguous first."""
    base = _qkv((2, 1, 128, 64), seed=7)
    views = [t.expand(2, 4, 128, 64) for t in base]
    assert views[0].stride()[1] == 0
    q, (sb, sh, ss) = _check(views)
    assert q.is_contiguous() and (sb, sh, ss) == (4 * 128 * 64, 128 * 64, 64)


def test_dimensions_of_extent_one_take_the_row_stride():
    """The stride of a dimension of extent 1 is never used to step, whatever
    it is; a map gets the row stride there."""
    base = _qkv((3, 128, 64), seed=9)
    views = [torch.as_strided(t, (1, 3, 128, 64), (0, 128 * 64, 64, 1)) for t in base]
    q, (sb, sh, ss) = _check(views)
    assert q.data_ptr() == views[0].data_ptr() and sb == ss == 64 and sh == 128 * 64
