"""The port's hand-written CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU and nvcc (the kernels have no CPU mode) and skip
elsewhere. Run them on a GPU machine with

    python -m pytest tests/unit/test_torch_kernels.py -m requires_cuda -q

Tolerances: kernels B1 and B2 (fused top-k over bf16 / int8 rows) and their
plain versions both sum exact bf16 products in float32 (B2 then applies one
f32 row scale), so values agree within 1e-4 and indices may differ only where
the two scores at that rank are within it; integer-valued inputs make every
score exact and then the results must be identical. Kernel B4 (IVF probe
scores, bf16 and int8 blocks) agrees within 1e-4 with -inf exactly on the
padding slots. Kernel B3
(attention) agrees within 2e-2 absolute on N(0, 1) inputs: both round the
output to bf16, and they round the softmax weights at different points.
Kernel B5 (tensor-core product): int8 -> int32 is bit-exact, at the extremes of
the int8 range too; bf16 -> f32
agrees within 1e-3 absolute on N(0, 1) inputs (f32 sums of exact products in
other orders, outputs up to about 6 * sqrt(K)).
"""

import pytest
import torch

from tensortruth_tpu_torch.ops.attention import attention_reference, blocked_attention, blocked_attention_cuda
from tensortruth_tpu_torch.ops.ivf import probe_scores, probe_scores_plain
from tensortruth_tpu_torch.ops.matmul import tc_matmul, tc_matmul_plain
from tensortruth_tpu_torch.ops.topk import (
    fused_topk,
    fused_topk_int8,
    fused_topk_int8_plain,
    fused_topk_plain,
)

pytestmark = pytest.mark.requires_cuda

TOPK_TOL = 1e-4
ATTN_TOL = 2e-2
MATMUL_TOL = 1e-3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _unit(gen, n, d):
    x = torch.randn((n, d), generator=gen, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize(
    "b,n,d,k,m,c_out,n_actual",
    [
        (1, 5000, 64, 10, 1, 2048, 5000),       # one query padded to a block
        (5, 70_000, 128, 100, 1, 2048, 69_001),  # ragged n_actual inside a tile
        (33, 20_000, 1024, 50, 2, 2048, 20_000),  # m = 2, two query blocks
        (8, 40_960, 256, 30, 1, 8192, 40_960),   # n_rot = 4
        (3, 3000, 64, 500, 1, 2048, 300),        # k > n_actual: -inf / -1 padding
    ],
)
def test_fused_topk_kernel_matches_plain(gen, b, n, d, k, m, c_out, n_actual):
    q, e = _unit(gen, b, d), _unit(gen, n, d)
    vals, idx = fused_topk(q, e, k, m=m, c_out=c_out, n_actual=n_actual)
    pvals, pidx = fused_topk_plain(q, e, k, m=m, c_out=c_out, n_actual=n_actual)
    torch.cuda.synchronize()
    finite = torch.isfinite(pvals)
    assert torch.equal(finite, torch.isfinite(vals))
    assert torch.equal(idx[~finite], pidx[~finite])
    diff = (vals[finite] - pvals[finite]).abs()
    assert diff.max().item() <= TOPK_TOL
    assert not ((idx[finite] != pidx[finite]) & (diff > TOPK_TOL)).any()


def test_fused_topk_kernel_planted_ties_exact(gen):
    q = torch.randint(-2, 3, (7, 64), generator=gen, device="cuda").to(torch.bfloat16)
    e = torch.randint(-2, 3, (3000, 64), generator=gen, device="cuda").to(torch.bfloat16).repeat(3, 1)
    for m in (1, 2):
        got = fused_topk(q, e, 80, m=m, n_actual=8900)
        want = fused_topk_plain(q, e, 80, m=m, n_actual=8900)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fused_topk_counts_launches(gen):
    before = fused_topk.launches
    fused_topk(_unit(gen, 2, 64), _unit(gen, 4096, 64), 5)
    assert fused_topk.launches == before + 1


def _int8_rows(gen, n, d):
    """quantize_corpus of unit rows, on the card: int8 rows + f32 scales."""
    x = _unit(gen, n, d).float()
    scales = x.abs().amax(dim=1) / 127.0
    return torch.round(x / scales[:, None]).clamp(-127, 127).to(torch.int8), scales


def _assert_topk_close(got, want):
    (vals, idx), (pvals, pidx) = got, want
    finite = torch.isfinite(pvals)
    assert torch.equal(finite, torch.isfinite(vals))
    assert torch.equal(idx[~finite], pidx[~finite])
    diff = (vals[finite] - pvals[finite]).abs()
    assert diff.max().item() <= TOPK_TOL
    assert not ((idx[finite] != pidx[finite]) & (diff > TOPK_TOL)).any()


@pytest.mark.parametrize(
    "b,n,d,k,m,c_out,n_actual",
    [
        (1, 700, 64, 10, 1, 2048, 650),          # one tile, below the bf16 tier's exact cut-over
        (5, 70_000, 128, 100, 1, 2048, 69_001),  # ragged n_actual inside a tile
        (33, 20_000, 1024, 50, 2, 2048, 20_000),  # m = 2, two query blocks
        (8, 40_960, 256, 30, 1, 8192, 40_960),   # n_rot = 4
        (3, 3000, 64, 500, 1, 2048, 300),        # k > n_actual: -inf / -1 padding
        (2, 2048, 16, 10, 1, 2048, 2048),        # D = 16: one 16-dim k-step; a corpus of one tile
        (5, 9000, 80, 50, 1, 2048, 8990),        # ragged D; n_actual ends inside a 64-row step
        (33, 10_000, 2048, 40, 1, 2048, 9_999),  # the widest D; two query blocks
        (4, 300_000, 1024, 100, 1, 2048, 299_500),  # many ranges: the persistent walk wraps
    ],
)
def test_fused_topk_int8_kernel_matches_plain(gen, b, n, d, k, m, c_out, n_actual):
    q = _unit(gen, b, d)
    e_q, scales = _int8_rows(gen, n, d)
    got = fused_topk_int8(q, e_q, scales, k, m=m, c_out=c_out, n_actual=n_actual)
    want = fused_topk_int8_plain(q, e_q, scales, k, m=m, c_out=c_out, n_actual=n_actual)
    torch.cuda.synchronize()
    _assert_topk_close(got, want)


def test_fused_topk_int8_kernel_planted_ties_exact(gen):
    q = torch.randint(-2, 3, (7, 64), generator=gen, device="cuda").to(torch.bfloat16)
    e_q = torch.randint(-2, 3, (3000, 64), generator=gen, device="cuda").to(torch.int8).repeat(3, 1)
    scales = torch.ones(e_q.shape[0], device="cuda")
    before = fused_topk_int8.launches
    for m in (1, 2):
        got = fused_topk_int8(q, e_q, scales, 80, m=m, n_actual=8900)
        want = fused_topk_int8_plain(q, e_q, scales, 80, m=m, n_actual=8900)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fused_topk_int8.launches == before + 2


@pytest.mark.parametrize("m,c_out", [(1, 8192), (2, 4096)])
def test_fused_topk_int8_kernel_planted_ties_n_rot4(gen, m, c_out):
    """Ties across candidate blocks (n_rot = 4) and segments; 33 queries."""
    q = torch.randint(-2, 3, (33, 80), generator=gen, device="cuda").to(torch.bfloat16)
    e_q = torch.randint(-2, 3, (3000, 80), generator=gen, device="cuda").to(torch.int8).repeat(3, 1)
    scales = torch.ones(e_q.shape[0], device="cuda")
    got = fused_topk_int8(q, e_q, scales, 80, m=m, c_out=c_out, n_actual=8900)
    want = fused_topk_int8_plain(q, e_q, scales, 80, m=m, c_out=c_out, n_actual=8900)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,nprobe,n_clusters,rpc,d", [(3, 4, 16, 384, 64), (32, 8, 64, 1280, 1024), (1, 1, 2, 128, 16)])
def test_probe_kernel_matches_plain(gen, int8, b, nprobe, n_clusters, rpc, d):
    q = _unit(gen, b, d)
    if int8:
        blocks, scales = _int8_rows(gen, n_clusters * rpc, d)
        blocks, scales = blocks.view(n_clusters, rpc, d), scales.view(n_clusters, rpc)
    else:
        blocks, scales = _unit(gen, n_clusters * rpc, d).view(n_clusters, rpc, d), None
    valid = (torch.rand((n_clusters, rpc), generator=gen, device="cuda") > 0.3).to(torch.int32)
    probe = torch.randint(0, n_clusters, (b, nprobe), generator=gen, device="cuda", dtype=torch.int32)
    probe[:, 0] = probe[0, 0].item()  # a cluster every query probes
    counter = "launches_int8" if int8 else "launches"
    before = getattr(probe_scores, counter)
    got = probe_scores(probe, q, blocks, valid, scales)
    want = probe_scores_plain(probe, q, blocks, valid, scales)
    torch.cuda.synchronize()
    assert getattr(probe_scores, counter) == before + 1
    pad = valid[probe.long()] == 0
    assert torch.isneginf(got[pad]).all() and torch.isfinite(got[~pad]).all()
    assert (got[~pad] - want[~pad]).abs().max().item() <= TOPK_TOL


@pytest.mark.parametrize("b,nh,s", [(2, 3, 256), (3, 16, 512), (1, 2, 2048)])
def test_attention_kernel_matches_plain(gen, b, nh, s):
    q, k, v = (torch.randn((b, nh, s, 64), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
    lengths[-1] = 0  # a fully padded row
    mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
    out = blocked_attention(q, k, v, mask)
    ref = attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= ATTN_TOL


@pytest.mark.parametrize(
    "b,nh,s",
    [
        (2, 2, 64),      # one 64-row query tile: a block with one consumer warpgroup
        (3, 2, 192),     # a full 128-row tile and a 64-row one
        (3, 4, 256),
        (3, 1, 16384),   # the longest S the kernel takes: 256 key tiles
    ],
)
def test_attention_kernel_edges(gen, b, nh, s):
    """Row 0's only real keys sit in the last key tile, row 1 is ragged, the
    last row is fully padded."""
    q, k, v = (torch.randn((b, nh, s, 64), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    mask = torch.zeros((b, s), dtype=torch.int32, device="cuda")
    mask[0, -3:] = 1
    if b > 2:
        mask[1, : s // 2 + 5] = 1
    before = blocked_attention.launches
    out = blocked_attention_cuda(q, k, v, mask)
    ref = attention_reference(q, k, v, mask)
    torch.cuda.synchronize()
    assert blocked_attention.launches == before + 1
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= ATTN_TOL
    uniform = v[-1].float().mean(dim=1, keepdim=True).expand(nh, s, 64)
    assert (out[-1].float() - uniform).abs().max().item() <= ATTN_TOL


def test_attention_kernel_takes_transposed_projections(gen):
    """The encoder passes (B, S, NH, DH) projections as (B, NH, S, DH) views."""
    b, s, nh = 2, 512, 4
    q, k, v = (torch.randn((b, s, nh, 64), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    mask = torch.ones((b, s), dtype=torch.int32, device="cuda")
    mask[1, 300:] = 0
    got = blocked_attention(q, k, v, mask)
    want = blocked_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("n_outer", [False, True])
@pytest.mark.parametrize("m,k,n", [(128, 64, 128), (384, 1024, 256), (1024, 192, 640)])
def test_tc_matmul_kernel_matches_plain(gen, int8, n_outer, m, k, n):
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    if int8:  # the full int8 range, -128 included
        a, b = (torch.clamp(x * 40, -128, 127).to(torch.int8) for x in (a, b))
    else:
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    counter = "launches_int8" if int8 else "launches"
    before = getattr(tc_matmul, counter)
    got = tc_matmul(a, b, n_outer=n_outer)
    want = tc_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert getattr(tc_matmul, counter) == before + 1
    assert got.dtype == want.dtype and got.shape == (m, n)
    if int8:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= MATMUL_TOL


@pytest.mark.parametrize("n_outer", [False, True])
@pytest.mark.parametrize(
    "m,k,n",
    [
        (128, 64, 256),     # one 128x256 tile, K of one stage
        (256, 32, 128),     # K of half a stage (zeros past the end), N half a tile
        (640, 320, 384),    # K of 5 stages (not a multiple of the ring's 4), N one and a half tiles
        (2048, 1024, 2304), # 144 tiles: more than one SM's worth, the persistent walk wraps
    ],
)
def test_tc_matmul_bf16_kernel_edges(gen, n_outer, m, k, n):
    a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn((k, n), generator=gen, device="cuda").to(torch.bfloat16)
    got = tc_matmul(a, b, n_outer=n_outer)
    want = tc_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert got.shape == (m, n)
    assert (got - want).abs().max().item() <= MATMUL_TOL


@pytest.mark.parametrize("n_outer", [False, True])
@pytest.mark.parametrize(
    "m,k,n",
    [
        (128, 64, 128),     # K of half a 128-byte slice (zeros past the end), one 128 x 128 tile
        (256, 192, 640),    # a last slice of 64 bytes; N of five tiles (a bf16 half tile's width)
        (384, 1024, 256),
        (2048, 1024, 2304), # 288 tiles: more than one SM's worth, the persistent walk wraps
    ],
)
def test_tc_matmul_int8_kernel_edges(gen, n_outer, m, k, n):
    """Bit-exact at the int8 extremes: rows and columns of 127 and -128 make
    sums of +-K * 2**14."""
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    a[0], a[1], b[:, 0], b[:, 1] = 127, -128, -128, 127
    before = tc_matmul.launches_int8
    got = tc_matmul(a, b, n_outer=n_outer)
    want = tc_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert tc_matmul.launches_int8 == before + 1
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert got[1, 0].item() == k * 128 * 128
    assert torch.equal(got, want)
