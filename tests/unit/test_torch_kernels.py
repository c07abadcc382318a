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
padding slots, and bit for bit on integer-valued rows at scale 1; its
grouping of the (query, probe) pairs over int8 blocks matches the plain
grouping up to the order of the pairs within a cluster. Kernel B3
(attention) agrees within 2e-2 absolute on N(0, 1) inputs: both round the
output to bf16, and they round the softmax weights at different points.
Kernel B5 (tensor-core product): int8 -> int32 is bit-exact, at the extremes of
the int8 range too; bf16 -> f32
agrees within 1e-3 absolute on N(0, 1) inputs (f32 sums of exact products in
other orders, outputs up to about 6 * sqrt(K)).

On a mesh whose slots all sit on this card, B1 and B2 run once per shard
that holds a valid row and B4 (over int8 blocks with its grouping kernel) once per shard; each
sharded search is held, with the same tolerances, against the same sharding
run through the plain versions.

Then the embedder and the reranker are held on the card to their promise of
no stream synchronise between the batches they launch, and the port's
``build_module`` builds on the card the index it builds on the CPU: the same
nodes and rows, embeddings within 2e-2 (a tiny model in bf16 on the card
against f32 on the CPU; unit-norm rows), with kernel B3 launched when the
leaves reach 512 tokens.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tensortruth_tpu_torch.models.embedder import Embedder
from tensortruth_tpu_torch.models.manager import _EMBEDDER_ARCHS, _RERANKER_ARCHS
from tensortruth_tpu_torch.models.reranker import Reranker
from tensortruth_tpu_torch.ops.attention import attention_reference, blocked_attention, blocked_attention_cuda
from tensortruth_tpu_torch.ops.ivf import (
    build_ivf,
    group_probes,
    group_probes_plain,
    ivf_search_sharded,
    probe_scores,
    probe_scores_plain,
    shard_ivf,
)
from tensortruth_tpu_torch.ops.matmul import tc_matmul, tc_matmul_plain
from tensortruth_tpu_torch.ops.topk import (
    fused_topk,
    fused_topk_int8,
    fused_topk_int8_plain,
    fused_topk_plain,
)
from tensortruth_tpu_torch.parallel import make_mesh, shard_corpus, sharded_topk
from tensortruth_tpu_torch.parallel.sharded_topk import shard_corpus_int8
from tensortruth_tpu_torch.tokenization import SimpleTokenizer

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


@pytest.mark.parametrize("m,c_out", [(1, 8192), (2, 4096)])
def test_fused_topk_kernel_planted_ties_n_rot4(gen, m, c_out):
    """Ties across candidate blocks (n_rot = 4) and segments; 33 queries; a
    D of one and a quarter 64-dim boxes."""
    q = torch.randint(-2, 3, (33, 80), generator=gen, device="cuda").to(torch.bfloat16)
    e = torch.randint(-2, 3, (3000, 80), generator=gen, device="cuda").to(torch.bfloat16).repeat(3, 1)
    got = fused_topk(q, e, 80, m=m, c_out=c_out, n_actual=8900)
    want = fused_topk_plain(q, e, 80, m=m, c_out=c_out, n_actual=8900)
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


def _probe_case(gen, case):
    """(probe, q, blocks, valid, scales) of an int8-block probe case."""
    b, nprobe, n_clusters, rpc, d = {"over32": (40, 4, 16, 256, 128), "rpc_ragged": (6, 5, 9, 200, 80),
                                     "integer": (32, 8, 40, 320, 1024)}.get(case, (8, 6, 12, 256, 64))
    if case == "integer":  # every score exact in f32, whatever the order of the sums
        q = torch.randint(-3, 4, (b, d), generator=gen, device="cuda").to(torch.bfloat16)
        blocks = torch.randint(-127, 128, (n_clusters, rpc, d), generator=gen, device="cuda", dtype=torch.int8)
        scales = torch.ones((n_clusters, rpc), device="cuda")
    else:
        q = _unit(gen, b, d)
        blocks, scales = _int8_rows(gen, n_clusters * rpc, d)
        blocks, scales = blocks.view(n_clusters, rpc, d), scales.view(n_clusters, rpc)
    valid = (torch.rand((n_clusters, rpc), generator=gen, device="cuda") > 0.3).to(torch.int32)
    probe = torch.randint(0, n_clusters, (b, nprobe), generator=gen, device="cuda", dtype=torch.int32)
    if case == "twice":  # one query names a cluster twice, another three times
        probe[0, 1] = probe[0, 0]
        probe[3, 1:4] = probe[3, 0]
    elif case == "over32":  # one cluster named by 80 pairs: three chunks
        probe[:, 0] = probe[:, 2] = 5
    elif case == "all_invalid":
        valid[probe[0, 0].long()] = 0
        valid[probe[2, 3].long(), :64] = 0  # and a whole first step of another
    elif case == "prefix":  # build_ivf fills slots from 0: empty, part-filled and full clusters
        fill = torch.randint(0, rpc + 1, (n_clusters, 1), generator=gen, device="cuda")
        fill[0], fill[1] = 0, rpc
        probe[0, :2] = torch.tensor([0, 1], device="cuda", dtype=torch.int32)
        valid = (torch.arange(rpc, device="cuda")[None, :] < fill).to(torch.int32)
    return probe, q, blocks, valid, scales


@pytest.mark.parametrize("case", ["twice", "over32", "all_invalid", "prefix", "rpc_ragged", "integer"])
def test_probe_int8_kernel_cases(gen, case):
    probe, q, blocks, valid, scales = _probe_case(gen, case)
    before = probe_scores.launches_int8
    got = probe_scores(probe, q, blocks, valid, scales)
    want = probe_scores_plain(probe, q, blocks, valid, scales)
    torch.cuda.synchronize()
    assert probe_scores.launches_int8 == before + 1
    pad = valid[probe.long()] == 0
    assert torch.equal(torch.isneginf(got), pad) and torch.isfinite(got[~pad]).all()
    if case == "integer":
        assert torch.equal(got, want)
    else:
        assert (got[~pad] - want[~pad]).abs().max().item() <= TOPK_TOL


@pytest.mark.parametrize("b,nprobe,n_clusters", [(1, 1, 2), (32, 32, 1024), (40, 4, 16), (7, 9, 3000)])
def test_group_probes_kernel_matches_plain(gen, b, nprobe, n_clusters):
    """The chunks are the plain grouping's exactly; the pairs of each cluster
    are the same set (their order within a cluster is not fixed)."""
    probe = torch.randint(0, n_clusters, (b, nprobe), generator=gen, device="cuda", dtype=torch.int32)
    probe[:, 0] = probe[0, 0].item()
    order, chunks, n_chunks = (x.cpu() for x in group_probes(probe, n_clusters))
    p_order, p_chunks, p_n = (x.cpu() for x in group_probes_plain(probe, n_clusters))
    n = int(n_chunks[0])
    assert n == int(p_n[0]) and torch.equal(chunks[:n], p_chunks[:n])
    for cluster in chunks[:n, 0].unique().tolist():
        rows = chunks[:n][chunks[:n, 0] == cluster]
        lo, hi = int(rows[0, 1]), int(rows[-1, 1] + rows[-1, 2])
        assert set(order[lo:hi].tolist()) == set(p_order[lo:hi].tolist())


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


def _syncs(prof, names=("cudaStreamSynchronize",)) -> int:
    return sum(e.name in names for e in prof.events())


# -- the kernels per shard of a mesh whose slots all sit on this card ------------


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("q_sharded", [False, True])
def test_sharded_topk_kernels_match_plain_on_a_repeated_device_mesh(gen, int8, q_sharded):
    """B1 / B2 on each shard of a 2 x 4 mesh over one card, against the same
    sharding through the plain versions. 5000 rows over 4 shards of 2048:
    shard 2 is partly valid and shard 3 holds only padding (no launch)."""
    mesh = make_mesh(n_shards=4, n_data=2, devices=["cuda"] * 8)
    rows = _unit(gen, 5000, 64)
    corpus = (shard_corpus_int8(rows.float().cpu(), mesh, tile_n=2048) if int8
              else shard_corpus(rows.cpu(), mesh, tile_n=2048))[0]
    assert all(len(by_dev) == 1 for by_dev in corpus.parts.values())  # one buffer per shard
    q = _unit(gen, 4, 64)
    counter = fused_topk_int8 if int8 else fused_topk
    before = counter.launches
    kw = dict(k=20, n_actual=5000, use_fused=True, q_sharded=q_sharded)
    got = sharded_topk(q, corpus, **kw)
    assert counter.launches - before == 3 * (2 if q_sharded else 1)
    _assert_topk_close(got, sharded_topk(q, corpus, plain=True, **kw))
    assert int(got[1].max()) < 5000


@pytest.mark.parametrize("int8", [False, True])
def test_sharded_ivf_kernels_match_plain_on_a_repeated_device_mesh(gen, int8):
    """B4 (and, over int8 blocks, its grouping kernel) on each shard's own
    clusters, 12 clusters padded to 16 over 4 shards, against the plain
    probe of every shard."""
    rows = _unit(gen, 4000, 64).float().cpu().numpy()
    index = build_ivf(rows, n_clusters=12, sample_size=4000, block_dtype=torch.int8 if int8 else torch.bfloat16,
                      device="cuda", device_blocks=False)
    sidx = shard_ivf(index, make_mesh(n_shards=4, devices=["cuda"] * 4))
    q = rows[:32]
    before = (probe_scores.launches, probe_scores.launches_int8, group_probes.launches)
    vals, ids = ivf_search_sharded(sidx, q, 10, nprobe=2)
    after = (probe_scores.launches, probe_scores.launches_int8, group_probes.launches)
    assert [a - b for a, b in zip(after, before)] == ([0, 4, 4] if int8 else [4, 0, 0])
    pvals, pids = ivf_search_sharded(sidx, q, 10, nprobe=2, plain=True)
    _assert_topk_close(*[tuple(map(torch.from_numpy, pair)) for pair in ((vals, ids), (pvals, pids))])
    assert (ids[:, 0] == np.arange(32)).mean() >= 0.9  # rows as queries find themselves


@pytest.mark.parametrize("block_dtype", [torch.bfloat16, torch.int8])
def test_build_ivf_device_scatter_equals_host_fill(gen, block_dtype):
    """262,144 x 1024 f32 rows, 256 clusters: the blocks staged by the
    assignment pass and scattered once on the card equal the host fill
    (``device_blocks=False``) bit for bit, blocks, scales and row_map; the
    build's peak device memory stays within the blocks, the staging and one
    f32 assignment chunk, plus 10%."""
    n, d, nc, chunk = 262_144, 1024, 256, 262_144
    x = torch.randn((n, d), generator=gen, device="cuda")
    rows = (x / x.norm(dim=1, keepdim=True)).cpu().numpy()
    del x
    kw = dict(n_clusters=nc, sample_size=65_536, kmeans_iters=3, seed=0, block_dtype=block_dtype, device="cuda")
    host = build_ivf(rows, device_blocks=False, **kw)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    dev = build_ivf(rows, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert list(dev.build_seconds) == ["sample", "kmeans", "assign", "place", "scatter"]
    assert torch.equal(dev.centroids.cpu(), host.centroids.cpu())
    np.testing.assert_array_equal(dev.row_map, host.row_map)
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    assert torch.equal(dev.blocks.cpu().view(bits[dev.blocks.element_size()]),
                       host.blocks.view(bits[host.blocks.element_size()]))
    staging = n * d * dev.blocks.element_size()
    if block_dtype == torch.int8:
        assert torch.equal(dev.scales.cpu().view(torch.int32), host.scales.view(torch.int32))
        staging += n * 4
    blocks = dev.blocks.numel() * dev.blocks.element_size()
    budget = 1.1 * (blocks + staging + chunk * d * 4)
    print(json.dumps({"ivf_build": str(block_dtype), "peak_bytes": peak, "budget_bytes": int(budget),
                      "device_seconds": dev.build_seconds, "host_seconds": host.build_seconds}))
    assert peak <= budget, (peak, budget)


def test_reranker_launches_its_groups_without_a_stream_sync(gen):
    """Four groups (two sequence buckets, each cut into two batch buckets):
    score_pairs_async queues them all without a cudaStreamSynchronize, and
    its scores match those of a call that waited."""
    tok = SimpleTokenizer(vocab_size=512)
    reranker = Reranker.random_init(_RERANKER_ARCHS["tiny-reranker"], tok, "cuda", dtype=torch.float32,
                                    max_length=128)
    pairs = [(f"question {i}", f"short passage {i}") for i in range(130)]
    pairs += [(f"question {i}", " ".join(f"word{j}" for j in range(90))) for i in range(20)]
    lengths = tok.encode_batch([q for q, _ in pairs], 128, pair=[d for _, d in pairs])[1].sum(axis=1)
    assert len(reranker._groups(lengths)) >= 3
    want = reranker.score_pairs(pairs)  # warm: the pinned blocks and the kernels exist
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        finish = reranker.score_pairs_async(pairs)
    got = finish()
    assert _syncs(prof) == 0
    assert (got == want).all()


def test_embedder_waits_once_per_slab(gen):
    """Two slabs of 2048 texts at most: no stream synchronise, and the host
    waits on one event a slab (the profiler's own device synchronise as it
    stops is not counted)."""
    tok = SimpleTokenizer(vocab_size=512)
    embedder = Embedder.random_init(_EMBEDDER_ARCHS["tiny-embedder"], tok, "cuda", dtype=torch.float32,
                                    max_length=128)
    texts = [f"text {i} " + "word " * (i % 50) for i in range(2100)]
    want = embedder.encode(texts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = embedder.encode(texts)
    assert _syncs(prof) == 0
    assert _syncs(prof, ("cudaStreamSynchronize", "cudaEventSynchronize")) <= 2
    assert got.shape == (2100, 64) and (got == want).all()


def _write_docs(root, words: int) -> None:
    """Three docs of sentences over a 300-word vocabulary, from a seed."""
    rng = np.random.default_rng(3)
    vocab = [f"w{i}" for i in range(300)]
    docs = root / "library_gamma"
    docs.mkdir(parents=True)
    for d in range(3):
        sents = [" ".join(rng.choice(vocab, 12)).capitalize() + "." for _ in range(words // 12)]
        (docs / f"d{d}.md").write_text("\n\n".join(" ".join(sents[i : i + 6]) for i in range(0, len(sents), 6)))


def _index_shape(path):
    from tensortruth_tpu_torch.index import VectorIndex

    index = VectorIndex.load(path)
    key = {n.node_id: (n.doc_id, n.level, n.start, n.end, n.text) for n in index.store.nodes()}
    nodes = [(key[n.node_id], key.get(n.parent_id)) for n in index.store.nodes()]
    rows = [key[n.node_id] for n in index.rows_to_nodes(np.arange(index.n_rows))]
    meta = json.loads((path / "index_metadata.json").read_text())
    meta.pop("created_at")
    return nodes, rows, np.asarray(index.matrix()[0]), meta


@pytest.mark.parametrize("chunk_sizes", [[128, 32], [2048, 512]])
def test_build_module_on_the_card_matches_the_cpu(gen, tmp_path, chunk_sizes):
    from tensortruth_tpu_torch.indexing.builder import build_module
    from tensortruth_tpu_torch.models.xlmr import XLMRConfig, XLMRModel

    _write_docs(tmp_path / "docs", 3000)
    cfg = XLMRConfig(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
                     max_position=2050)
    tok = SimpleTokenizer(vocab_size=512)
    cpu = XLMRModel.random_init(cfg, "cpu", dtype=torch.float32, seed=5)
    card = XLMRModel.from_state_dict(cfg, cpu.state_dict(), "cuda", torch.bfloat16)
    sources = {"libraries": {"gamma": {}}, "papers": {}, "books": {}}
    shapes, launches = [], []
    for name, model in (("cpu", cpu), ("cuda", card)):
        before = blocked_attention.launches
        assert build_module("gamma", Embedder(model, tok), library_docs_dir=tmp_path / "docs",
                            indexes_dir=tmp_path / name, sources=sources, embedding_model="tiny-embedder",
                            chunk_sizes=chunk_sizes, chunk_overlap=8)
        launches.append(blocked_attention.launches - before)
        shapes.append(_index_shape(tmp_path / name / "tiny-embedder" / "library_gamma"))
    (nodes, rows, emb, meta), (cnodes, crows, cemb, cmeta) = shapes
    assert cnodes == nodes and crows == rows and cmeta == meta and len(rows) > 3
    np.testing.assert_allclose(np.linalg.norm(cemb, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(cemb, emb, atol=2e-2, rtol=0)
    assert launches[0] == 0  # the CPU takes the plain attention
    assert (launches[1] > 0) == (chunk_sizes[-1] >= 512)
