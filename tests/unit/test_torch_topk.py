"""Parity of the port's top-k (tensortruth_tpu_torch/ops/topk.py) with the
reference (tensortruth_tpu/ops/topk.py) on the CPU.

The reference's Pallas ``fused_topk`` runs in interpret mode here, as its own
tests run it; the port's wrapper takes its plain PyTorch version because the
tensors lie on the CPU. Inputs are float32 and made with numpy from a seed.
Tolerance: indices identical, values within 1e-6 (both sum float32 products,
in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensortruth_tpu.ops import topk as ref
from tensortruth_tpu_torch.ops import topk as port

torch.set_num_threads(1)

ATOL = 1e-6


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _assert_same(ref_out, port_out):
    rv, ri = (np.asarray(a) for a in ref_out)
    pv, pi = (t.numpy() for t in port_out)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pv, rv, atol=ATOL, rtol=0)


# (B, N, D, k, m, tile_n, c_out, n_actual): n_rot > 1 (c_out > tile_n/m),
# m > 1, n_actual < N, k > n_actual, and a ragged last tile.
FUSED_CASES = [
    (5, 3000, 32, 20, 1, 256, 256, 3000),
    (3, 3000, 32, 20, 1, 256, 1024, 3000),   # n_rot = 4
    (4, 2600, 32, 15, 2, 256, 256, 2600),    # m = 2, c = 128
    (4, 2600, 32, 15, 2, 256, 512, 2500),    # m = 2, n_rot = 4, n_actual < N
    (2, 700, 16, 40, 1, 256, 2048, 650),     # c_out clamps to ceil(650/256)*256
    (3, 300, 16, 500, 1, 256, 256, 290),     # k > n_actual: -inf / -1 padding
]


@pytest.mark.parametrize("b,n,d,k,m,tile_n,c_out,n_actual", FUSED_CASES)
def test_plain_fused_matches_reference_interpret(b, n, d, k, m, tile_n, c_out, n_actual):
    rng = np.random.default_rng(n + k)
    q, e = _unit(rng, (b, d)), _unit(rng, (n, d))
    want = ref.fused_topk(
        jnp.asarray(q), jnp.asarray(e), k, m=m, tile_n=tile_n, c_out=c_out, n_actual=n_actual
    )
    got = port.fused_topk(
        torch.from_numpy(q), torch.from_numpy(e), k, m=m, tile_n=tile_n, c_out=c_out, n_actual=n_actual
    )
    _assert_same(want, got)


@pytest.mark.parametrize("m,c_out", [(1, 256), (2, 256), (1, 768)])
def test_plain_fused_planted_ties(m, c_out):
    """Integer-valued data: every score is exact in float32 in any summation
    order, so there are many exact ties (duplicated rows across tiles and
    equal candidate values) and their order must match the reference's."""
    rng = np.random.default_rng(7)
    base = rng.integers(-2, 3, size=(300, 16)).astype(np.float32)
    e = np.concatenate([base] * 4)  # rows i, i+300, ... tie exactly
    q = rng.integers(-2, 3, size=(4, 16)).astype(np.float32)
    want = ref.fused_topk(jnp.asarray(q), jnp.asarray(e), 60, m=m, tile_n=256, c_out=c_out, n_actual=1150)
    got = port.fused_topk(torch.from_numpy(q), torch.from_numpy(e), 60, m=m, tile_n=256, c_out=c_out, n_actual=1150)
    _assert_same(want, got)
    assert len(np.unique(np.asarray(want[0]))) < 60  # ties were really there


def test_plain_fused_candidates_first_occurrence_rule():
    """Candidate slot j of block r keeps the FIRST max over (tile, segment)."""
    q = torch.ones((1, 2))
    e = torch.zeros((1024, 2))
    e[5] = e[128 + 5] = e[512 + 5] = 1.0  # same slot 5, segments 0/1, tiles 0/2
    vals, idx = port.fused_candidates_plain(q, e, tile_n=256, m=2, c_out=128, n_actual=1024)
    assert vals[0, 5].item() == 2.0 and idx[0, 5].item() == 5
    vals, idx = port.fused_candidates_plain(q, e, tile_n=256, m=2, c_out=128, n_actual=4)
    assert idx[0, 5].item() == -1 and vals[0, 5].item() == float("-inf")  # masked rows


@pytest.mark.parametrize("n_valid", [None, 150])
def test_exact_topk_matches_reference(n_valid):
    rng = np.random.default_rng(1)
    q, e = _unit(rng, (6, 24)), _unit(rng, (200, 24))
    _assert_same(
        ref.exact_topk(jnp.asarray(q), jnp.asarray(e), 9, n_valid=n_valid),
        port.exact_topk(torch.from_numpy(q), torch.from_numpy(e), 9, n_valid=n_valid),
    )


def test_exact_topk_ties_lower_index_first():
    q = np.ones((2, 4), np.float32)
    e = np.ones((50, 4), np.float32)
    _assert_same(ref.exact_topk(jnp.asarray(q), jnp.asarray(e), 7),
                 port.exact_topk(torch.from_numpy(q), torch.from_numpy(e), 7))


@pytest.mark.parametrize(
    "n,n_actual,k,exact",
    [(4096, 4096, 30, False), (4097, 4097, 30, False), (4608, 4300, 30, False),
     (5000, 5000, 30, True), (100, 60, 80, False)],
)
def test_topk_search_matches_reference(n, n_actual, k, exact):
    """Both sides of the 4096-row exact cut-over, padding rows, and k > n."""
    rng = np.random.default_rng(n + n_actual)
    q, e = _unit(rng, (3, 16)), _unit(rng, (n, 16))
    _assert_same(
        ref.topk_search(jnp.asarray(q), jnp.asarray(e), k, exact=exact, n_actual=n_actual),
        port.topk_search(torch.from_numpy(q), torch.from_numpy(e), k, exact=exact, n_actual=n_actual),
    )


@pytest.mark.parametrize("n", [2048, 3000])
def test_pad_corpus_for_fused_matches_reference(n):
    e = np.random.default_rng(0).standard_normal((n, 8)).astype(np.float32)
    (rp, rn), (pp, pn) = ref.pad_corpus_for_fused(e), port.pad_corpus_for_fused(e)
    assert rn == pn == n
    np.testing.assert_array_equal(rp, pp)


def test_geometry_rejects_unaligned_buckets():
    q = torch.zeros((1, 8))
    with pytest.raises(ValueError):
        port.fused_topk(q, torch.zeros((300, 8)), 3, m=3, tile_n=256)
    with pytest.raises(ValueError):
        port.fused_topk(q, torch.zeros((300, 8)), 3, m=4, tile_n=256)  # c = 64
