"""The port's int8 flat corpus tier against the reference's, on the CPU.

* ``quantize_corpus`` / ``quantize_corpus_streaming`` are copies: bit-equal
  outputs, the same error on a short stream.
* ``fused_topk_int8`` (the port's plain version of kernel B2, taken because
  the tensors lie on the CPU) against the reference's Pallas kernel in
  interpret mode: identical indices, values within 1e-6 (both sum exact
  products of bf16 or f32 queries with int8 rows in float32, in different
  orders, then apply one f32 scale). Integer rows with scale 1 make every
  score exact, and then the tie order must match exactly.
* The host helpers of kernel B2: the query's dim order leaves every score
  unchanged, and the persistent schedule (shared with kernel B1, at B1's
  shapes too) covers every (range, candidate block, slot chunk) once, in
  ascending ranges.
* The int8 tier of ``MultiIndexEngine`` and of ``load_engine_for_modules``
  against the reference's: the same node ids after merge and balance, the
  same gate decision, and the fused query step switched off in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_e2e import QUERIES, _services, env, runtimes  # noqa: F401 (fixtures)
from test_torch_retrieval import _assert_same, _flat, _module, _modules, _queries

from tensortruth_tpu.ops import topk as ref
from tensortruth_tpu.retrieval.engine import MultiIndexEngine as RefEngine
from tensortruth_tpu_torch.ops import topk as port
from tensortruth_tpu_torch.pipeline import QueryPipeline
from tensortruth_tpu_torch.retrieval.engine import MultiIndexEngine

torch.set_num_threads(1)

ATOL = 1e-6


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("n,d,zero_row", [(1, 8, False), (700, 32, False), (300, 64, True)])
def test_quantize_corpus_matches_reference(n, d, zero_row):
    e = np.random.default_rng(n).standard_normal((n, d)).astype(np.float32)
    if zero_row:
        e[5] = 0.0
    (rq, rs), (pq, ps) = ref.quantize_corpus(e), port.quantize_corpus(e)
    assert pq.dtype == np.int8 and ps.dtype == np.float32
    np.testing.assert_array_equal(pq, rq)
    np.testing.assert_array_equal(ps, rs)


@pytest.mark.parametrize("n,piece,tile_n", [(5000, 1024, 2048), (4096, 4096, 2048), (300, 7, 256)])
def test_quantize_corpus_streaming_matches_reference(n, piece, tile_n):
    e = _unit(np.random.default_rng(n), (n, 16))
    pieces = [e[i : i + piece] for i in range(0, n, piece)]
    want = ref.quantize_corpus_streaming(iter(pieces), n, 16, tile_n=tile_n)
    got = port.quantize_corpus_streaming(iter(pieces), n, 16, tile_n=tile_n)
    assert got[2] == want[2] == n and got[0].shape[0] % tile_n == 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert not got[1][n:].any()  # padding rows keep scale 0
    with pytest.raises(ValueError, match="expected"):
        port.quantize_corpus_streaming(iter(pieces[:1]), n + 1, 16)


def _both_int8(q, e_q, scales, k, **kw):
    want = ref.fused_topk_int8(jnp.asarray(q), jnp.asarray(e_q), jnp.asarray(scales), k, **kw)
    q_port = torch.from_numpy(np.array(q, np.float32)).to(torch.bfloat16 if q.dtype == jnp.bfloat16 else torch.float32)
    got = port.fused_topk_int8(q_port, torch.from_numpy(e_q), torch.from_numpy(scales), k, **kw)
    return [np.asarray(a, np.float32) for a in want], [t.numpy() for t in got]


# (B, N, D, k, m, tile_n, c_out, n_actual, query dtype): N <= 4096 (no exact
# cut-over on this tier), n_rot > 1, m > 1, n_actual < N, k > n_actual.
INT8_CASES = [
    (5, 3000, 32, 20, 1, 256, 256, "bfloat16"),
    (3, 3000, 32, 20, 1, 256, 1024, "bfloat16"),  # n_rot = 4
    (4, 2600, 32, 15, 2, 256, 512, "float32"),    # m = 2, n_rot = 4
    (2, 700, 16, 40, 1, 2048, 2048, "bfloat16"),  # one tile, c_out clamps to 2048
    (3, 300, 16, 500, 1, 256, 256, "float32"),    # k > n_actual: -inf / -1 padding
    (6, 9000, 64, 50, 1, 2048, 2048, "bfloat16"),  # the engine's geometry
]


@pytest.mark.parametrize("b,n,d,k,m,tile_n,c_out,q_dtype", INT8_CASES)
@pytest.mark.parametrize("short", [0, 37])
def test_plain_fused_int8_matches_reference_interpret(b, n, d, k, m, tile_n, c_out, q_dtype, short):
    rng = np.random.default_rng(n + k + short)
    e_q, scales = ref.quantize_corpus(_unit(rng, (n, d)))
    q = jnp.asarray(_unit(rng, (b, d)), getattr(jnp, q_dtype))
    (rv, ri), (pv, pi) = _both_int8(q, e_q, scales, k, m=m, tile_n=tile_n, c_out=c_out, n_actual=n - short)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pv, rv, atol=ATOL, rtol=0)
    assert (pi < n - short).all()


@pytest.mark.parametrize("m,c_out", [(1, 256), (2, 256), (1, 768)])
def test_plain_fused_int8_planted_ties(m, c_out):
    """Integer rows at scale 1, repeated across tiles: every score is an
    exact integer, so ties abound and their order must be the reference's."""
    rng = np.random.default_rng(7)
    e_q = np.concatenate([rng.integers(-2, 3, size=(300, 16)).astype(np.int8)] * 4)
    scales = np.ones(len(e_q), np.float32)
    q = jnp.asarray(rng.integers(-2, 3, size=(4, 16)), jnp.bfloat16)
    (rv, ri), (pv, pi) = _both_int8(q, e_q, scales, 60, m=m, tile_n=256, c_out=c_out, n_actual=1150)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pv, rv)
    assert len(np.unique(rv)) < 60  # ties were really there


def test_scale_applies_after_the_dot():
    """A row's score is f32(dot(q, e_q)) * f32(scale), as the reference
    orders them: ten ones at scale 0.1 score exactly 10 * 0.1 = 1.0, where
    summing ten pre-scaled 0.1s in float32 gives 1.0000001."""
    q = torch.ones((1, 16), dtype=torch.bfloat16)
    e_q = torch.zeros((2048, 16), dtype=torch.int8)
    e_q[0, :10] = 1
    scales = torch.full((2048,), 0.1, dtype=torch.float32)
    vals, idx = port.fused_topk_int8(q, e_q, scales, 1)
    assert idx.item() == 0 and vals.item() == np.float32(10) * np.float32(0.1) == 1.0
    pre_scaled = np.float32(0)
    for _ in range(10):
        pre_scaled += np.float32(0.1)
    assert pre_scaled != 1.0


# -- host helpers of kernel B2 ----------------------------------------------------


@pytest.mark.parametrize("d", [16, 80, 1024])
def test_permute_dims_leaves_the_scores_unchanged(d):
    """B2 takes each 16 dims of a corpus row in DIM_ORDER; the same order on
    the query keeps every product's terms, so q . e^T is unchanged
    (exactly, for integer values summed in float64)."""
    rng = np.random.default_rng(d)
    q = torch.from_numpy(rng.integers(-3, 4, size=(5, d)).astype(np.float64))
    e = torch.from_numpy(rng.integers(-128, 128, size=(40, d)).astype(np.float64))
    got = port.permute_dims(q) @ port.permute_dims(e).t()
    assert torch.equal(got, q @ e.t())
    assert not torch.equal(port.permute_dims(q), q)
    x = torch.arange(2 * d).view(2, d)
    perm = port.permute_dims(x)
    assert perm.is_contiguous() and perm.shape == x.shape
    assert perm[1, :16].tolist() == [d + i for i in port.DIM_ORDER]
    assert sorted(perm[0].tolist()) == list(range(d))
    # fragment k-slots {2t, 2t+1} carry dims {4t, 4t+1}, {2t+8, 2t+9} dims {4t+2, 4t+3}
    assert all(port.DIM_ORDER[2 * t + e] == 4 * t + e and port.DIM_ORDER[2 * t + 8 + e] == 4 * t + 2 + e
               for t in range(4) for e in range(2))


def _range_bounds(inner, n_ranges):
    """Tiles [begin, end) of each range, as the kernels cut a candidate
    block's ``inner`` tiles (``stream_schedule`` states the rule)."""
    return [(r * inner // n_ranges, (r + 1) * inner // n_ranges) for r in range(n_ranges)]


def _work_items(worker, workers, n_ranges, n_rot, chunks):
    """(range, candidate block, slot chunk) of each item a B1 or B2 worker
    walks, in its order: item (range * n_rot + rot) * chunks + chunk, every
    ``workers``-th from ``worker`` (csrc/fused_topk.cu, decode)."""
    n_items = n_ranges * n_rot * chunks
    return [(i // (chunks * n_rot), i // chunks % n_rot, i % chunks) for i in range(worker, n_items, workers)]


# (b_pad, c, n_rot, inner, m, resident blocks, consumers). B2: the int8 flat
# tier's shape, two query blocks, n_rot > 1, m > 1, one tile, few blocks. B1:
# the main path's 262,144 rows, 1,048,576 rows, 33 queries, n_rot = 4 with
# m = 2 (the card test's planted ties).
SCHEDULES = [
    (32, 2048, 1, 1024, 1, 132, 2),
    (64, 2048, 1, 147, 1, 132, 2),
    (32, 2048, 4, 2, 1, 132, 2),
    (96, 1024, 3, 7, 2, 132, 3),
    (32, 2048, 1, 1, 1, 132, 2),
    (32, 128, 1, 40, 1, 1, 1),
    (32, 2048, 1, 128, 1, 132, 2),
    (32, 2048, 1, 512, 1, 132, 2),
    (64, 2048, 1, 10, 1, 132, 2),
    (64, 1024, 4, 2, 2, 132, 2),
]


@pytest.mark.parametrize("b_pad,c,n_rot,inner,m,resident,consumers", SCHEDULES)
def test_int8_schedule_covers_every_item_once_in_ascending_ranges(b_pad, c, n_rot, inner, m, resident, consumers):
    blocks, n_ranges = port.stream_schedule(b_pad, c, n_rot, inner, m, resident, consumers)
    assert 1 <= n_ranges <= inner
    assert 1 <= blocks and blocks * (b_pad // 32) <= max(resident, b_pad // 32)
    bounds = _range_bounds(inner, n_ranges)
    assert bounds[0][0] == 0 and bounds[-1][1] == inner
    assert all(lo < hi for lo, hi in bounds) and all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    chunks = c // 64
    workers = blocks * consumers
    walks = [_work_items(w, workers, n_ranges, n_rot, chunks) for w in range(workers)]
    seen = [item for walk in walks for item in walk]
    want = {(r, rot, ch) for r in range(n_ranges) for rot in range(n_rot) for ch in range(chunks)}
    assert len(seen) == len(want) and set(seen) == want
    # each worker's items come in ascending range order; none walks more
    # than one item beyond an even share
    assert all(walk == sorted(walk) for walk in walks)
    assert max(map(len, walks)) <= -(-len(want) // workers)


def test_int8_schedule_balances_the_flat_tier():
    """2,097,152 rows at B = 32 on 132 blocks of two warpgroups: the busiest
    worker walks within 2% of an even share of the 32,768 steps."""
    blocks, n_ranges = port.stream_schedule(32, 2048, 1, 1024, 1, 132, 2)
    workers = blocks * 2
    steps = [sum(hi - lo for (lo, hi) in (_range_bounds(1024, n_ranges)[r] for r, _, _ in
                                          _work_items(w, workers, n_ranges, 1, 32)))
             for w in range(workers)]
    assert sum(steps) == 32 * 1024
    assert max(steps) <= 1.02 * 32 * 1024 / workers


def test_stream_schedule_balances_the_main_path():
    """B1 over the main path's 262,144 rows (128 tiles) at B = 32 on 132
    blocks of two warpgroups: the busiest worker walks 16 steps, against an
    even share of 15.5 of the 4,096."""
    blocks, n_ranges = port.stream_schedule(32, 2048, 1, 128, 1, 132, 2)
    workers = blocks * 2
    steps = [sum(hi - lo for (lo, hi) in (_range_bounds(128, n_ranges)[r] for r, _, _ in
                                          _work_items(w, workers, n_ranges, 1, 32)))
             for w in range(workers)]
    assert sum(steps) == 32 * 128
    assert max(steps) == 16


# -- the engine's int8 tier ------------------------------------------------------


@pytest.mark.parametrize("parents,balance", [((60, 25, 40), "top_k_per_index"), ((900, 300, 400), "none"),
                                             ((1800,), "top_k_per_index")])
def test_int8_engine_matches_reference(parents, balance):
    ref_indexes, indexes = _modules(parents)
    kw = dict(similarity_top_k=10, balance_strategy=balance, use_fused=True, corpus_dtype="int8")
    want_engine = RefEngine(ref_indexes, **kw)
    got_engine = MultiIndexEngine(indexes, device="cpu", **kw)
    stacked, scales = got_engine._stacked, got_engine._stacked_scales
    assert stacked.dtype == torch.int8 and stacked.shape[0] % 2048 == 0 and scales.dtype == torch.float32
    np.testing.assert_array_equal(stacked.numpy(), np.asarray(want_engine._stacked))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_engine._stacked_scales))
    q = _queries(indexes)
    _assert_same(_flat(want_engine.retrieve_batch(q)), _flat(got_engine.retrieve_batch(q)))


def test_int8_without_fused_falls_back_to_bf16_like_reference(caplog):
    ref_indexes, indexes = _modules((60, 30), names=["a", "b"])
    kw = dict(similarity_top_k=10, use_fused=False, corpus_dtype="int8")
    with caplog.at_level("WARNING"):
        got_engine = MultiIndexEngine(indexes, device="cpu", **kw)
    assert "falling back to bfloat16" in caplog.text
    assert got_engine._stacked.dtype == torch.bfloat16 and got_engine._stacked_scales is None
    q = _queries(indexes)
    _assert_same(_flat(RefEngine(ref_indexes, **kw).retrieve_batch(q)), _flat(got_engine.retrieve_batch(q)))


def test_refresh_restacks_without_stale_scales():
    indexes = {"a": _module("a", 60, 3, seed=3)}
    eng = MultiIndexEngine(indexes, device="cpu", use_fused=True, corpus_dtype="int8")
    assert eng._stacked_scales is not None and "quantize" in eng.placement_seconds
    eng.retrieve(_queries(indexes)[0], "cached")
    eng.corpus_dtype = "bfloat16"
    eng.refresh()
    assert eng._stacked_scales is None and eng._stacked.dtype == torch.bfloat16 and not eng._cache


@pytest.mark.parametrize("use_fused", [True, False])
def test_load_engine_int8_tier_matches_reference(env, monkeypatch, use_fused):  # noqa: F811
    """The whole request path on the int8 tier: ``load_engine_for_modules``
    builds both engines, the fused query step is off in both (the query goes
    embed -> retriever), and the reranked sources and gate agree."""
    _, cfgs = env
    for cfg in cfgs:
        cfg.rag.use_fused_topk = use_fused
    ref_svc, port_svc, _ = _services(env, {"reranker_top_n": 3, "corpus_dtype": "int8"})
    retriever = port_svc.engine.retriever
    assert (retriever._stacked_scales is not None) == use_fused
    assert port_svc.engine.pipeline is None if use_fused else port_svc.engine.pipeline is not None
    assert (ref_svc.engine.pipeline is None) == (port_svc.engine.pipeline is None)
    for text in QUERIES:
        want, got = ref_svc.retrieve(text), port_svc.retrieve(text)
        assert [s.id for s in got.sources] == [s.id for s in want.sources] and got.sources
        np.testing.assert_allclose([s.score for s in got.sources], [s.score for s in want.sources], atol=1e-5)
        assert got.confidence == want.confidence
        timings = got.metrics["timings"]
        assert ("embed_topk_fused" in timings) == (not use_fused)


def test_pipeline_not_applicable_on_int8_ivf_or_mesh_tiers():
    """The fused embed -> top-k step would cast the query to the corpus
    dtype (int8: every component truncates to 0) or score against IVF
    blocks; like the reference's, ``applicable()`` is false on those tiers."""
    indexes = {"a": _module("a", 60, 3, seed=4)}
    embedder = type("E", (), {"device": torch.device("cpu")})()
    flat = MultiIndexEngine(indexes, device="cpu")
    int8 = MultiIndexEngine(indexes, device="cpu", use_fused=True, corpus_dtype="int8")
    ivf = MultiIndexEngine(indexes, device="cpu", ivf_threshold=100, ivf_clusters=4)
    assert QueryPipeline(embedder, flat).applicable()
    assert not QueryPipeline(embedder, int8).applicable()
    assert not QueryPipeline(embedder, ivf).applicable()
    flat.mesh = object()  # the state a mesh engine would be in
    assert not QueryPipeline(embedder, flat).applicable()
    flat.mesh = None
    flat._stacked = flat._stacked.to("meta")  # a corpus on another device
    assert not QueryPipeline(embedder, flat).applicable()


def test_retrieved_node_text_and_to_dict_match_reference():
    from tensortruth_tpu import index as ref_index
    from tensortruth_tpu.retrieval.engine import RetrievedNode as RefNode
    from tensortruth_tpu_torch.retrieval.engine import RetrievedNode

    idx, ref_idx = _module("m", 3, 2, seed=0), _module("m", 3, 2, seed=0, pkg=ref_index)
    node, ref_node = (i.store.get(i.store.leaf_ids[1]) for i in (idx, ref_idx))
    want, got = RefNode(ref_node, 0.25, "m", 2), RetrievedNode(node, 0.25, "m", 2)
    assert got.text == want.text and got.node_id == want.node_id
    assert got.to_dict() == want.to_dict()
