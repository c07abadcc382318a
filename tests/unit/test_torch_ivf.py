"""The port's IVF tier (tensortruth_tpu_torch/ops/ivf.py) against the
reference's (tensortruth_tpu/ops/ivf.py), on the CPU.

* ``probe_scores_plain`` (the plain version of kernel B4, taken because the
  tensors lie on the CPU) against the reference's Pallas ``_probe_scores``
  in interpret mode, bf16 and int8 blocks: within 1e-5, -inf exactly where
  a slot is padding. The port's device search against the reference's
  gather fallback: identical positions, scores within 1e-5.
* ``group_probes_plain``, the plain version of B4's grouping of the
  (query, probe) pairs over int8 blocks: every pair once, by cluster, in
  chunks of at most 32 pairs of one cluster. The reference has no such step
  (its grid walks the pairs one by one).
* The build steps: ``_sample_rows`` and ``_place_rows`` bit-equal,
  ``_assign_top2`` equal in float32, ``_kmeans_fit`` from the reference's
  own seed rows within 1e-5 with the same assignments, and the whole
  ``build_ivf`` identical once the seed rows are shared (the two packages
  draw them from different generators, so one seed clusters differently).
* ``ivf_search`` over an index carried across with ``ivf_index_from_arrays``:
  the same row ids, scores within 1e-5, also for k > nprobe * rpc.
* The port's own ``build_ivf`` keeps the reference tests' invariants, and
  its device path (rows staged by the assignment pass, one scatter) gives
  the host fill's blocks, scales and row_map bit for bit.
* The IVF tier of the engine, through ``load_engine_for_modules``, returns
  the reference's node ids and gate decision.

Scores are sums of exact bf16 (or bf16 x int8) products in float32, in
different orders in the two packages: 1e-5 covers that at these sizes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_e2e import QUERIES, _services, env, runtimes  # noqa: F401 (fixtures)
from test_torch_retrieval import _assert_same, _flat, _module, _modules, _queries

from tensortruth_tpu import engine as ref_engine_mod
from tensortruth_tpu.ops import ivf as ref
from tensortruth_tpu.retrieval.engine import MultiIndexEngine as RefEngine
from tensortruth_tpu_torch import engine as port_engine_mod
from tensortruth_tpu_torch.ops import ivf as port
from tensortruth_tpu_torch.retrieval.engine import MultiIndexEngine

torch.set_num_threads(1)

ATOL = 1e-5


def _corpus(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _ref_init(n, n_clusters, seed):
    """The seed rows the reference's ``_kmeans_fit`` draws."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (n_clusters,), replace=False))


def _carried(index, device="cpu"):
    scales = None if index.scales is None else np.asarray(index.scales)
    return port.ivf_index_from_arrays(
        np.asarray(index.centroids), np.asarray(index.blocks), index.row_map, index.n_actual,
        scales=scales, device=device,
    )


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def built(request):
    """(corpus, reference index) with bf16 or int8 blocks."""
    emb = _corpus(np.random.default_rng(0), 3000, 32)
    dtype = jnp.int8 if request.param == "int8" else jnp.bfloat16
    return emb, ref.build_ivf(emb, n_clusters=16, sample_size=2000, kmeans_iters=4, block_dtype=dtype)


@pytest.mark.parametrize("b,nprobe", [(3, 4), (1, 16)])
def test_probe_scores_plain_matches_reference_interpret(built, b, nprobe):
    emb, index = built
    rng = np.random.default_rng(b + nprobe)
    q = jnp.asarray(_corpus(rng, b, emb.shape[1]), jnp.bfloat16)
    probe = rng.integers(0, index.n_clusters, (b, nprobe)).astype(np.int32)
    probe[:, 0] = probe[0, 0]  # a cluster probed by every query
    valid = (index.row_map >= 0).astype(np.int32)
    want = np.asarray(ref._probe_scores(jnp.asarray(probe), q, index.blocks, jnp.asarray(valid),
                                        index.scales, interpret=True))
    carried = _carried(index)
    got = port.probe_scores(torch.from_numpy(probe), torch.from_numpy(np.array(q, np.float32)).to(torch.bfloat16),
                            carried.blocks, carried.valid, carried.scales).numpy()
    pad = valid[probe] == 0
    assert pad.any() and np.isneginf(got[pad]).all() and np.isfinite(got[~pad]).all()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(got[~pad], want[~pad], atol=ATOL, rtol=0)


@pytest.mark.parametrize("k,nprobe", [(10, 4), (2000, 2)])
def test_device_search_matches_reference_fallback(built, k, nprobe):
    """The reference off a TPU scores the probed blocks by its gather
    fallback; the port's device step by the plain B4 on the CPU."""
    emb, index = built
    q = _corpus(np.random.default_rng(k), 5, emb.shape[1])
    valid = jnp.asarray(index.row_map >= 0)
    cent = index.centroids.astype(jnp.bfloat16)
    want = ref._ivf_search_device(jnp.asarray(q, jnp.bfloat16), cent, index.blocks, valid, k, nprobe,
                                  scales=index.scales)
    carried = _carried(index)
    got = port._ivf_search_device(torch.from_numpy(q).to(torch.bfloat16), carried.centroids.to(torch.bfloat16),
                                  carried.blocks, carried.valid, k, nprobe, scales=carried.scales)
    (wv, wp), (gv, gp) = (np.asarray(a) for a in want), (t.numpy() for t in got)
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), finite)
    np.testing.assert_array_equal(gp[finite], wp[finite])
    np.testing.assert_allclose(gv[finite], wv[finite], atol=ATOL, rtol=0)


@pytest.mark.parametrize("k,nprobe", [(1, 1), (10, 4), (25, 16), (2000, 2)])
def test_ivf_search_over_carried_index_matches_reference(built, k, nprobe):
    emb, index = built
    q = _corpus(np.random.default_rng(nprobe), 6, emb.shape[1])
    q[0] = emb[17]  # a corpus row as a query
    (wv, wr), (gv, gr) = ref.ivf_search(index, q, k, nprobe=nprobe), port.ivf_search(_carried(index), q, k, nprobe)
    assert gv.shape == wv.shape == (6, k) and gr.dtype == wr.dtype
    np.testing.assert_array_equal(gr, wr)
    finite = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), finite)
    np.testing.assert_allclose(gv[finite], wv[finite], atol=ATOL, rtol=0)
    assert (gr[~finite] == -1).all()
    assert gr[0, 0] == 17


def test_carried_index_keeps_the_bits(built):
    _, index = built
    carried = _carried(index)
    assert carried.blocks.dtype == (torch.int8 if index.scales is not None else torch.bfloat16)
    np.testing.assert_array_equal(carried.blocks.float().numpy(), np.asarray(index.blocks, np.float32))
    np.testing.assert_array_equal(carried.valid.numpy(), index.row_map >= 0)
    assert carried.padding_waste == index.padding_waste
    assert (carried.n_clusters, carried.rows_per_cluster) == (index.n_clusters, index.rows_per_cluster)


# -- build steps -----------------------------------------------------------------


def test_sample_rows_matches_reference():
    emb = _corpus(np.random.default_rng(1), 1000, 8)

    def pieces():
        return iter([emb[i : i + 130] for i in range(0, 1000, 130)])

    rows = np.sort(np.random.default_rng(2).choice(1000, 77, replace=False))
    np.testing.assert_array_equal(port._sample_rows(pieces, 1000, 8, rows), ref._sample_rows(pieces, 1000, 8, rows))
    with pytest.raises(RuntimeError, match="expected"):
        port._sample_rows(pieces, 1001, 8, rows)


@pytest.mark.parametrize("rpc", [16, 40, 200])
def test_place_rows_matches_reference(rpc):
    rng = np.random.default_rng(rpc)
    assign = (rng.zipf(1.5, 2000) % 12).astype(np.int32)  # skewed: overflow and spill
    second = ((assign + 1 + rng.integers(0, 5, 2000)) % 12).astype(np.int32)
    want, got = ref._place_rows(assign, second, 12, rpc), port._place_rows(assign, second, 12, rpc)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_assign_top2_matches_reference_in_f32():
    rng = np.random.default_rng(3)
    emb = _corpus(rng, 5000, 32)
    cent = _corpus(rng, 24, 32)
    cent[5] = cent[2]  # a tied pair of centroids: the lower index comes first

    def pieces():
        return iter([emb[:1700], emb[1700:]])

    want = ref._assign_top2(pieces, 5000, cent)
    got = port._assign_top2(pieces, 5000, cent, "cpu", step=1000)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0] != 5).all()


@pytest.mark.parametrize("n,k,iters", [(600, 8, 3), (2000, 32, 10)])
def test_kmeans_fit_from_reference_seed_rows(n, k, iters):
    sample = _corpus(np.random.default_rng(n), n, 16)
    want = np.asarray(ref._kmeans_fit(jnp.asarray(sample), jnp.asarray([5]), k, iters))
    got = port._kmeans_fit(torch.from_numpy(sample), 5, k, iters, init_idx=_ref_init(n, k, 5)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal((sample @ got.T).argmax(1), (sample @ want.T).argmax(1))


@pytest.mark.parametrize("block_dtype", ["bfloat16", "int8"])
def test_build_ivf_matches_reference_from_shared_seed_rows(monkeypatch, block_dtype):
    emb = _corpus(np.random.default_rng(4), 2500, 32)
    monkeypatch.setattr(port, "_init_indices", _ref_init)
    kw = dict(n_clusters=12, sample_size=1500, kmeans_iters=5, seed=3)
    want = ref.build_ivf(emb, block_dtype=getattr(jnp, block_dtype), **kw)
    got = port.build_ivf(emb, block_dtype=getattr(torch, block_dtype), device="cpu", **kw)
    np.testing.assert_array_equal(got.row_map, want.row_map)
    np.testing.assert_array_equal(got.blocks.float().numpy(), np.asarray(want.blocks, np.float32))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), atol=1e-5, rtol=0)
    if block_dtype == "int8":
        np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))
    assert list(got.build_seconds) == ["sample", "kmeans", "assign", "place", "scatter"]


# -- the port's build_ivf on its own (the reference tests' invariants) ----------


@pytest.fixture(scope="module")
def port_index():
    emb = _corpus(np.random.default_rng(0), 8000, 32)
    return emb, port.build_ivf(emb, n_clusters=32, sample_size=4000, kmeans_iters=5, device="cpu")


def test_every_row_placed_once(port_index):
    emb, index = port_index
    packed = index.row_map[index.row_map >= 0]
    assert np.array_equal(np.sort(packed), np.arange(len(emb)))
    assert index.rows_per_cluster % 128 == 0 and index.blocks.dtype == torch.bfloat16


def test_self_retrieval_and_probe_all_is_exact(port_index):
    emb, index = port_index
    vals, rows = port.ivf_search(index, emb[:16], k=1, nprobe=4)
    assert (rows[:, 0] == np.arange(16)).mean() >= 0.95
    np.testing.assert_allclose(vals[:, 0], 1.0, atol=5e-3)  # bf16 blocks
    q = _corpus(np.random.default_rng(9), 4, emb.shape[1])
    exact = np.argsort(-(q @ emb.T), axis=1, kind="stable")[:, :5]
    _, rows = port.ivf_search(index, q, k=5, nprobe=index.n_clusters * 5)  # nprobe clamps to all
    assert np.mean([len(set(exact[i]) & set(rows[i])) / 5 for i in range(4)]) >= 0.95


def test_build_is_seed_deterministic():
    emb = _corpus(np.random.default_rng(5), 500, 16)
    a = port.build_ivf(emb, n_clusters=8, sample_size=500, kmeans_iters=3, seed=42, device="cpu")
    b = port.build_ivf(emb, n_clusters=8, sample_size=500, kmeans_iters=3, seed=42, device="cpu")
    c = port.build_ivf(emb, n_clusters=8, sample_size=500, kmeans_iters=3, seed=43, device="cpu")
    np.testing.assert_array_equal(a.row_map, b.row_map)
    assert torch.equal(a.centroids, b.centroids) and not torch.equal(a.centroids, c.centroids)


def _skewed_corpus():
    """4,000 rows around 8 centres weighted 1/rank: 32 clusters of which the
    largest overflow both their best and second choice, so rows spill
    capacity-aware."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((8, 32)).astype(np.float32) * 3
    weights = 1.0 / np.arange(1, 9)
    which = rng.choice(8, 4000, p=weights / weights.sum())
    emb = centers[which] + 0.3 * rng.standard_normal((4000, 32)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def test_padding_waste_capped_on_skewed_clusters():
    emb = _skewed_corpus()
    index = port.build_ivf(emb, n_clusters=32, sample_size=4000, max_overflow=4.0, device="cpu")
    assert index.rows_per_cluster <= -(-int(np.ceil(4000 / 32 * 4.0)) // 128) * 128
    assert 0.0 <= index.padding_waste < 1.0
    assert (index.row_map >= 0).sum() == 4000  # capacity-aware spill drops nothing


def test_capacity_exhaustion_raises():
    emb = _corpus(np.random.default_rng(0), 1000, 16)
    with pytest.raises(ValueError, match="capacity exhausted"):
        port.build_ivf(emb, n_clusters=2, sample_size=1000, kmeans_iters=2, overflow=0.1, max_overflow=0.1,
                       device="cpu")


def test_single_cluster_and_streaming_pieces():
    emb = _corpus(np.random.default_rng(0), 5, 16)
    index = port.build_ivf(lambda: iter([emb[:2], emb[2:]]), n_clusters=1, sample_size=5, kmeans_iters=2,
                           n_rows=5, dim=16, device="cpu")
    _, rows = port.ivf_search(index, emb[:3], k=2, nprobe=1)
    assert index.n_clusters == 1 and (rows[:, 0] == np.arange(3)).all()
    with pytest.raises(ValueError, match="n_rows and dim"):
        port.build_ivf(lambda: iter([emb]), device="cpu")


def _pieces(emb, cuts):
    return lambda: iter(np.split(emb, cuts))


SCATTER_CASES = {
    "array": lambda: (_corpus(np.random.default_rng(11), 3000, 32), dict(n_clusters=12, sample_size=3000)),
    "pieces": lambda: (_pieces(_corpus(np.random.default_rng(12), 3000, 32), [1100, 2048]),
                       dict(n_clusters=12, sample_size=2000, n_rows=3000, dim=32)),
    "skewed": lambda: (_skewed_corpus(), dict(n_clusters=32, sample_size=4000, max_overflow=4.0)),
    "one_cluster": lambda: (_pieces(_corpus(np.random.default_rng(13), 300, 16), [120]),
                            dict(n_clusters=1, sample_size=300, n_rows=300, dim=16)),
}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("block_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_device_scatter_equals_host_fill(monkeypatch, caplog, case, block_dtype):
    """The blocks staged by the assignment pass and scattered once on the
    build's device (here the CPU) against the host fill
    (``device_blocks=False``): blocks, scales and row_map bit for bit, over
    an array, streaming pieces, a skewed corpus whose rows spill
    capacity-aware, and one cluster (no assignment pass)."""
    monkeypatch.setattr(port._RowStaging, "QUANT_ROWS", 256)  # several quantised parts per chunk
    emb, kw = SCATTER_CASES[case]()
    kw.update(kmeans_iters=3, seed=0, block_dtype=getattr(torch, block_dtype), device="cpu")
    with caplog.at_level("WARNING", logger=port.__name__):
        dev = port.build_ivf(emb, **kw)
    host = port.build_ivf(emb, device_blocks=False, **kw)
    assert list(dev.build_seconds) == ["sample", "kmeans", "assign", "place", "scatter"]
    assert list(host.build_seconds) == ["sample", "kmeans", "assign", "place", "fill", "to_device"]
    assert ("capacity-aware" in caplog.text) == (case == "skewed")
    assert (dev.n_clusters == 1) == (case == "one_cluster")
    assert dev.blocks.dtype == host.blocks.dtype == getattr(torch, block_dtype)
    assert torch.equal(_bits(dev.blocks), _bits(host.blocks))
    np.testing.assert_array_equal(dev.row_map, host.row_map)
    assert (dev.scales is None) == (host.scales is None) == (block_dtype != "int8")
    if dev.scales is not None:
        assert torch.equal(_bits(dev.scales), _bits(host.scales))


def test_quantize_rows_rounds_like_the_host_fill():
    """Ties round half to even, a zero row takes the 1e-12 scale, and random
    rows give the host fill's numpy bits."""
    rows = np.array([[127.0, 2.5, -3.5, 0.5], [0.0, 0.0, 0.0, 0.0], [-1.0, 0.25, 1e-3, 0.75]], np.float32)
    rows = np.concatenate([rows, np.random.default_rng(14).standard_normal((500, 4)).astype(np.float32)])
    q, scale = port._quantize_rows(torch.from_numpy(rows))
    want_scale = np.maximum(np.abs(rows).max(axis=1) / 127.0, 1e-12).astype(np.float32)
    want_q = np.clip(np.rint(rows / want_scale[:, None]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(q.numpy(), want_q)
    np.testing.assert_array_equal(scale.numpy().view(np.int32), want_scale.view(np.int32))
    assert q[0].tolist() == [127, 2, -4, 0] and scale[1].item() == np.float32(1e-12)


def test_int8_blocks_self_retrieval():
    emb = _corpus(np.random.default_rng(6), 4096, 64)
    index = port.build_ivf(emb, n_clusters=16, sample_size=4096, block_dtype=torch.int8, device="cpu")
    assert index.blocks.dtype == torch.int8 and tuple(index.scales.shape) == index.row_map.shape
    vals, rows = port.ivf_search(index, emb[:8], k=1, nprobe=4)
    assert (rows[:, 0] == np.arange(8)).mean() >= 0.9
    np.testing.assert_allclose(vals[:, 0], 1.0, atol=2e-2)


# -- the engine's IVF tier -------------------------------------------------------


@pytest.mark.parametrize("corpus_dtype", ["bfloat16", "int8"])
def test_ivf_engine_matches_reference(monkeypatch, corpus_dtype):
    """Past the threshold (twice it for int8) both engines build an IVF index
    from the same seed rows and return the same nodes."""
    monkeypatch.setattr(port, "_init_indices", _ref_init)
    ref_indexes, indexes = _modules((300, 120, 200))
    kw = dict(similarity_top_k=10, ivf_threshold=900, ivf_clusters=16, ivf_nprobe=4, corpus_dtype=corpus_dtype)
    want_engine, got_engine = RefEngine(ref_indexes, **kw), MultiIndexEngine(indexes, device="cpu", **kw)
    assert got_engine._ivf is not None and got_engine._stacked is got_engine._ivf.blocks
    assert got_engine._stacked.dtype == (torch.int8 if corpus_dtype == "int8" else torch.bfloat16)
    assert got_engine.n_chunks == 1860 and "kmeans" in got_engine.placement_seconds
    np.testing.assert_array_equal(got_engine._ivf.row_map, want_engine._ivf.row_map)
    q = _queries(indexes)
    _assert_same(_flat(want_engine.retrieve_batch(q)), _flat(got_engine.retrieve_batch(q)))


def test_int8_below_twice_the_threshold_stays_flat():
    indexes = {"a": _module("a", 300, 3, seed=1)}
    eng = MultiIndexEngine(indexes, device="cpu", ivf_threshold=600, corpus_dtype="int8", use_fused=True)
    assert eng._ivf is None and eng._stacked_scales is not None
    eng = MultiIndexEngine(indexes, device="cpu", ivf_threshold=450, corpus_dtype="int8", use_fused=True)
    assert eng._ivf is not None and eng._ivf.scales is not None


@pytest.mark.parametrize("corpus_dtype", ["bfloat16", "int8"])
def test_load_engine_ivf_tier_matches_reference(env, monkeypatch, corpus_dtype):  # noqa: F811
    """``load_engine_for_modules`` with a low IVF threshold (through the
    engine class each factory builds): both take the IVF tier, neither uses
    the fused query step, and the reranked sources and gate agree."""
    kw = dict(ivf_threshold=50, ivf_clusters=8, ivf_nprobe=3)
    monkeypatch.setattr(ref_engine_mod, "MultiIndexEngine", functools.partial(RefEngine, **kw))
    monkeypatch.setattr(port_engine_mod, "MultiIndexEngine", functools.partial(MultiIndexEngine, **kw))
    monkeypatch.setattr(port, "_init_indices", _ref_init)
    _, cfgs = env
    for cfg in cfgs:
        cfg.rag.use_fused_topk = True
    ref_svc, port_svc, _ = _services(env, {"reranker_top_n": 3, "corpus_dtype": corpus_dtype})
    assert port_svc.engine.retriever._ivf is not None and ref_svc.engine.retriever._ivf is not None
    assert port_svc.engine.pipeline is None and ref_svc.engine.pipeline is None
    np.testing.assert_array_equal(port_svc.engine.retriever._ivf.row_map, ref_svc.engine.retriever._ivf.row_map)
    for text in QUERIES:
        want, got = ref_svc.retrieve(text), port_svc.retrieve(text)
        assert [s.id for s in got.sources] == [s.id for s in want.sources] and got.sources
        np.testing.assert_allclose([s.score for s in got.sources], [s.score for s in want.sources], atol=1e-5)
        assert got.confidence == want.confidence
        assert "topk_merge" in got.metrics["timings"]


@pytest.mark.parametrize("b,nprobe,n_clusters", [(1, 1, 2), (32, 32, 1024), (40, 4, 16), (7, 9, 3)])
def test_group_probes_plain_contract(b, nprobe, n_clusters):
    """Every pair once; chunks of 1..32 pairs, each of one cluster, clusters
    ascending and each cluster's chunks consecutive and full but its last;
    a query may name a cluster twice, and one cluster is named by every
    query (more than 32 pairs at b = 40 and b = 32 x 32)."""
    rng = np.random.default_rng(b)
    probe = torch.from_numpy(rng.integers(0, n_clusters, (b, nprobe)).astype(np.int32))
    probe[:, 0] = probe[0, 0]
    if nprobe > 1:
        probe[0, 1] = probe[0, 0]
    order, chunks, n_chunks = port.group_probes(probe, n_clusters)
    flat, n = probe.reshape(-1), int(n_chunks[0])
    assert order.dtype == chunks.dtype == torch.int32 and chunks.shape == (b * nprobe, 3)
    assert sorted(order.tolist()) == list(range(b * nprobe))
    rows = chunks[:n].tolist()
    assert [start for _, start, _ in rows] == np.cumsum([0] + [cnt for _, _, cnt in rows[:-1]]).tolist()
    assert sum(cnt for _, _, cnt in rows) == b * nprobe and all(1 <= cnt <= port.CHUNK for _, _, cnt in rows)
    for i, (cluster, start, cnt) in enumerate(rows):
        pairs = order[start : start + cnt].long()
        assert (flat[pairs] == cluster).all() and pairs.tolist() == sorted(pairs.tolist())
        if i + 1 < n and rows[i + 1][0] == cluster:
            assert cnt == port.CHUNK
    assert [c for c, _, _ in rows] == sorted(c for c, _, _ in rows)
    assert {c for c, _, _ in rows} == set(flat.tolist())
