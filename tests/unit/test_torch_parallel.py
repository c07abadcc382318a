"""The port's multi-device tier (tensortruth_tpu_torch/parallel/, the sharded
IVF of ops/ivf.py, the DP embedder and reranker, the mesh engine) against the
reference's, on the CPU.

The port runs on meshes of N x ``cpu`` (``make_mesh(devices=["cpu"] * N)``),
the reference on the conftest's 8 virtual CPU devices; inputs are made with
numpy from a seed. The reference's Pallas kernels run in interpret mode, the
port's wrappers their plain versions (the tensors lie on the CPU).

* ``sharded_topk``: the same ids, scores within test_torch_topk.py's ATOL
  (1e-6: float32 sums of the same exact products in other orders), for
  float32 / bf16 / int8 corpora, exact and fused per shard, a 2 x 4 mesh
  with a data-split batch, trailing all-padding shards, negative-cosine rows
  beside shard padding, and k larger than the corpus (the cases of
  test_sharded_topk.py).
* Streaming placement equals array placement, bit for bit, and equals the
  reference's placement (test_streaming_placement.py's cases).
* ``shard_ivf`` + ``ivf_search_sharded`` over an index carried across with
  ``ivf_index_from_arrays``: the same rows, scores within 1e-5 (test_torch_ivf.py's tolerance).
* The DP embedder and reranker on 2 x 4 and 1 x 8 meshes against the
  reference's DP runtimes over the same weights: within 2e-5 (float32 weights,
  batch slices of other sizes; test_mesh_models.py's tolerance), batches
  padded to the same multiple.
* A mesh ``MultiIndexEngine`` and ``load_engine_for_modules`` with
  ``rag.mesh.enabled`` return the reference's nodes.
* ``my_row_range`` / ``my_cluster_range`` equal the reference's for the same
  world size and shard count.
* The dry run on CPU slots runs every stage, the multi-slice ones (2c: cluster
  groups sharded over the mesh; 2d: one group served by a slice-worker
  process on the CPU, rows equal to the all-local run's) included.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P
from test_torch_e2e import QUERIES, _port_model, _services, env, runtimes  # noqa: F401 (fixtures)
from test_torch_ivf import _ref_init
from test_torch_retrieval import _assert_same, _flat, _modules, _queries

from tensortruth_tpu.models import xlmr as ref_xlmr
from tensortruth_tpu.models.embedder import Embedder as RefEmbedder
from tensortruth_tpu.models.reranker import Reranker as RefReranker
from tensortruth_tpu.ops import ivf as ref_ivf
from tensortruth_tpu.parallel import distributed as ref_dist
from tensortruth_tpu.parallel import make_mesh as ref_make_mesh
from tensortruth_tpu.retrieval.engine import MultiIndexEngine as RefEngine
from tensortruth_tpu.tokenization import load_tokenizer as ref_load_tokenizer
from tensortruth_tpu_torch import engine as port_engine_mod
from tensortruth_tpu_torch.dryrun import dryrun_multidevice
from tensortruth_tpu_torch.models import manager as port_manager
from tensortruth_tpu_torch.models.embedder import Embedder
from tensortruth_tpu_torch.models.reranker import Reranker
from tensortruth_tpu_torch.ops import ivf as port_ivf
from tensortruth_tpu_torch.parallel import distributed as port_dist
from tensortruth_tpu_torch.parallel import mesh as port_mesh
from tensortruth_tpu_torch.retrieval.engine import MultiIndexEngine
from tensortruth_tpu_torch.tokenization import load_tokenizer

# the modules, not the functions of the same name that the packages export
ref_st = importlib.import_module("tensortruth_tpu.parallel.sharded_topk")
port_st = importlib.import_module("tensortruth_tpu_torch.parallel.sharded_topk")

torch.set_num_threads(1)

ATOL = 1e-6
IVF_ATOL = 1e-5
DP_TOL = 2e-5


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _port_mesh(n_shards=8, n_data=1):
    return port_mesh.make_mesh(n_shards=n_shards, n_data=n_data, devices=["cpu"] * (n_shards * n_data))


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 (both packages round to nearest even)."""
    return np.asarray(x.astype(ml_dtypes.bfloat16), np.float32)


# -- the mesh -------------------------------------------------------------------


def test_make_mesh_layout_and_errors():
    mesh = port_mesh.make_mesh(n_shards=4, n_data=2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "shards": 4} and mesh.size == 8
    assert mesh.lead == torch.device("cpu") and mesh.distinct == [torch.device("cpu")]
    assert mesh.shard_devices(3) == [torch.device("cpu")]
    assert port_mesh.make_mesh(n_data=2, devices=["cpu"] * 6).shape == {"data": 2, "shards": 3}
    with pytest.raises(ValueError, match="needs 9 devices"):
        port_mesh.make_mesh(n_shards=9, devices=["cpu"] * 8)
    if not torch.cuda.is_available():  # the default is the CUDA cards, never the CPU
        with pytest.raises(ValueError, match="no CUDA card"):
            port_mesh.make_mesh()


# -- sharded_topk ---------------------------------------------------------------

# (n, d, b, k, n_shards, n_data, q_sharded, corpus dtype, use_fused, tile_n)
SHARDED_CASES = {
    "float32_exact": (999, 32, 4, 7, 8, 1, False, "float32", False, None),
    "float32_exact_n64": (64, 32, 4, 5, 8, 1, False, "float32", False, None),
    "bf16_fused": (3000, 32, 4, 10, 8, 1, False, "bfloat16", True, 128),
    "int8_exact": (999, 32, 4, 10, 8, 1, False, "int8", False, None),
    "int8_fused": (3000, 32, 4, 10, 8, 1, False, "int8", True, 128),
    "q_sharded_2x4": (256, 16, 4, 5, 4, 2, True, "float32", False, None),
    "q_sharded_2x4_fused": (1000, 16, 4, 5, 4, 2, True, "bfloat16", True, 128),
    "trailing_padding_shards": (5, 16, 2, 4, 4, 1, False, "bfloat16", True, 128),
    "trailing_padding_shards_int8": (5, 16, 2, 4, 4, 1, False, "int8", True, 128),
    "padded_rows_k_eq_n": (13, 16, 2, 13, 8, 1, False, "float32", False, None),
    "k_larger_than_corpus": (6, 16, 1, 10, 8, 1, False, "float32", False, None),
    "k_larger_than_corpus_fused": (6, 16, 1, 10, 8, 1, False, "bfloat16", True, 128),
}


def _both_sharded(emb, q, k, n_shards, n_data, q_sharded, dtype, use_fused, tile_n):
    """(reference's, port's) sharded top-k of ``q`` over ``emb``."""
    ref_mesh = ref_make_mesh(n_shards=n_shards, n_data=n_data)
    mesh = _port_mesh(n_shards, n_data)
    q_dtype = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    if dtype == "int8":
        ref_emb, ref_scales, n = ref_st.shard_corpus_int8(emb, ref_mesh, tile_n=tile_n)
        port_emb, _ = port_st.shard_corpus_int8(emb, mesh, tile_n=tile_n)
    else:
        ref_in = emb if dtype == "float32" else emb.astype(ml_dtypes.bfloat16)
        ref_emb, n = ref_st.shard_corpus(ref_in, ref_mesh, tile_n=tile_n)
        ref_scales = None
        port_emb, _ = port_st.shard_corpus(torch.from_numpy(emb).to(q_dtype[1]), mesh, tile_n=tile_n)
    ref_q = jnp.asarray(q, q_dtype[0])
    if q_sharded:
        ref_q = jax.device_put(ref_q, NamedSharding(ref_mesh, P("data")))
    kw = dict(k=k, n_actual=n, use_fused=use_fused, q_sharded=q_sharded)
    if tile_n:
        kw["tile_n"] = tile_n
    want = ref_st.sharded_topk(ref_q, ref_emb, mesh=ref_mesh, scales=ref_scales, **kw)
    got = port_st.sharded_topk(torch.from_numpy(q).to(q_dtype[1]), port_emb, **kw)
    return [np.asarray(a, np.float32) for a in want], [t.float().numpy() for t in got]


@pytest.mark.parametrize("case", list(SHARDED_CASES))
def test_sharded_topk_matches_reference(case):
    n, d, b, k, n_shards, n_data, q_sharded, dtype, use_fused, tile_n = SHARDED_CASES[case]
    rng = np.random.default_rng(n + k)
    emb, q = _normed(rng, n, d), _normed(rng, b, d)
    (rv, ri), (pv, pi) = _both_sharded(emb, q, k, n_shards, n_data, q_sharded, dtype, use_fused, tile_n)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pv, rv, atol=ATOL, rtol=0)
    assert pi.shape == (b, k) and (pi[pv == -np.inf] == -1).all() and pi.max() < n
    if k >= n:  # every row comes back once, then -1 padding
        assert all(sorted(row[:n].tolist()) == list(range(n)) for row in pi)


@pytest.mark.parametrize("int8", [False, True])
def test_fused_n_valid_matches_reference(int8):
    """One shard's pass: rows at or past ``n_valid`` masked, the candidate
    geometry still that of all 512 rows (the reference's traced n_valid)."""
    from tensortruth_tpu.ops import topk as ref_topk
    from tensortruth_tpu_torch.ops import topk as port_topk

    rng = np.random.default_rng(11)
    emb, q = _normed(rng, 512, 32), _normed(rng, 3, 32)
    qb = jnp.asarray(q, jnp.bfloat16)
    qt = torch.from_numpy(q).bfloat16()
    if int8:
        e_q, scales = port_topk.quantize_corpus(emb)
        want = ref_topk.fused_topk_int8(qb, jnp.asarray(e_q), jnp.asarray(scales), 10, tile_n=128, n_valid=jnp.int32(300))
        got = port_topk.fused_topk_int8(qt, torch.from_numpy(e_q), torch.from_numpy(scales), 10, tile_n=128, n_valid=300)
    else:
        want = ref_topk.fused_topk(qb, jnp.asarray(emb, jnp.bfloat16), 10, tile_n=128, n_valid=jnp.int32(300))
        got = port_topk.fused_topk(qt, torch.from_numpy(emb).bfloat16(), 10, tile_n=128, n_valid=300)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0], np.float32), atol=ATOL, rtol=0)
    assert int(got[1].max()) < 300


@pytest.mark.parametrize("tile_n,use_fused", [(None, False), (128, False), (128, True)])
def test_negative_cosine_rows_survive_shard_padding(tile_n, use_fused):
    """Padding rows (score 0) must never displace real rows that all score
    below 0: the global top-13 is every row, in order."""
    rng = np.random.default_rng(0)
    d = 16
    q = _normed(rng, 1, d)
    base = _normed(rng, 13, d)
    emb = base - np.abs(base @ q.T) * q - 0.05 * q - (base @ q.T > 0) * 2 * (base @ q.T) * q
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    sims = (_bf16(emb) @ _bf16(q).T).ravel() if use_fused else (emb @ q.T).ravel()
    assert (sims < 0).all()
    dtype = "bfloat16" if use_fused else "float32"
    (rv, ri), (pv, pi) = _both_sharded(emb, q, 13, 8, 1, False, dtype, use_fused, tile_n)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pi[0], np.argsort(-sims, kind="stable"))
    np.testing.assert_allclose(pv, rv, atol=ATOL, rtol=0)


def test_plain_switch_and_the_kernel_wrappers_agree_on_the_cpu():
    """``plain=True`` (what chip_smoke holds the kernels against) is the
    same computation as the wrappers' CPU dispatch."""
    rng = np.random.default_rng(3)
    emb, q = torch.from_numpy(_normed(rng, 3000, 32)), torch.from_numpy(_normed(rng, 3, 32))
    for corpus in (port_st.shard_corpus(emb.bfloat16(), _port_mesh(4), tile_n=128)[0],
                   port_st.shard_corpus_int8(emb, _port_mesh(4), tile_n=128)[0]):
        kw = dict(k=9, n_actual=3000, use_fused=True, tile_n=128)
        a = port_st.sharded_topk(q.bfloat16(), corpus, **kw)
        b = port_st.sharded_topk(q.bfloat16(), corpus, plain=True, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_one_buffer_per_device_on_a_repeated_device_mesh():
    """A 2 x 4 mesh over one device holds each row shard once."""
    corpus, _ = port_st.shard_corpus(torch.ones((1000, 16)), _port_mesh(4, 2), tile_n=128)
    assert sorted(corpus.parts) == [0, 1, 2, 3] and all(len(by_dev) == 1 for by_dev in corpus.parts.values())
    assert corpus.shape == (1024, 16) and corpus.nbytes() == 1024 * 16 * 4


# -- streaming placement -----------------------------------------------------------


def _pieces(emb, sizes):
    return list(np.split(emb, np.cumsum(sizes)[:-1]))


@pytest.mark.parametrize("sizes", [[1000], [300, 500, 200], [999, 1]])
def test_bf16_streaming_equals_array_and_reference_placement(sizes):
    emb = _normed(np.random.default_rng(0), 1000, 32)
    mesh = _port_mesh()
    a, n_a = port_st.shard_corpus(torch.from_numpy(emb).bfloat16(), mesh, tile_n=128)
    b, n_b = port_st.shard_corpus_streaming(iter(_pieces(emb, sizes)), 1000, 32, mesh, tile_n=128)
    assert n_a == n_b == 1000 and a.shape == b.shape == (1024, 32) and a.dtype == b.dtype == torch.bfloat16
    assert torch.equal(a.to_host(), b.to_host())
    ref, _ = ref_st.shard_corpus_streaming(iter(_pieces(emb, sizes)), 1000, 32, ref_make_mesh(), tile_n=128)
    np.testing.assert_array_equal(b.to_host().float().numpy(), np.asarray(ref, np.float32))


def test_int8_streaming_equals_array_and_reference_placement():
    emb = _normed(np.random.default_rng(0), 770, 32)
    mesh = _port_mesh()
    qa, _ = port_st.shard_corpus_int8(emb, mesh, tile_n=128)
    qb, _ = port_st.shard_corpus_int8_streaming(iter(_pieces(emb, [256, 256, 258])), 770, 32, mesh, tile_n=128)
    assert torch.equal(qa.to_host(), qb.to_host())
    scales = [torch.cat([qx.scales[s][torch.device("cpu")] for s in range(8)]) for qx in (qa, qb)]
    assert torch.equal(*scales) and (scales[0][770:] == 0).all()
    ref_q, ref_s, _ = ref_st.shard_corpus_int8_streaming(iter(_pieces(emb, [256, 256, 258])), 770, 32,
                                                         ref_make_mesh(), tile_n=128)
    np.testing.assert_array_equal(qb.to_host().numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(scales[1].numpy(), np.asarray(ref_s))


def test_streaming_row_count_mismatch_raises():
    emb = _normed(np.random.default_rng(0), 100, 8)
    with pytest.raises(RuntimeError, match="supplied 100 rows"):
        port_st.shard_corpus_streaming(iter([emb]), 200, 8, _port_mesh())


# -- the cluster-sharded IVF ---------------------------------------------------------


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def ivf_pair(request):
    """(corpus, reference index, the port's copy of it) with 12 clusters:
    padded to 16 over 8 shards."""
    emb = _normed(np.random.default_rng(0), 3000, 32)
    index = ref_ivf.build_ivf(emb, n_clusters=12, sample_size=2000, kmeans_iters=4,
                              block_dtype=getattr(jnp, request.param), device_blocks=False)
    carried = port_ivf.ivf_index_from_arrays(
        np.asarray(index.centroids), np.asarray(index.blocks), index.row_map, index.n_actual,
        scales=None if index.scales is None else np.asarray(index.scales), device="cpu",
    )
    return emb, index, carried


@pytest.mark.parametrize("b,k,nprobe", [(3, 10, 1), (4, 20, 2), (1, 5000, 8)])
def test_sharded_ivf_matches_reference(ivf_pair, b, k, nprobe):
    emb, index, carried = ivf_pair
    q = _normed(np.random.default_rng(b), b, 32)
    want = ref_ivf.ivf_search_sharded(ref_ivf.shard_ivf(index, ref_make_mesh()), q, k, nprobe=nprobe)
    sidx = port_ivf.shard_ivf(carried, _port_mesh())
    assert sidx.cpl == 2 and sidx.row_map.shape == (16, carried.rows_per_cluster)
    got = port_ivf.ivf_search_sharded(sidx, q, k, nprobe=nprobe)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=IVF_ATOL, rtol=0)
    plain = port_ivf.ivf_search_sharded(sidx, q, k, nprobe=nprobe, plain=True)
    np.testing.assert_array_equal(plain[1], got[1])


def test_sharded_ivf_probing_everything_is_the_single_device_search(ivf_pair):
    emb, _, carried = ivf_pair
    q = _normed(np.random.default_rng(5), 4, 32)
    want = port_ivf.ivf_search(carried, q, 8, nprobe=12)
    got = port_ivf.ivf_search_sharded(port_ivf.shard_ivf(carried, _port_mesh(4, 2)), q, 8, nprobe=12)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=IVF_ATOL, rtol=0)


def test_build_ivf_host_blocks_search_identically():
    emb = _normed(np.random.default_rng(1), 1500, 16)
    kw = dict(n_clusters=6, sample_size=300, kmeans_iters=3, seed=3, device="cpu")
    dev, host = port_ivf.build_ivf(emb, **kw), port_ivf.build_ivf(emb, device_blocks=False, **kw)
    assert host.blocks.device.type == "cpu" and torch.equal(dev.blocks, host.blocks)
    q = _normed(np.random.default_rng(2), 4, 16)
    v_dev, r_dev = port_ivf.ivf_search(dev, q, 8, nprobe=6)
    v_sh, r_sh = port_ivf.ivf_search_sharded(port_ivf.shard_ivf(host, _port_mesh()), q, 8, nprobe=6)
    np.testing.assert_array_equal(r_dev, r_sh)
    np.testing.assert_allclose(v_dev, v_sh, atol=IVF_ATOL, rtol=0)


# -- DP embedder and reranker -------------------------------------------------------

TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, max_position=130)


def _dp_pair(role, mesh_shape, seed, cfg_kw=None, **kw):
    """(reference DP runtime, port DP runtime, port single-device runtime)
    over the same float32 weights."""
    cfg = ref_xlmr.XLMRConfig(**TINY, **(cfg_kw or {}))
    params = ref_xlmr.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32)
    ref_cls, cls = (RefEmbedder, Embedder) if role == "embedder" else (RefReranker, Reranker)
    sep = "bert" if cfg.position_style == "bert" else "xlmr"
    ref_tok, tok = ref_load_tokenizer(sep_style=sep), load_tokenizer(sep_style=sep)
    n_shards, n_data = mesh_shape
    ref_rt = ref_cls(params, cfg, ref_tok, max_length=128, mesh=ref_make_mesh(n_shards=n_shards, n_data=n_data), **kw)
    dp = cls(_port_model(cfg, params), tok, max_length=128, mesh=_port_mesh(n_shards, n_data), **kw)
    single = cls(_port_model(cfg, params), tok, max_length=128, **kw)
    return ref_rt, dp, single


def test_dp_embedder_matches_reference_on_2x4():
    ref_rt, dp, single = _dp_pair("embedder", (4, 2), seed=7)
    texts = [f"sharded retrieval question number {i}" for i in range(11)]
    want, got = ref_rt.encode(texts), dp.encode(texts)
    np.testing.assert_allclose(got, want, rtol=DP_TOL, atol=DP_TOL)
    np.testing.assert_allclose(got, single.encode(texts), rtol=DP_TOL, atol=DP_TOL)
    assert dp._batch_multiple == ref_rt._batch_multiple == 8


@pytest.mark.parametrize("cfg_kw", [None, {"position_style": "bert", "type_vocab_size": 2}],
                         ids=["xlmr", "bert_type_ids"])
def test_dp_reranker_matches_reference_on_1x8(cfg_kw):
    ref_rt, dp, single = _dp_pair("reranker", (8, 1), seed=3, cfg_kw={"num_labels": 1, **(cfg_kw or {})})
    assert dp._needs_type_ids == ref_rt._needs_type_ids == bool(cfg_kw)
    docs = [f"document text {i} about collectives and meshes" for i in range(13)]
    np.testing.assert_allclose(dp.score("what is mesh sharding", docs), ref_rt.score("what is mesh sharding", docs),
                               rtol=DP_TOL, atol=DP_TOL)
    pairs = [(f"q{i}", f"doc body {i}") for i in range(9)]
    got = dp.score_pairs(pairs)
    np.testing.assert_allclose(got, ref_rt.score_pairs(pairs), rtol=DP_TOL, atol=DP_TOL)
    np.testing.assert_allclose(got, single.score_pairs(pairs), rtol=DP_TOL, atol=DP_TOL)


def test_dp_batch_padding_is_a_mesh_multiple():
    ref_rt, dp, _ = _dp_pair("reranker", (4, 2), seed=0, cfg_kw={"num_labels": 1}, batch_buckets=(4, 12))
    docs = [f"d{i}" for i in range(10)]
    seen = []
    fwd = dp._fwd
    dp._fwd = lambda *arrays: (seen.append(arrays[0].shape[0]), fwd(*arrays))[1]
    got = dp.score("q", docs)
    assert got.shape == (10,) and seen == [8, 8, 8]  # groups of 4, 4, 2 pairs, bucket 4 rounded up to 8
    np.testing.assert_allclose(got, ref_rt.score("q", docs), rtol=DP_TOL, atol=DP_TOL)


def test_manager_keys_the_mesh_by_value(monkeypatch):
    """A mesh built anew with the same shape and devices reuses the resident
    model; another mesh, or a named device, reloads; no device and no mesh
    reuses whatever is resident (the reference's ``_mesh_desc`` rule)."""
    port_manager.ModelManager.reset_instance()
    try:
        mgr = port_manager.ModelManager.get_instance()
        spec = port_manager.ModelSpec("tiny-embedder")
        emb = mgr.get_embedder(spec, mesh=_port_mesh(4, 2))
        assert emb.mesh.shape == {"data": 2, "shards": 4} and emb.device == torch.device("cpu")
        assert mgr.get_embedder(spec, mesh=_port_mesh(4, 2)) is emb
        assert mgr.get_embedder(spec) is emb
        match = port_manager.ModelManager._key_matches
        key = mgr._embedder_key
        assert key[-1] == _port_mesh(4, 2).describe()
        assert not match(key, spec, None, _port_mesh(8, 1)) and not match(key, spec, "cpu")
        assert mgr.get_embedder(spec, device="cpu") is not emb
    finally:
        port_manager.ModelManager.reset_instance()


# -- the mesh engine ---------------------------------------------------------------

# (corpus dtype, use_fused, IVF threshold)
ENGINE_CASES = {
    "bf16": ("bfloat16", False, 2_000_000),
    "bf16_fused": ("bfloat16", True, 2_000_000),
    "float32": ("float32", False, 2_000_000),
    "int8": ("int8", False, 2_000_000),
    "int8_fused": ("int8", True, 2_000_000),
    "ivf_bf16": ("bfloat16", False, 40),  # 375 rows >= 40 x 8 shards
    "ivf_int8": ("int8", False, 20),  # >= 20 x 8 shards x 2
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_mesh_engine_matches_reference(monkeypatch, case):
    corpus_dtype, use_fused, threshold = ENGINE_CASES[case]
    monkeypatch.setattr(port_ivf, "_init_indices", _ref_init)
    ref_indexes, indexes = _modules((60, 25, 40))
    kw = dict(similarity_top_k=10, corpus_dtype=corpus_dtype, use_fused=use_fused, ivf_threshold=threshold,
              ivf_clusters=16, ivf_nprobe=2)
    want_engine = RefEngine(ref_indexes, mesh=ref_make_mesh(), **kw)
    got_engine = MultiIndexEngine(indexes, mesh=_port_mesh(), **kw)
    if threshold < 100:
        assert got_engine._ivf_sharded is got_engine._stacked and got_engine._ivf is None
        np.testing.assert_array_equal(got_engine._ivf_sharded.row_map, want_engine._ivf_sharded.row_map)
    else:
        assert got_engine._stacked.n_pad == want_engine._stacked.shape[0]
        assert got_engine._stacked.dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32,
                                             "int8": torch.int8}[corpus_dtype]
    assert got_engine.device == torch.device("cpu") and got_engine.n_chunks == 375
    q = _queries(indexes)
    _assert_same(_flat(want_engine.retrieve_batch(q)), _flat(got_engine.retrieve_batch(q)))


def test_mesh_engine_builds_every_tier_and_refreshes():
    """Each mesh tier builds and answers (the test that once expected a
    refusal is test_torch_retrieval.py::test_engine_refuses_unported_tiers)."""
    _, indexes = _modules((60, 25))
    mesh = _port_mesh(4, 2)
    flat = MultiIndexEngine(indexes, mesh=mesh)
    ivf = MultiIndexEngine(indexes, mesh=mesh, ivf_threshold=10, ivf_clusters=4)
    for eng in (flat, ivf):
        assert all(eng.retrieve_batch(_queries(indexes)))
    assert set(flat.placement_seconds) == {"shard"} and "shard" in ivf.placement_seconds
    flat.refresh()
    assert flat._stacked.mesh is mesh


def test_load_engine_with_rag_mesh_enabled_matches_reference(env, monkeypatch):  # noqa: F811
    """``rag.mesh.enabled`` in both configs: each factory builds a 2 x 4
    mesh (the port's over 8 CPU slots, standing in for the cards), neither
    uses the fused query step, and the reranked sources and gate agree."""
    monkeypatch.setattr(port_mesh, "local_devices", lambda: [torch.device("cpu")] * 8)
    _, cfgs = env
    for cfg in cfgs:
        cfg.rag.mesh = {"enabled": True, "n_data": 2, "n_shards": 4}
    ref_svc, port_svc, _ = _services(env, {"reranker_top_n": 3, "corpus_dtype": "float32"})
    assert port_svc.engine.retriever.mesh.shape == dict(ref_svc.engine.retriever.mesh.shape)
    assert port_svc.engine.pipeline is None and ref_svc.engine.pipeline is None
    for text in QUERIES:
        want, got = ref_svc.retrieve(text), port_svc.retrieve(text)
        assert [s.id for s in got.sources] == [s.id for s in want.sources] and got.sources
        np.testing.assert_allclose([s.score for s in got.sources], [s.score for s in want.sources], atol=1e-5)
        assert got.confidence == want.confidence


def test_load_engine_passes_the_mesh_to_the_models(env, monkeypatch):  # noqa: F811
    seen = {}
    mgr = port_manager.ModelManager.get_instance()
    for role in ("embedder", "reranker"):
        inner = getattr(mgr, f"get_{role}")
        def get(spec=None, _f=inner, _r=role, **kw):
            seen[_r] = kw
            return _f()

        monkeypatch.setattr(mgr, f"get_{role}", get)
    mesh = _port_mesh(2, 2)
    engine = port_engine_mod.load_engine_for_modules(["alpha"], {"reranker_top_n": 3}, indexes_dir=env[0] / "indexes",
                                                     config=env[1][1], mesh=mesh)
    assert engine.retriever.mesh is mesh
    assert seen == {role: {"device": torch.device("cpu"), "mesh": mesh} for role in ("embedder", "reranker")}


# -- the global mesh's row and cluster ranges -----------------------------------------


def _ref_range(fn, world, rank, n_data, *args):
    """The reference's range for process ``rank`` of ``world``, each with
    8 / world of the 8 virtual devices: only those are addressable."""
    per = 8 // world
    mine = {d.id for d in jax.devices()[rank * per : (rank + 1) * per]}

    class Addressable:
        def __init__(self, mesh, spec):
            self.sharding = NamedSharding(mesh, spec)

        def addressable_devices_indices_map(self, shape):
            return {d: i for d, i in self.sharding.devices_indices_map(shape).items() if d.id in mine}

    saved = ref_dist.NamedSharding
    ref_dist.NamedSharding = Addressable
    try:
        return fn(ref_make_mesh(n_data=n_data), *args)
    finally:
        ref_dist.NamedSharding = saved


@pytest.mark.parametrize("world,n_data", [(1, 1), (2, 1), (4, 1), (8, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("n_total,tile_n", [(1000, 64), (800, 0), (5, 2048), (2_097_152, 2048)])
def test_row_and_cluster_ranges_match_reference(world, n_data, n_total, tile_n):
    for rank in range(world):
        mesh = port_dist.process_mesh(world, rank, ["cpu"] * (8 // world), n_data)
        assert port_dist.my_row_range(mesh, n_total, tile_n) == _ref_range(ref_dist.my_row_range, world, rank, n_data,
                                                                           n_total, tile_n)
        for n_clusters in (16, 13, 1024):
            assert port_dist.my_cluster_range(mesh, n_clusters) == _ref_range(ref_dist.my_cluster_range, world, rank,
                                                                              n_data, n_clusters)


# -- the dry run ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 3])
def test_dryrun_multidevice_on_cpu_slots(n):
    out = dryrun_multidevice(n, ["cpu"] * n)
    b = 4 if n == 8 else 2
    assert out["mesh"] == ({"data": 2, "shards": 4} if n == 8 else {"data": 1, "shards": 3})
    assert out["embed"] == (b, 64) and out["topk"] == (b, 4) and out["ivf"] == (b, 4)
    # stages 2c and 2d: the multi-slice tier, in process and across a worker process
    assert out["multislice"] == (b, 4) and out["multislice_remote"] == (b, 4)
    assert out["rerank_batch"] % n == 0 and out["rerank_batch"] >= out["pairs"]
