"""The port's headline drivers against the reference's, on the CPU at small sizes.

The reference's drivers (``bench.py``, ``scripts/bench_configs.py``,
``scripts/probe_seq_buckets.py``, ``scripts/probe_ivf_build.py``) set a JAX
compilation cache at import or run their whole measurement at import, so
they are never imported here: :func:`_reference` reads a script's syntax
tree and executes only the named definitions and assignments (its
functions, constants, or the statements of one function's body) in a fresh
namespace, which then calls the JAX package as the script would.

* (a) ``probe_seq_buckets.build_pairs`` and ``token_rows`` (``CURRENT`` and
  ``FINER``) equal the reference's, and so do the bench's chunk pool and
  queries, which both drivers build with one helper.
* (b) At the reference's ``BENCH_TINY`` architecture, with its
  ``init_params(PRNGKey(0))`` weights carried across by ``params_from_jax``,
  the bench's fused step (kernel B1's plain version over 6,000 bf16 rows,
  past the 4096-row exact cut-over) against the reference's ``embed_topk``
  (its ``fused_topk`` in interpret mode) over the same corpus: equal ids,
  scores within 2e-3 (``test_torch_e2e.py``'s bound for a bf16 corpus); and
  the bench's rerank of its own pairs against the reference's
  ``Reranker.score_pairs``, within 1e-5 (its bound for float32 math). The
  weights are float32, as in ``test_torch_e2e.py``: the two packages' bf16
  forwards round differently (query embeddings up to 1.5e-3 apart at this
  architecture), enough to reorder rows whose scores lie closer.
* (c) Every round of the double-buffered serving loop gives the scores of
  a sequential ``score_pairs`` of its pairs, bit for bit; ``measure`` gives
  the reference's headline keys.
* (d) ``measure_rerank_serving``'s blocking and async scores are bit-equal.
* (e) Configs 1, 2, 4 and 5 at reduced sizes with the reference's seeds:
  ids equal to the reference's (config 5 over the reference's index carried
  across, since the two packages' k-means seeds differ by design; config
  4's B1 against the reference's interpret-mode kernel may swap two rows
  whose scores lie within 1e-6, as two f32 summation orders can); each
  line is what the reference's ``emit`` prints; ``_corpus`` drawn in row
  pieces equals the whole draw.
* (f) ``probe_ivf_build``'s stages carry the reference's names, and its
  sample gather equals the reference's ``_sample_rows``.
* Every driver refuses the CPU at full size and CUDA without a card.
"""

import ast
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensortruth_tpu.index.nodes import HierarchyStore as RefHierarchyStore
from tensortruth_tpu.index.nodes import Node as RefNode
from tensortruth_tpu.index.store import VectorIndex as RefVectorIndex
from tensortruth_tpu.models import xlmr as ref_xlmr
from tensortruth_tpu.models.reranker import Reranker as RefReranker
from tensortruth_tpu.ops import ivf as ref_ivf
from tensortruth_tpu.ops import topk as ref_topk
from tensortruth_tpu.pipeline import embed_topk as ref_embed_topk
from tensortruth_tpu.retrieval.engine import MultiIndexEngine as RefEngine
from tensortruth_tpu.tokenization import SimpleTokenizer as RefTokenizer
from tensortruth_tpu.tokenization import load_tokenizer as ref_load_tokenizer
from tensortruth_tpu_torch.models import xlmr as port_xlmr
from tensortruth_tpu_torch.models.embedder import bucket
from tensortruth_tpu_torch.models.reranker import Reranker
from tensortruth_tpu_torch.ops.ivf import ivf_index_from_arrays
from tensortruth_tpu_torch.ops.topk import check_topk_agrees
from tensortruth_tpu_torch.scripts import bench, bench_configs, measure_rerank_serving, probe_ivf_build, probe_seq_buckets

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[2]
BF16_TOL = 2e-3  # test_torch_e2e.py: retrieval scores over a bf16 corpus
F32_TOL = 1e-5  # test_torch_e2e.py: float32 math in other orders
# Two f32 sums of the same 1024 exact bf16 products in other orders differ by
# a few ulps (1e-8 at these scores): rows closer than that may swap.
SUM_ORDER_TOL = 1e-6
# A one-layer, one-head model: the loops' logic at the least CPU time.
MICRO = dict(vocab_size=512, hidden_size=32, num_layers=1, num_heads=1, intermediate_size=64, max_position=2052)


def _reference(script: str, names, within: str | None = None, **ns) -> dict:
    """Execute the definitions and assignments named ``names`` of the
    reference's ``script`` (top level, or anywhere in function ``within``)
    in a namespace seeded with ``ns``; returns the namespace."""
    tree = ast.parse((REPO / script).read_text(encoding="utf-8"))
    body = tree.body
    if within is not None:  # any statement of the function, nested in a block or not
        (fn,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == within]
        body = sorted((n for n in ast.walk(fn) if isinstance(n, (ast.FunctionDef, ast.Assign)) and n is not fn),
                      key=lambda n: n.lineno)
    ns = {"np": np, "jnp": jnp, "json": json, **ns}
    for node in body:
        if isinstance(node, ast.FunctionDef):
            named = {node.name}
        elif isinstance(node, ast.Assign):  # ``a = ...`` or ``a, b = ...``
            named = {n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)}
        else:
            continue
        if named & set(names):
            exec(compile(ast.Module([node], type_ignores=[]), script, "exec"), ns)
    missing = set(names) - set(ns)
    assert not missing, (script, missing)
    return ns


def _string_args(script: str, func: str, call: str) -> list[str]:
    """The first string argument of each ``call(...)`` (or decorator) in
    function ``func`` of the reference's ``script`` (the module when None),
    in source order."""
    tree = ast.parse((REPO / script).read_text(encoding="utf-8"))
    root = tree if func is None else next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    found = [n for n in ast.walk(root) if isinstance(n, ast.Call) and getattr(n.func, "id", None) == call
             and n.args and isinstance(n.args[0], ast.Constant)]
    return [n.args[0].value for n in sorted(found, key=lambda n: (n.lineno, n.col_offset))]


def _port_model(cfg, params, dtype):
    tcfg = port_xlmr.XLMRConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return port_xlmr.XLMRModel.from_state_dict(tcfg, port_xlmr.params_from_jax(np_params), "cpu", dtype)


def _micro_bench(n: int = 6000) -> bench.Bench:
    cfg = port_xlmr.XLMRConfig(**MICRO)
    corpus = np.random.default_rng(3).standard_normal((n, MICRO["hidden_size"])).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    return bench.setup("cpu", tiny=True, embedder=port_xlmr.XLMRModel.random_init(cfg, "cpu", seed=0),
                       reranker=port_xlmr.XLMRModel.random_init(port_xlmr.XLMRConfig(num_labels=1, **MICRO), "cpu",
                                                                seed=1),
                       corpus=corpus)


# -- (a) pairs, pool and token rows ----------------------------------------------------------


def test_pairs_pool_and_token_rows_equal_the_references():
    ref = _reference("scripts/probe_seq_buckets.py",
                     ["BATCH", "RERANK_TOP", "N_PAIRS", "_CHUNK_WORDS", "_POOL_SIZE", "CURRENT", "FINER",
                      "build_pairs", "token_rows"])
    tok, ref_tok = probe_seq_buckets.SimpleTokenizer(vocab_size=512), RefTokenizer(vocab_size=512)
    pairs = probe_seq_buckets.build_pairs()
    assert pairs == ref["build_pairs"](ref_tok) and len(pairs) == probe_seq_buckets.N_PAIRS == ref["N_PAIRS"]
    assert (probe_seq_buckets.CURRENT, probe_seq_buckets.FINER) == (ref["CURRENT"], ref["FINER"])
    model = port_xlmr.XLMRModel.random_init(port_xlmr.XLMRConfig(num_labels=1, **MICRO), "cpu", seed=0)
    for buckets in (ref["CURRENT"], ref["FINER"]):
        rr = Reranker(model, tok, seq_buckets=buckets)
        want = ref["token_rows"](types.SimpleNamespace(tokenizer=ref_tok, max_length=2048, seq_buckets=buckets), pairs)
        got = probe_seq_buckets.token_rows(rr, pairs)
        assert got[0] == want[0] and np.array_equal(got[1], want[1])

    top = _reference("bench.py", ["BATCH", "_CHUNK_WORDS", "_POOL_SIZE", "RERANK_TOP", "SEQ_PAIR", "TOP_K", "SEQ_Q",
                                  "N_CHUNKS", "DIM", "REFERENCE_BASELINE_QPS_CPU", "REFERENCE_BASELINE_QPS_GPU_EST"])
    main = _reference("bench.py", ["words", "pool", "queries"], within="main", **top)
    assert bench.make_pool() == main["pool"] and bench.make_queries() == main["queries"]
    for name in ("BATCH", "SEQ_Q", "N_CHUNKS", "DIM", "TOP_K", "RERANK_TOP", "SEQ_PAIR", "_CHUNK_WORDS", "_POOL_SIZE",
                 "REFERENCE_BASELINE_QPS_CPU", "REFERENCE_BASELINE_QPS_GPU_EST"):
        assert getattr(bench, name) == top[name], name


# -- (b) the fused step and the rerank at BENCH_TINY --------------------------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    """(port Bench, reference params, reference configs, padded corpus) at the
    reference's BENCH_TINY architecture, weights carried across."""
    tiny = _reference("bench.py", ["tiny"], within="main", dict=dict)["tiny"]
    assert tiny == bench.TINY_CONFIG
    ecfg, rcfg = ref_xlmr.XLMRConfig(**tiny), ref_xlmr.XLMRConfig(num_labels=1, **tiny)
    key = jax.random.PRNGKey(0)
    ep = ref_xlmr.init_params(ecfg, key, dtype=jnp.float32)
    rp = ref_xlmr.init_params(rcfg, key, dtype=jnp.float32)
    # the reference's corpus recipe, at the port's tiny size
    corpus = jax.random.normal(key, (bench.TINY_N_CHUNKS, bench.TINY_DIM), dtype=jnp.bfloat16)
    corpus = corpus / jnp.linalg.norm(corpus.astype(jnp.float32), axis=1, keepdims=True).astype(jnp.bfloat16)
    corpus = np.asarray(corpus.astype(jnp.float32))
    port = bench.setup("cpu", tiny=True, embedder=_port_model(ecfg, ep, torch.float32),
                       reranker=_port_model(rcfg, rp, torch.float32), corpus=corpus)
    return port, (ep, rp), (ecfg, rcfg), corpus


def test_fused_step_matches_reference_embed_topk(tiny_pair):
    port, (ep, _), (ecfg, _), corpus = tiny_pair
    assert port.n_chunks == bench.TINY_N_CHUNKS > 4096 and port.corpus.shape[0] % 2048 == 0
    with torch.inference_mode():
        vals, idx = port.fused_step()
    padded = jnp.asarray(np.asarray(port.corpus.float()), dtype=jnp.bfloat16)
    ones = jnp.ones((bench.BATCH, bench.SEQ_Q), jnp.int32)
    want_v, want_i = ref_embed_topk(ep, ones, ones, padded, cfg=ecfg, k=bench.TOP_K, n_actual=bench.TINY_N_CHUNKS,
                                    use_fused=True)
    assert np.array_equal(idx.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(vals.numpy(), np.asarray(want_v), atol=BF16_TOL, rtol=0)
    assert (idx.numpy() < bench.TINY_N_CHUNKS).all() and np.array_equal(np.asarray(padded[:6000], np.float32), corpus)


def test_bench_rerank_matches_reference_score_pairs(tiny_pair):
    port, (_, rp), (_, rcfg), _ = tiny_pair
    with torch.inference_mode():
        idx = port.fused_step()[1].numpy()[:, : bench.RERANK_TOP]
    # all 32 queries embed the same ids, so 4 of them hold every distinct chunk
    pairs = port.build_pairs(idx)[: 4 * bench.RERANK_TOP]
    _, lengths = probe_seq_buckets.token_rows(port.reranker, pairs)
    assert len({bucket(int(n), port.reranker.seq_buckets) for n in lengths}) > 1  # more than one seq bucket
    want = RefReranker(rp, rcfg, ref_load_tokenizer()).score_pairs(pairs)
    got = port.reranker.score_pairs(pairs)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


# -- (c) the double-buffered loop ------------------------------------------------------------


def test_every_serving_round_equals_sequential_score_pairs():
    b = _micro_bench()
    record = []
    with torch.inference_mode():
        b.warm()
        stats = b.serve(rounds=3, record=record)
    assert len(record) == stats["rounds"] == 3 and stats["pending_at_readback"] == 0  # nothing pends on the CPU
    for pairs, scores in record:
        assert len(pairs) == bench.BATCH * bench.RERANK_TOP
        assert np.array_equal(scores, b.reranker.score_pairs(pairs))
    line = bench.headline(bench.measure(b))
    ref = _reference("bench.py", ["stages"], within="main", round=lambda *a: 0.0, jax=jax, n_chunks=0,
                     **{v: 0.0 for v in ("t_embed", "t_embed_min", "t_topk", "t_topk_min", "t_fused", "t_fused_min",
                                         "t_rerank", "t_serve", "t_pipe")})
    assert set(line["detail"]) - {"card"} == set(ref["stages"]) and line["detail"]["backend"] == "cpu"
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "vs_baseline_cpu", "vs_baseline_gpu_est", "detail"}
    assert line["metric"] == "query_throughput_1M_retrieve_rerank" and line["value"] > 0


# -- (d) blocking against async rerank -------------------------------------------------------


def test_blocking_and_async_rerank_scores_are_bit_equal():
    cfg = port_xlmr.XLMRConfig(num_labels=1, **MICRO)
    rr = Reranker.random_init(cfg, probe_seq_buckets.SimpleTokenizer(vocab_size=512), "cpu")
    pairs = measure_rerank_serving.make_pairs()
    got = measure_rerank_serving.blocking_score_pairs(rr, pairs)
    assert len(pairs) == 320 and np.array_equal(got, rr.score_pairs(pairs))


# -- (e) configs 1, 2, 4 and 5 ---------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_configs():
    return _reference("scripts/bench_configs.py", ["B", "D", "K", "_corpus", "emit"])


def test_corpus_in_row_pieces_is_the_whole_draw(ref_configs):
    rng, ref_rng = np.random.default_rng(5), np.random.default_rng(5)
    got = bench_configs._corpus(rng, 50, 16, piece_rows=7)
    assert np.array_equal(got, ref_configs["_corpus"](ref_rng, 50, 16))
    assert rng.standard_normal() == ref_rng.standard_normal()  # both generators left in one state


def test_config_lines_are_the_reference_emit(ref_configs, capsys):
    for args in (("1:arxiv-2k-flat", 2048, 0.004321), ("4:1M-fused-topk", 10_000, 0.0123, {"k": 100})):
        ref_configs["emit"](*args)
        assert bench_configs.line(*args) == json.loads(capsys.readouterr().out)


def _check_lines(lines, names, ref_configs, capsys):
    assert [entry["config"] for entry in lines] == names
    for entry in lines:
        extra = {k: v for k, v in entry.items() if k not in ("config", "n_chunks", "ms_per_batch", "qps")}
        seconds = bench_configs.B / entry["qps"]
        ref_configs["emit"](entry["config"], entry["n_chunks"], seconds, extra)
        assert set(json.loads(capsys.readouterr().out)) == set(entry)


def test_config1_ids_equal_reference(ref_configs, capsys):
    lines, ((_, ids),) = bench_configs.config1("cpu", tiny=True)
    rng = np.random.default_rng(1)
    emb = jnp.asarray(ref_configs["_corpus"](rng, 2048), jnp.bfloat16)
    q = jnp.asarray(ref_configs["_corpus"](rng, 32), jnp.bfloat16)
    assert np.array_equal(ids, np.asarray(ref_topk.exact_topk(q, emb, 10)[1]))
    _check_lines(lines, _string_args("scripts/bench_configs.py", "config1", "emit"), ref_configs, capsys)


def test_config2_node_ids_equal_reference(ref_configs, capsys):
    lines, (got,) = bench_configs.config2("cpu", tiny=True)
    ns = _reference("scripts/bench_configs.py", ["make_index"], within="config2", Node=RefNode,
                    HierarchyStore=RefHierarchyStore, VectorIndex=RefVectorIndex, _corpus=ref_configs["_corpus"],
                    rng=np.random.default_rng(2))
    n_parents = bench_configs.TINY["n2_parents"]
    indexes = {"api_a": ns["make_index"](n_parents, "a"), "api_b": ns["make_index"](n_parents, "b")}
    engine = RefEngine(indexes, similarity_top_k=10, use_fused=True)
    want = engine.retrieve_batch(ref_configs["_corpus"](ns["rng"], 32))
    assert got == [[r.node_id for r in res] for res in want] and all(got)
    assert lines[0]["n_chunks"] == 8 * n_parents
    _check_lines(lines, _string_args("scripts/bench_configs.py", "config2", "emit"), ref_configs, capsys)


def test_config4_ids_equal_reference(ref_configs, capsys):
    lines, (got,) = bench_configs.config4("cpu", tiny=True)
    rng = np.random.default_rng(4)
    n = bench_configs.TINY["n4"]
    emb, n_actual = ref_topk.pad_corpus_for_fused(ref_configs["_corpus"](rng, n, dtype=np.float32).astype(jnp.bfloat16))
    q = jnp.asarray(ref_configs["_corpus"](rng, 32), jnp.bfloat16)
    want = ref_topk.fused_topk(q, jnp.asarray(emb), 100, n_actual=n_actual)
    assert n % 2048 and n_actual == n
    # ids equal but where two rows' scores lie within f32 summation noise (one such pair at this seed)
    _, swapped = check_topk_agrees("config 4", *(tuple(torch.from_numpy(np.array(a)) for a in r) for r in (got, want)),
                                   SUM_ORDER_TOL)
    assert swapped <= 2
    _check_lines(lines, _string_args("scripts/bench_configs.py", "config4", "emit"), ref_configs, capsys)


def test_config5_over_the_reference_index_equals_reference(ref_configs, capsys):
    rng, emb = bench_configs.corpus5(tiny=True)
    ref_rng = np.random.default_rng(5)
    assert np.array_equal(emb, ref_configs["_corpus"](ref_rng, bench_configs.TINY["n5"], dtype=np.float32))
    index = ref_ivf.build_ivf(emb, **bench_configs.TINY["ivf5"])
    carried = ivf_index_from_arrays(np.asarray(index.centroids), np.asarray(index.blocks), index.row_map,
                                    index.n_actual, device="cpu")
    lines, ((_, rows4), (_, rows32)) = bench_configs.config5("cpu", tiny=True, prepared=(rng, carried, 1.25))
    for rows, b, nprobe in ((rows4, 4, 8), (rows32, 32, 16)):
        want = ref_ivf.ivf_search(index, ref_configs["_corpus"](ref_rng, b), 10, nprobe=nprobe)[1]
        assert rows.shape == (b, 10) and np.array_equal(rows, want), nprobe
    # the B = 4 line is a literal dict in the reference, the B = 32 line its emit
    tree = ast.parse((REPO / "scripts/bench_configs.py").read_text(encoding="utf-8"))
    config5 = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "config5")
    (literal,) = [n for n in ast.walk(config5) if isinstance(n, ast.Dict) and any(
        isinstance(k, ast.Constant) and k.value == "config" for k in n.keys)]
    assert list(lines[0]) == [k.value for k in literal.keys] and lines[0]["config"] == literal.values[0].value
    assert lines[0]["build_s"] == lines[1]["build_s"] == 1.2 and lines[1]["n_clusters"] == 32
    _check_lines(lines[1:], _string_args("scripts/bench_configs.py", "config5", "emit"), ref_configs, capsys)


# -- (f) the IVF build probe -----------------------------------------------------------------


def test_ivf_build_probe_stages_and_sample_equal_reference():
    assert probe_ivf_build.STAGES == tuple(_string_args("scripts/probe_ivf_build.py", None, "stage"))
    out = probe_ivf_build.run("cpu", tiny=True)
    assert tuple(out["stages_s"]) == probe_ivf_build.STAGES
    assert list(out["build_seconds"]) == ["sample", "kmeans", "assign", "place", "scatter"]
    assert out["index"].n_actual == out["n_rows"] == probe_ivf_build.TINY["n"]
    emb = probe_ivf_build.draw_corpus(1000, 16)
    rows = np.sort(np.random.default_rng(0).choice(1000, 300, replace=False))
    want = ref_ivf._sample_rows(lambda: iter([emb]), 1000, 16, rows)
    assert np.array_equal(probe_ivf_build.sample_gather(emb, 300), want)


# -- no fallback -----------------------------------------------------------------------------


@pytest.mark.parametrize("driver", [bench, bench_configs, probe_ivf_build, probe_seq_buckets, measure_rerank_serving],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_drivers_refuse_the_cpu_at_full_size_and_cuda_without_a_card(driver):
    with pytest.raises(ValueError, match="tiny"):
        driver.run("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        driver.run("cuda", tiny=True)
