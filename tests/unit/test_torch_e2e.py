"""The port's online query path as a whole, against the reference's.

One index dir (two modules, chunked by the reference's hierarchical chunker
from the ``sample_text`` fixture and embedded by the reference's tiny
embedder) is written to disk and served by each package's ``RAGService``,
each with its own config, tokenizer and index classes. Both packages hold the same tiny
float32 weights: the reference's parameters go into the port through
``params_from_jax``, and each package's ``ModelManager`` hands out its own
runtime over them. The same queries must give the same node ids after merge
and balance, the same rerank order and the same confidence-gate decision.

Tolerances: with a float32 corpus, scores within 1e-5 (float32 math in other
orders through two encoder layers); with the default bf16 corpus, retrieval
scores within 2e-3 (a query component near a bf16 rounding boundary may round
the other way) and node ids still identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensortruth_tpu.app.config import TensorTruthTPUConfig as RefConfig
from tensortruth_tpu.core.providers import ChatDelta as RefChatDelta
from tensortruth_tpu.index import VectorIndex, chunk_document
from tensortruth_tpu.models import manager as ref_manager
from tensortruth_tpu.models import xlmr as ref_xlmr
from tensortruth_tpu.models.embedder import Embedder as RefEmbedder
from tensortruth_tpu.models.reranker import Reranker as RefReranker
from tensortruth_tpu.services.rag_service import RAGService as RefService
from tensortruth_tpu.tokenization import SimpleTokenizer as RefTokenizer
from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig
from tensortruth_tpu_torch.core.providers import ChatDelta
from tensortruth_tpu_torch.models import manager as port_manager
from tensortruth_tpu_torch.models import xlmr as port_xlmr
from tensortruth_tpu_torch.models.embedder import Embedder
from tensortruth_tpu_torch.models.reranker import Reranker
from tensortruth_tpu_torch.services.rag_service import RAGService
from tensortruth_tpu_torch.tokenization import SimpleTokenizer

torch.set_num_threads(1)

TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, max_position=130)
MAX_LEN = 128
QUERIES = [
    "Paragraph 3 about topic 3",
    "w12_5 w12_6 w12_7 w12_8",
    "topic 5 w30_1 w30_2",
    "what does paragraph 21 say about topic 0?",
]


class StubLLM:
    def __init__(self, delta=ChatDelta):
        self.calls = []
        self.delta = delta

    def complete(self, prompt):
        return "condensed"

    def stream_chat(self, messages, system=None):
        self.calls.append(messages)
        yield self.delta(text="stub answer")


def _port_model(cfg, params):
    tcfg = port_xlmr.XLMRConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return port_xlmr.XLMRModel.from_state_dict(tcfg, port_xlmr.params_from_jax(np_params), "cpu", torch.float32)


def _scaled(params, word=1.0, qk=1.0, vo=1.0, out=1.0):
    """Random init at std 0.02 makes every tiny-model output nearly the same
    (cosines of 0.99996), so float noise would decide the order. Scaling
    these weights makes the outputs depend on the text: neighbouring scores
    then differ by >= 1e-4, far above the float32 noise."""
    params["embeddings"]["word"] = params["embeddings"]["word"] * word
    for name, f in (("q_w", qk), ("k_w", qk), ("v_w", vo), ("o_w", vo)):
        params["layers"][name] = params["layers"][name] * f
    if "classifier" in params:
        params["classifier"]["out_w"] = params["classifier"]["out_w"] * out
    return params


@pytest.fixture(scope="module")
def runtimes():
    ref_tok, tok = RefTokenizer(vocab_size=TINY["vocab_size"]), SimpleTokenizer(vocab_size=TINY["vocab_size"])
    ecfg = ref_xlmr.XLMRConfig(**TINY, pooling="mean")
    rcfg = ref_xlmr.XLMRConfig(**TINY, num_labels=1)
    ep = _scaled(ref_xlmr.init_params(ecfg, jax.random.PRNGKey(11), dtype=jnp.float32), word=50.0)
    rp = _scaled(ref_xlmr.init_params(rcfg, jax.random.PRNGKey(12), dtype=jnp.float32),
                 word=50.0, qk=10.0, vo=10.0, out=50.0)
    return {
        "ref": (RefEmbedder(ep, ecfg, ref_tok, max_length=MAX_LEN),
                RefReranker(rp, rcfg, ref_tok, max_length=MAX_LEN)),
        "port": (Embedder(_port_model(ecfg, ep), tok, max_length=MAX_LEN),
                 Reranker(_port_model(rcfg, rp), tok, max_length=MAX_LEN)),
    }


@pytest.fixture
def env(tmp_path, monkeypatch, sample_text, runtimes):
    monkeypatch.setenv("TENSOR_TRUTH_TPU_DATA_DIR", str(tmp_path))
    embedder = runtimes["ref"][0]
    paras = sample_text.split("\n\n")
    for module, text in (("alpha", sample_text), ("beta", "\n\n".join(reversed(paras[:25])))):
        nodes = chunk_document(text, embedder.tokenizer, doc_id=module, module=module,
                               chunk_sizes=[128, 32], chunk_overlap=8,
                               metadata={"filename": f"{module}.md", "doc_type": "library"})
        VectorIndex.build(nodes, embedder.encode, embedding_model="tiny-embedder", chunk_sizes=[128, 32],
                          chunk_overlap=8, gelu_flavor=embedder.gelu_flavor).save(
            tmp_path / "indexes" / "tiny-embedder" / module)
    for pkg, mgr_mod in (("ref", ref_manager), ("port", port_manager)):
        mgr_mod.ModelManager.reset_instance()
        mgr = mgr_mod.ModelManager.get_instance()
        emb, rr = runtimes[pkg]
        monkeypatch.setattr(mgr, "get_embedder", lambda spec=None, _e=emb, **kw: _e)
        monkeypatch.setattr(mgr, "get_reranker", lambda spec=None, _r=rr, **kw: _r)
    cfgs = RefConfig.default(), TensorTruthTPUConfig.default()  # (reference's, port's)
    for cfg in cfgs:
        cfg.rag.default_embedding_model = "tiny-embedder"
        cfg.rag.default_reranker = "tiny-reranker"
    yield tmp_path, cfgs
    ref_manager.ModelManager.reset_instance()
    port_manager.ModelManager.reset_instance()


def _services(env, params):
    tmp_path, (ref_cfg, cfg) = env
    llms = StubLLM(RefChatDelta), StubLLM()
    ref = RefService(config=ref_cfg, llm_factory=lambda p: llms[0])
    ref.load_engine(["alpha", "beta"], params, indexes_dir=tmp_path / "indexes")
    port = RAGService(config=cfg, llm_factory=lambda p: llms[1])
    port.load_engine(["alpha", "beta"], params, indexes_dir=tmp_path / "indexes", device="cpu")
    return ref, port, llms


@pytest.mark.parametrize("corpus_dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-3)])
def test_merge_and_balance_match_reference(env, corpus_dtype, atol):
    ref, port, _ = _services(env, {"reranker_top_n": 3, "corpus_dtype": corpus_dtype})
    assert port.engine.pipeline is not None and port.engine.retriever._stacked.device.type == "cpu"
    merged = False
    for q in QUERIES:
        want = ref.engine.pipeline.retrieve_one(q)
        got = port.engine.pipeline.retrieve_one(q)
        assert [(r.node_id, r.module) for r in got] == [(r.node_id, r.module) for r in want]
        np.testing.assert_allclose([r.score for r in got], [r.score for r in want], atol=atol, rtol=0)
        merged |= any(not r.node.is_leaf for r in got)
    assert merged  # auto-merge took part


@pytest.mark.parametrize(
    "cutoff,cutoff_hard,level",
    [(0.0, 0.0, "normal"), (1.0, 0.0, "low"), (1.0, 1.0, "no_sources"), (0.35, 0.05, None)],
)
def test_rerank_order_and_gate_match_reference(env, cutoff, cutoff_hard, level):
    params = {"reranker_top_n": 4, "corpus_dtype": "float32",
              "confidence_cutoff": cutoff, "confidence_cutoff_hard": cutoff_hard}
    ref, port, _ = _services(env, params)
    for q in QUERIES:
        want, got = ref.retrieve(q), port.retrieve(q)
        assert [s.id for s in got.sources] == [s.id for s in want.sources]
        np.testing.assert_allclose([s.score for s in got.sources], [s.score for s in want.sources], atol=1e-5)
        assert got.confidence == want.confidence
        if level is not None:
            assert got.confidence == level
        assert got.metrics["configuration"] == want.metrics["configuration"]


def test_query_streams_like_reference(env):
    ref, port, llms = _services(env, {"reranker_top_n": 3, "corpus_dtype": "float32"})
    responses = []
    for svc in (ref, port):
        gen = svc.query("Paragraph 7 about topic 0")
        chunks = []
        try:
            while True:
                chunks.append(next(gen))
        except StopIteration as stop:
            responses.append((stop.value, [c.status for c in chunks if c.status]))
    (want, want_status), (got, got_status) = responses
    assert got_status == want_status == ["retrieving", "reranking", "generating"]
    assert got.text == want.text == "stub answer"
    assert [s.id for s in got.sources] == [s.id for s in want.sources] and got.sources
    assert got.confidence == want.confidence
    assert llms[1].calls[-1][-1]["content"] == llms[0].calls[-1][-1]["content"]  # same prompt to the LLM


def test_rerank_failure_raises_where_reference_falls_back(env, monkeypatch):
    """The one deliberate difference: the port never hides a failed rerank."""
    ref, port, _ = _services(env, {"reranker_top_n": 3})

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ref.engine.reranker, "rerank", boom)
    monkeypatch.setattr(port.engine.reranker, "rerank", boom)
    assert ref.retrieve("Paragraph 3 about topic 3").sources  # dense order
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port.retrieve("Paragraph 3 about topic 3")


def test_batched_retrieval_two_phase_matches_unbatched(env):
    """``_run_retrieval_batch`` (the shared batcher's entry) returns a
    finisher whose results equal the per-query path's reranked order."""
    _, port, _ = _services(env, {"reranker_top_n": 3, "corpus_dtype": "float32"})
    finish = port._run_retrieval_batch(QUERIES)
    assert callable(finish)
    batched = finish()
    for q, srcs in zip(QUERIES, batched):
        single = port.retrieve(q).sources
        assert [s.id for s in srcs] == [s.id for s in single]


def test_shared_batcher_serves_retrieve_like_reference(env):
    """With the shared micro-batcher on, ``retrieve()`` goes through
    ``_run_retrieval_batch`` and gives the reference's batched answers."""
    ref, port, _ = _services(env, {"reranker_top_n": 3, "corpus_dtype": "float32"})
    for svc in (ref, port):
        svc.enable_batching(max_batch=4, max_wait_ms=1.0)
    try:
        for q in QUERIES:
            want, got = ref.retrieve(q), port.retrieve(q)
            assert "batched_retrieve_rerank" in got.metrics["timings"]
            assert [s.id for s in got.sources] == [s.id for s in want.sources] and got.sources
            np.testing.assert_allclose([s.score for s in got.sources], [s.score for s in want.sources], atol=1e-5)
            assert got.confidence == want.confidence
    finally:
        for svc in (ref, port):
            svc.disable_batching()
    assert port._batcher is None


def test_engine_cache_unload_and_clear(env):
    """The engine lifecycle the chat and system routes drive: a repeated load
    returns the cached engine, ``unload`` detaches it (no sources), a reload
    takes it from the cache, and ``clear_engines`` drops every cached one."""
    tmp_path, _ = env
    _, port, _ = _services(env, {"reranker_top_n": 3})
    engine = port.engine
    same = port.load_engine(["alpha", "beta"], {"reranker_top_n": 3}, indexes_dir=tmp_path / "indexes",
                            device="cpu")
    assert same is engine
    port.unload()
    assert port.engine is None and port.retrieve(QUERIES[0]).confidence == "no_sources"
    again = port.load_engine(["alpha", "beta"], {"reranker_top_n": 3}, indexes_dir=tmp_path / "indexes",
                             device="cpu")
    assert again is engine
    port.clear_engines()
    assert port.engine is None and not port._engines
