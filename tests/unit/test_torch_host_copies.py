"""The port's own copies of the JAX package's host modules, each held against
its original on the same inputs.

The port imports nothing of ``tensortruth_tpu``: it keeps copies of the
jax-free host code it runs (``app/{config,paths,history_cleaner}``,
``core/{source,prompts,providers}``, ``index/``, ``native/hostkit``,
``services/{batcher,chat_history,condenser,feeder}``, ``tokenization/``
and ``StageTimer`` of ``utils/profiling``). A copy differs from its original
only in the package name, and gives the original's outputs: the same nodes
from the chunker, the same token ids from the tokenizer (Python and C++
paths), the same config, prompts, histories and batches. What one package
writes to disk (a ``VectorIndex``, plain or packed; a config file) the other
reads back unchanged, so one index directory and one config serve both.
"""

import dataclasses
import importlib
import inspect
import itertools
import pathlib
import shutil
import uuid

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
REF, PORT = "tensortruth_tpu", "tensortruth_tpu_torch"
COPIED = [
    "app/__init__.py", "app/config.py", "app/paths.py", "app/history_cleaner.py",
    "core/__init__.py", "core/source.py", "core/prompts.py", "core/providers.py",
    "index/__init__.py", "index/chunker.py", "index/nodes.py", "index/packed.py", "index/store.py",
    "native/__init__.py", "native/hostkit.py", "native/hostkit.cpp",
    "services/batcher.py", "services/chat_history.py", "services/condenser.py", "services/feeder.py",
    "tokenization/__init__.py", "tokenization/tokenizer.py", "utils/__init__.py",
]


def _both(module: str):
    """(the reference's module, the port's copy)."""
    return importlib.import_module(f"{REF}.{module}"), importlib.import_module(f"{PORT}.{module}")


@pytest.mark.parametrize("path", COPIED)
def test_copy_differs_only_in_the_package_name(path):
    ref = (REPO / REF / path).read_text(encoding="utf-8")
    port = (REPO / PORT / path).read_text(encoding="utf-8")
    assert port == ref.replace(f"{REF}.", f"{PORT}.")


def test_stage_timer_is_the_original_and_the_device_trace_stays_behind():
    ref, port = _both("utils.profiling")
    assert inspect.getsource(port.StageTimer) == inspect.getsource(ref.StageTimer)
    assert not hasattr(port, "device_trace")  # jax.profiler: the server surface's, not ported
    timers = [mod.StageTimer() for mod in (ref, port)]
    for t in timers:
        for name in ("condense", "embed", "condense"):
            with t.stage(name):
                pass
    assert [list(t.to_dict()) for t in timers] == [["condense", "embed", "total_ms"]] * 2


# -- index: chunker, nodes, store, packed ---------------------------------------


def _embed_fn(texts):
    """One numpy embedding for both packages: character-class counts."""
    out = np.zeros((len(texts), 8), np.float32)
    for i, t in enumerate(texts):
        for j, ch in enumerate(t):
            out[i, (ord(ch) + j) % 8] += 1.0
    return out + 1e-3


@pytest.fixture
def fixed_ids(monkeypatch):
    """Node ids from a counter instead of uuid4; ``reset()`` restarts it, so
    two packages chunking the same text draw the same ids."""
    counter = {"it": itertools.count(1)}
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(counter["it"])))
    return lambda: counter.update(it=itertools.count(1))


def _chunk(pkg, strategy, reset):
    index = importlib.import_module(f"{pkg}.index")
    tok = importlib.import_module(f"{pkg}.tokenization").SimpleTokenizer()
    reset()
    kw = {} if strategy == "semantic" else {"chunk_sizes": [512, 128], "chunk_overlap": 16}
    return index.chunk_document(
        (REPO / "README.md").read_text(encoding="utf-8"), tok, doc_id="readme", strategy=strategy,
        embed_fn=None if strategy == "hierarchical" else _embed_fn, module="docs",
        metadata={"filename": "README.md"}, **kw,
    )


@pytest.mark.parametrize("strategy", ["hierarchical", "semantic", "semantic_hierarchical"])
def test_chunk_document_gives_the_same_nodes(fixed_ids, strategy):
    want, got = (_chunk(pkg, strategy, fixed_ids) for pkg in (REF, PORT))
    assert len(got) > 3
    assert [n.to_dict() for n in got] == [n.to_dict() for n in want]  # ids, text, spans, parent/child links
    ref_index, port_index = _both("index")
    stores = (ref_index.HierarchyStore(), port_index.HierarchyStore())
    for store, nodes in zip(stores, (want, got)):
        store.add_all(nodes)
    assert stores[1].finalize_leaves() == stores[0].finalize_leaves()


def _index(pkg, fixed_ids):
    index = importlib.import_module(f"{pkg}.index")
    nodes = _chunk(pkg, "hierarchical", fixed_ids)
    return index.VectorIndex.build(nodes, _embed_fn, embedding_model="tiny-embedder", chunk_sizes=[512, 128],
                                   chunk_overlap=16, gelu_flavor="exact")


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)])
def test_vector_index_written_by_one_package_loads_in_the_other(tmp_path, fixed_ids, writer, reader, packed):
    written = _index(writer, fixed_ids)
    written.save(tmp_path / "mod", packed=packed)
    loaded = importlib.import_module(f"{reader}.index").VectorIndex.load(tmp_path / "mod")
    assert type(loaded).__module__ == f"{reader}.index.store"
    assert type(loaded).__name__ == ("PackedVectorIndex" if packed else "VectorIndex")
    (m_got, r_got), (m_want, r_want) = loaded.matrix(), written.matrix()
    np.testing.assert_array_equal(m_got, m_want)
    np.testing.assert_array_equal(r_got, r_want)
    assert loaded.metadata == written.metadata
    assert [n.to_dict() for n in loaded.store.nodes()] == [n.to_dict() for n in written.store.nodes()]
    assert list(loaded.store.leaf_ids) == list(written.store.leaf_ids)
    rows = np.arange(0, loaded.n_rows, 3)
    assert [n.to_dict() for n in loaded.rows_to_nodes(rows)] == [n.to_dict() for n in written.rows_to_nodes(rows)]
    shutil.copytree(tmp_path / "mod", tmp_path / "library_lib")
    ref, port = _both("index.store")
    for module in ("mod", "lib", "missing"):
        assert port.resolve_module_dir(tmp_path, module) == ref.resolve_module_dir(tmp_path, module)


def test_sanitize_model_id_matches():
    ref, port = _both("index.store")
    for model in ("BAAI/bge-m3", "tiny-embedder", "a/b:c d"):
        assert port.sanitize_model_id(model) == ref.sanitize_model_id(model)


# -- tokenizer and the C++ hostkit ----------------------------------------------

TEXTS = [
    "Hello, world! How are you?",
    "Ünïcödé straße ΣΑΣ naïve café — 東京 2024",
    "  tabs\tand\nnewlines   ",
    "",
    "x" * 300 + " tail",
]


@pytest.mark.parametrize("path", ["python", "hostkit"])
def test_tokenizer_gives_the_same_ids_and_offsets(monkeypatch, tmp_path, path):
    ref_native, port_native = _both("native")
    if path == "python":
        for native in (ref_native, port_native):
            monkeypatch.setattr(native, "get_hostkit", lambda: None)
    else:
        if shutil.which("g++") is None:
            pytest.skip("the C++ hostkit needs g++")
        monkeypatch.setenv("TENSOR_TRUTH_TPU_NATIVE_CACHE", str(tmp_path))
        kits = [native.get_hostkit() for native in (ref_native, port_native)]
        assert all(kit is not None for kit in kits)
        assert type(kits[1]).__module__ == f"{PORT}.native.hostkit"
    ref_tok, port_tok = (importlib.import_module(f"{pkg}.tokenization") for pkg in (REF, PORT))
    for kw in ({}, {"vocab_size": 512}, {"sep_style": "bert"}):
        want, got = ref_tok.SimpleTokenizer(**kw), port_tok.SimpleTokenizer(**kw)
        for text in TEXTS:
            assert got.encode_with_offsets(text) == want.encode_with_offsets(text)
        for pair in (None, TEXTS[::-1]):
            for a, b in zip(got.encode_batch(TEXTS, 24, pair=pair), want.encode_batch(TEXTS, 24, pair=pair)):
                np.testing.assert_array_equal(a, b)
    assert port_tok.load_tokenizer(sep_style="bert").sep_style == ref_tok.load_tokenizer(sep_style="bert").sep_style


# -- app: config, paths, history cleaning ---------------------------------------


def test_default_config_is_the_same():
    ref, port = _both("app.config")
    assert port.TensorTruthTPUConfig.default().to_dict() == ref.TensorTruthTPUConfig.default().to_dict()
    partial = {"rag": {"default_top_n": 7, "unknown": 1}, "ollama": {"base_url": "http://h:1"}}
    assert port.TensorTruthTPUConfig.from_dict(partial).to_dict() == ref.TensorTruthTPUConfig.from_dict(partial).to_dict()


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)])
def test_config_file_round_trips_between_packages(monkeypatch, tmp_path, writer, reader):
    monkeypatch.setenv("TENSOR_TRUTH_TPU_DATA_DIR", str(tmp_path))
    w = importlib.import_module(f"{writer}.app.config")
    r = importlib.import_module(f"{reader}.app.config")
    cfg = w.TensorTruthTPUConfig.default()
    cfg.rag.default_top_n = 9
    cfg.providers.append(w.ProviderConfig(id="local", type="openai_compatible", base_url="http://x:8000",
                                          api_key="${TT_KEY}", models=[{"name": "m"}]))
    w.save_config(cfg)  # to the data dir both packages resolve
    assert (tmp_path / "config.yaml").exists()
    assert r.load_config().to_dict() == cfg.to_dict()
    monkeypatch.setenv("TT_KEY", "secret")
    assert r.expand_env_vars("k=${TT_KEY} ${NOPE}") == w.expand_env_vars("k=${TT_KEY} ${NOPE}") == "k=secret ${NOPE}"


@pytest.mark.parametrize(
    "fn,args",
    [("get_user_data_dir", ()), ("get_config_path", ()), ("get_sources_config_path", ()),
     ("get_library_docs_dir", ()), ("get_base_indexes_dir", ()), ("get_indexes_dir_for_model", ("BAAI/bge-m3",)),
     ("get_module_index_dir", ("BAAI/bge-m3", "library", "mod")), ("get_session_dir", ("s1",)),
     ("get_session_index_dir", ("s1",)), ("get_project_index_dir", ("p1",))],
)
def test_paths_resolve_the_same(monkeypatch, tmp_path, fn, args):
    monkeypatch.setenv("TENSOR_TRUTH_TPU_DATA_DIR", str(tmp_path))
    ref, port = _both("app.paths")
    assert getattr(port, fn)(*args) == getattr(ref, fn)(*args)


HISTORY = [
    {"role": "user", "content": "Hi there 😀   how   are you?\n\n\n\nOK"},
    {"role": "assistant", "content": "Great question! Here is the answer."},
    {"role": "tool", "content": "ignored role"},
    {"role": "user", "content": 42},
    {"role": "user", "content": "Second question"},
    {"role": "assistant", "content": "I hope this helps. Second answer."},
    {"role": "user", "content": "Third"},
]


@pytest.mark.parametrize("cleaning", [None, "config"])
def test_history_cleaning_matches(cleaning):
    ref, port = _both("app.history_cleaner")
    ref_cfg, port_cfg = (m.TensorTruthTPUConfig.default().history_cleaning for m in _both("app.config"))
    for msg in HISTORY:
        if isinstance(msg["content"], str):
            want = ref.clean_history_content(msg["content"], None if cleaning is None else ref_cfg)
            assert port.clean_history_content(msg["content"], None if cleaning is None else port_cfg) == want


# -- core: sources, prompts, providers -----------------------------------------


def test_source_node_fields_and_enums_match():
    ref, port = _both("core.source")
    assert [(f.name, f.type) for f in dataclasses.fields(port.SourceNode)] == \
        [(f.name, f.type) for f in dataclasses.fields(ref.SourceNode)]
    for enum in ("SourceStatus", "SourceType"):
        assert [(e.name, e.value) for e in getattr(port, enum)] == [(e.name, e.value) for e in getattr(ref, enum)]
    kw = dict(id="n1", title="t", content="body", score=np.float32(0.5), metadata={"filename": "f.md"})
    assert port.SourceNode(**kw).to_dict() == ref.SourceNode(**kw).to_dict()
    node = type("N", (), {"node_id": "x", "text": "leaf", "metadata": {"filename": "a.md", "source_url": "u"}})
    rn = type("RN", (), {"node": node, "module": "m", "source_index": 2, "score": 0.25})
    assert port.SourceNode.from_retrieved(rn).to_dict() == ref.SourceNode.from_retrieved(rn).to_dict()


@pytest.mark.parametrize(
    "name",
    ["CONTEXT_PROMPT_TEMPLATE", "CONTEXT_PROMPT_LOW_CONFIDENCE", "CONTEXT_PROMPT_NO_SOURCES",
     "NO_CONTEXT_FALLBACK_CONTEXT", "LLM_ONLY_SYSTEM_PROMPT", "CONDENSE_PROMPT_TEMPLATE"],
)
def test_prompt_constants_match(name):
    ref, port = _both("core.prompts")
    assert getattr(port, name) == getattr(ref, name)


def test_current_date_context_matches():
    ref, port = _both("core.prompts")
    assert port.current_date_context() == ref.current_date_context()


@pytest.mark.parametrize(
    "ptype,thinking",
    [("openai_compatible", None), ("llama_cpp", "low"), ("llama_cpp", False), ("llama_cpp", True)],
)
def test_create_llm_builds_the_same_client(ptype, thinking):
    """Providers with a static model list resolve without a network call."""
    (ref, port), (ref_cfg, port_cfg) = _both("core.providers"), _both("app.config")
    clients = []
    for providers, cfg in ((ref, ref_cfg), (port, port_cfg)):
        providers.ProviderRegistry.reset_instance()
        conf = [cfg.ProviderConfig(id="p", type=ptype, base_url="http://h:1/", models=[{"name": "m1"}, {"id": "m2"}])]
        try:
            clients.append(providers.create_llm({"model": "m2", "thinking": thinking, "temperature": 0.3}, conf))
        finally:
            providers.ProviderRegistry.reset_instance()
    want, got = clients
    assert type(got).__name__ == type(want).__name__ and vars(got) == vars(want)


def test_provider_helpers_match():
    ref, port = _both("core.providers")
    msgs = [{"role": "user", "content": "look", "images": ["iVBORw0KGgo", "data:image/gif;base64,R0lG"]},
            {"role": "assistant", "content": "ok", "images": []}]
    assert port._openai_multimodal(msgs) == ref._openai_multimodal(msgs)
    for b64 in ("iVBORw0KGgo", "/9j/4AAQ", "R0lGODlh", "UklGR", "zzz"):
        assert port._sniff_image_mime(b64) == ref._sniff_image_mime(b64)
    assert dataclasses.asdict(port.ChatDelta("a", "b")) == dataclasses.asdict(ref.ChatDelta("a", "b"))
    assert port.ModelReference("p", "m").qualified() == ref.ModelReference("p", "m").qualified()


# -- services: chat history, condenser, batcher, feeder -------------------------


@pytest.mark.parametrize("max_turns,cleaning", [(None, None), (1, True), (2, False), (0, None), (60, True)])
def test_chat_history_builds_the_same_history(max_turns, cleaning):
    ref, port = _both("services.chat_history")
    ref_cfg, port_cfg = (m.TensorTruthTPUConfig.default() for m in _both("app.config"))
    want = ref.ChatHistoryService(ref_cfg).build_history(HISTORY, max_turns, cleaning)
    got = port.ChatHistoryService(port_cfg).build_history(HISTORY, max_turns, cleaning)
    assert got.to_prompt_string() == want.to_prompt_string()
    assert got.to_chat_messages() == want.to_chat_messages()
    assert port.ChatHistoryService().build_history(HISTORY).to_chat_messages() == \
        ref.ChatHistoryService().build_history(HISTORY).to_chat_messages()


class _RecordingLLM:
    def __init__(self, reply="condensed question", fail=False):
        self.prompts, self.reply, self.fail = [], reply, fail

    def complete(self, prompt):
        self.prompts.append(prompt)
        if self.fail:
            raise RuntimeError("llm down")
        return self.reply


@pytest.mark.parametrize("history,reply,fail", [("user: hi\nassistant: hello", " standalone? ", False),
                                                ("user: hi", "", False), ("user: hi", "x", True), ("  ", "x", False)])
def test_condenser_sends_the_same_prompt(history, reply, fail):
    ref, port = _both("services.condenser")
    llms = _RecordingLLM(reply, fail), _RecordingLLM(reply, fail)
    want = ref.condense_query(llms[0], history, "What about it?")
    got = port.condense_query(llms[1], history, "What about it?")
    assert got == want and llms[1].prompts == llms[0].prompts


@pytest.mark.parametrize("two_phase", [False, True])
def test_batcher_serves_the_same_results(two_phase):
    results = []
    for mod in _both("services.batcher"):
        calls = []

        def run_batch(texts, key, _calls=calls):
            _calls.append((list(texts), key))
            out = [f"{key}:{t.upper()}" for t in texts]
            return (lambda: out) if two_phase else out

        batcher = mod.QueryBatcher(run_batch, max_batch=4, max_wait_ms=20.0)
        try:
            futures = [batcher.submit(f"q{i}", key=("a" if i % 3 else "b")) for i in range(10)]
            answers = [f.result(timeout=30) for f in futures]
        finally:
            batcher.stop()
        assert sorted(t for texts, _ in calls for t in texts) == sorted(f"q{i}" for i in range(10))
        assert all(len(texts) <= 4 for texts, _ in calls)
        results.append((answers, batcher.requests_served))
    assert results[1] == results[0] and results[0][1] == 10


def test_batcher_failures_reach_the_callers_the_same_way():
    errors = []
    for mod in _both("services.batcher"):
        def boom(texts, key):
            raise ValueError("device lost")

        batcher = mod.QueryBatcher(boom, max_batch=2, max_wait_ms=1.0)
        try:
            with pytest.raises(ValueError, match="device lost") as info:
                batcher.retrieve("q", timeout=30)
            errors.append(type(info.value))
        finally:
            batcher.stop()
        assert not batcher._worker.is_alive()
    assert errors[0] is errors[1]


@pytest.mark.parametrize("env,workers", [(None, None), ("3", 3), ("0", 1), ("many", None)])
def test_feeder_default_workers_match(monkeypatch, env, workers):
    if env is None:
        monkeypatch.delenv("TENSOR_TRUTH_TPU_FEED_WORKERS", raising=False)
    else:
        monkeypatch.setenv("TENSOR_TRUTH_TPU_FEED_WORKERS", env)
    ref, port = _both("services.feeder")
    assert port.default_workers() == ref.default_workers()
    if workers is not None:
        assert port.default_workers() == workers


@pytest.mark.parametrize("n_workers,n_pairs", [(1, 5), (3, 10), (4, 2), (3, 0)])
def test_feeder_tokenizes_the_same_pairs(n_workers, n_pairs):
    pairs = [(f"query {i % 3}", f"document {i} " + "word " * i) for i in range(n_pairs)]
    out = []
    for pkg in (REF, PORT):
        feeder_mod = importlib.import_module(f"{pkg}.services.feeder")
        tok = importlib.import_module(f"{pkg}.tokenization").SimpleTokenizer()
        feeder = feeder_mod.HostFeeder(n_workers)
        try:
            assert feeder._shards(n_pairs) == feeder_mod.HostFeeder(n_workers)._shards(n_pairs)
            a = feeder.tokenize_pairs(tok, pairs, 16)
            b = feeder.hydrate_and_tokenize(tok, lambda i: pairs[i][0], lambda i: pairs[i][1], n_pairs, 16)
        finally:
            feeder.close()
        out.append((a, b, feeder._shards(n_pairs)))
    (ra, rb, rs), (pa, pb, ps) = out
    assert ps == rs
    for want, got in ((ra, pa), (rb, pb), (pa, pb)):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
