"""The port's own copies of the JAX package's host modules, each held against
its original on the same inputs.

The port imports nothing of ``tensortruth_tpu``: it keeps copies of the
jax-free host code it runs (``app/{config,paths,history_cleaner}``,
``core/{source,prompts,providers}``, ``index/`` (``packed.py`` is adapted:
test_torch_server.py names its one changed function), ``native/hostkit``,
``services/{batcher,chat_history,condenser,feeder}``, ``tokenization/``
and ``StageTimer`` of ``utils/profiling``; for the offline build path
``core/types``, ``app/sources``, ``utils/{pdf,validation,interactive}``,
``indexing/``, ``web/html2md``, ``scrapers/`` and ``fetch_sources``; for
the server surface ``cli``, ``server/`` less its adapted files, the rest of
``services/``, ``agents/``, ``extensions/``, ``mcp_servers/`` and ``web/``,
``app/{file_utils,title_generation}`` and ``core/llama_cpp``). A
copy differs from its original only in the package name, and gives the
original's outputs: the same nodes from the chunker, the same token ids from
the tokenizer (Python and C++ paths), the same config, prompts, histories
and batches, the same validation errors, PDF text and Markdown. What one
package writes to disk (a ``VectorIndex``, plain or packed; a config file; a
``sources.json``) the other reads back unchanged, so one index directory,
one config and one sources file serve both.
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
    "index/__init__.py", "index/chunker.py", "index/nodes.py", "index/store.py",
    "native/__init__.py", "native/hostkit.py", "native/hostkit.cpp",
    "services/batcher.py", "services/chat_history.py", "services/condenser.py", "services/feeder.py",
    "tokenization/__init__.py", "tokenization/tokenizer.py", "utils/__init__.py",
    # the offline build path and its ingestion front
    "core/types.py", "app/sources.py", "utils/pdf.py", "utils/validation.py", "utils/interactive.py",
    "indexing/__init__.py", "indexing/metadata.py", "indexing/migration.py", "indexing/builder.py",
    "web/__init__.py", "web/html2md.py", "fetch_sources.py",
    "scrapers/__init__.py", "scrapers/common.py", "scrapers/sphinx.py", "scrapers/doxygen.py",
    "scrapers/library.py", "scrapers/arxiv.py", "scrapers/book.py",
    # the server surface (its adapted modules are held in test_torch_server.py)
    "cli.py", "server/__init__.py", "server/schemas.py", "server/commands.py", "server/routes/__init__.py",
    *[f"server/routes/{m}.py" for m in (
        "arxiv", "commands", "documents", "extensions", "mcp_servers", "modules", "projects", "providers",
        "rerankers", "sessions", "startup", "tasks", "tool_confirmations", "tools")],
    *[f"services/{m}.py" for m in (
        "session_service", "project_service", "document_index", "document_service", "image_service",
        "chat_service", "startup_service", "synthesis_service", "task_runner",
        "tool_confirmation_service", "mcp_server_service", "metadata_store", "orchestrator_tools")],
    "app/file_utils.py", "app/title_generation.py", "core/llama_cpp.py",
    "agents/__init__.py", "agents/base.py", "agents/mcp_client.py", "agents/registry.py",
    "extensions/__init__.py", "extensions/loader.py", "extensions/schema.py", "extensions/yaml_command.py",
    "mcp_servers/__init__.py", "mcp_servers/web_tools_server.py",
    "web/fetch.py", "web/links.py", "web/pipeline.py", "web/search.py", "web/synthesis.py",
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
    """StageTimer is the original; the reference's device trace, on
    jax.profiler, stays behind: the port's is its own, on torch.profiler
    (test_torch_server.py names the differences)."""
    ref, port = _both("utils.profiling")
    assert inspect.getsource(port.StageTimer) == inspect.getsource(ref.StageTimer)
    assert "jax" in inspect.getsource(ref.device_trace) and "jax" not in inspect.getsource(port)
    timers = [mod.StageTimer() for mod in (ref, port)]
    for t in timers:
        for name in ("condense", "embed", "condense"):
            with t.stage(name):
                pass
    assert [list(t.to_dict()) for t in timers] == [["condense", "embed", "total_ms"]] * 2


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """The port's device trace: a no-op without a log dir; with one, a Chrome
    trace of the block's host ops (the card's kernels are not asked for here)."""
    import json

    import torch

    from tensortruth_tpu_torch.utils.profiling import device_trace

    with device_trace(None):
        pass
    assert not list(tmp_path.iterdir())
    with device_trace(str(tmp_path / "prof"), cuda=False):
        torch.ones(4).add_(1)
    (trace,) = (tmp_path / "prof").iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)


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


def test_is_packed_takes_no_exclusive_lock_when_nothing_needs_healing(tmp_path):
    """A shared lock on an unpacked module (another process reading it) does
    not hold up the port's ``is_packed``; the reference's waits for an
    exclusive lock, which two concurrent readers, each upgrading its own
    shared lock, can wait for forever (ROADMAP C)."""
    import fcntl
    import os
    import threading

    port_packed, ref_packed = (importlib.import_module(f"{pkg}.index.packed") for pkg in (PORT, REF))
    mod = tmp_path / "mod"
    mod.mkdir()
    fd = os.open(mod / (port_packed.PACKED_DIR + ".lock"), os.O_CREAT | os.O_RDWR)
    fcntl.flock(fd, fcntl.LOCK_SH)
    answers = {PORT: [], REF: []}
    threads = {pkg: threading.Thread(target=lambda m=m, a=answers[pkg]: a.append(m.is_packed(mod)), daemon=True)
               for pkg, m in ((PORT, port_packed), (REF, ref_packed))}
    try:
        for t in threads.values():
            t.start()
        threads[PORT].join(10)
        threads[REF].join(0.5)
        assert answers == {PORT: [False], REF: []}
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
    threads[REF].join(10)
    assert answers[REF] == [False]


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


# -- the build path: sources, validation, PDF and HTML text ----------------------


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)])
def test_sources_file_round_trips_between_packages(monkeypatch, tmp_path, writer, reader):
    monkeypatch.setenv("TENSOR_TRUTH_TPU_DATA_DIR", str(tmp_path))
    sources = {"libraries": {"numpy": {"doc_type": "sphinx", "inventory_url": "https://numpy.org/doc/objects.inv"}},
               "papers": {"attn": {"papers": {"1706.03762": {"title": "Attention", "year": 2017}}}},
               "books": {"bk": {"url": "https://example.org/b.pdf", "use_toc": True}}}
    importlib.import_module(f"{writer}.app.sources").save_user_sources(sources)
    mod = importlib.import_module(f"{reader}.app.sources")
    loaded = mod.load_user_sources()
    assert loaded == sources
    assert mod.list_all_modules(loaded) == ["numpy", "attn", "bk"]
    assert [mod.get_document_type_for_module(loaded, m).value for m in ("numpy", "attn", "bk")] == [
        "library", "papers", "book"]


def test_validation_gives_the_same_errors(tmp_path):
    sources = {"libraries": {"lib": {"doc_type": "sphinx"}, "dox": {"doc_type": "doxygen", "doc_root": "ftp://x"}},
               "papers": {"cat": {"papers": ["1234.0001", "not-an-id"]}, "empty": {"papers": []}},
               "books": {"bk": {"pages_per_chunk": 0, "converter": "nope"}}}
    (tmp_path / "library_lib").mkdir()
    (tmp_path / "papers_cat").mkdir()
    (tmp_path / "papers_cat" / "p.md").write_text("text")
    (tmp_path / "book_stray").mkdir()
    ref, port = _both("utils.validation")
    for module in ("lib", "dox", "cat", "empty", "bk", "ghost"):
        got = port.validate_module_for_build(module, sources, tmp_path)
        assert got == ref.validate_module_for_build(module, sources, tmp_path)
    assert port.validate_sources(sources, tmp_path) == ref.validate_sources(sources, tmp_path)
    assert port.validate_sources(sources, tmp_path)["errors"]  # the bad entries are reported
    for cfg in ({"doc_type": "sphinx"}, {"doc_type": "doxygen", "doc_root": "https://d/"}, {"doc_type": "x"}):
        assert port.validate_library_config(cfg) == ref.validate_library_config(cfg)
    ref, port = _both("utils.interactive")
    for arxiv_id in ("1706.03762", "arXiv:1706.03762v2", "hep-th/9901001", "17060.3762", ""):
        assert port.validate_arxiv_id(arxiv_id) == ref.validate_arxiv_id(arxiv_id)


@pytest.mark.parametrize("chapters", [None, [("Intro", 0), ("Methods", 1)]])
def test_pdf_text_is_the_same(chapters):
    from test_pdf_toc import _make_pdf

    pdf = _make_pdf(["first page text", "second page text", "third"], chapters=chapters)
    ref, port = _both("utils.pdf")
    assert port.pdf_to_text(pdf) == ref.pdf_to_text(pdf) and "second page" in port.pdf_to_text(pdf)
    assert port.post_process_markdown(port.pdf_to_text(pdf)) == ref.post_process_markdown(ref.pdf_to_text(pdf))
    assert port.extract_pdf_metadata(pdf) == ref.extract_pdf_metadata(pdf)


def test_html_to_markdown_is_the_same():
    html = ("<html><head><title>Arrays</title></head><body><nav>skip</nav><h1>Arrays</h1>"
            "<p>Some <b>bold</b> and <code>x = 1</code>.</p><pre>def f():\n    return 1</pre>"
            "<ul><li>one</li><li>two <a href='/x'>link</a></li></ul><table><tr><td>a</td></tr></table></body></html>")
    ref, port = _both("web.html2md")
    assert port.html_to_markdown(html) == ref.html_to_markdown(html) and "Arrays" in port.html_to_markdown(html)
    assert port.extract_title(html) == ref.extract_title(html)


def test_papers_wizard_takes_arxiv_metadata_from_web_search(monkeypatch):
    """With ``web/search.py`` in the port, the wizard's arXiv lookup fills
    title, authors and year as the reference's does (the arXiv API answered
    by a stub of ``requests.get``; no network)."""
    import requests

    atom = ('<feed xmlns="http://www.w3.org/2005/Atom"><entry><title>Attention Is\n  All You Need</title>'
            "<published>2017-06-12T17:57:34Z</published><author><name>A. Vaswani</name></author>"
            "<author><name>N. Shazeer</name></author><summary>Transformers.</summary></entry></feed>")

    class Reply:
        text = atom

        def raise_for_status(self):
            pass

    monkeypatch.setattr(requests, "get", lambda url, params=None, timeout=None, **kw: Reply())
    out = []
    for mod in _both("utils.interactive"):
        answers = iter(["attention", "1706.03762", "bogus-id", ""])
        printed = []
        out.append((mod.add_papers_interactive(input_fn=lambda _: next(answers), print_fn=printed.append), printed))
    (want, want_printed), (got, got_printed) = out
    assert got == want == ("attention", {"papers": {"1706.03762": {
        "title": "Attention Is All You Need", "authors": ["A. Vaswani", "N. Shazeer"], "year": "2017"}}})
    assert got_printed == want_printed
