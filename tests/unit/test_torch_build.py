"""The port's offline build path against the reference's: ``build_module``,
indexes carried across, and the two CLIs (``build_db``, ``fetch_sources``).

* ``build_module`` parity: one docs directory made from a seed with numpy,
  built by each package's ``build_module`` with a tiny XLM-R that holds the
  same float32 weights in both (the reference's parameters go into the port
  through ``params_from_jax``), under each of the three chunking strategies.
  Both must give the same nodes by (doc_id, level, start, end, text), the
  same parent/child structure, the same leaf row order, the same
  ``index_metadata.json`` apart from ``created_at``, and embeddings within
  1e-5 (float32 math in other orders through two encoder layers). Node ids
  are uuid4 draws and are never compared. Semantic breaks come from a
  percentile of cosine distances, so a near-tie at the threshold could flip a
  break between the two packages: the docs are drawn so that no two of the
  distances that decide a break lie within 1e-3 of each other (asserted).
* Cross-loading: an index written by one package's ``build_module`` is served
  by both packages' ``RAGService`` on the CPU; the same row ids, auto-merged
  nodes and rerank order come back, scores within 1e-5 (float32 corpus), as
  in ``test_torch_e2e.py``.
* The CLIs: the reference's CLI cases, each run against both packages. A CPU
  embedder is seated in the port's ``ModelManager`` first: the port's CLI
  has no device flag and loads on ``cuda`` when no model is resident.

The card's build tests are in ``test_torch_kernels.py``, which imports no JAX:
``build_module`` with a tiny model on ``cuda`` against the same on the CPU,
and kernel B3 reached through a leaf level of 512 tokens.
"""

import ast
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch
from test_torch_e2e import env, runtimes  # noqa: F401 (fixtures)

REPO = pathlib.Path(__file__).resolve().parents[2]
REF, PORT = "tensortruth_tpu", "tensortruth_tpu_torch"
PKGS = [REF, PORT]
STRATEGIES = ["hierarchical", "semantic", "semantic_hierarchical"]
CHUNK = dict(chunk_sizes=[128, 32], chunk_overlap=8)
SOURCES = {"libraries": {"gamma": {"doc_type": "sphinx", "url": "https://example.org/gamma"}},
           "papers": {}, "books": {}}
QUERIES = ["t1w3 t1w4 t1w5", "t3w0 t3w7 and t3w2", "what is t0w1?", "t4w9 t4w2 t2w2"]

torch.set_num_threads(1)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _write_docs(root: pathlib.Path, seed: int = 3) -> pathlib.Path:
    """Four markdown docs (one in a subdirectory) of sentences over five
    topic vocabularies, paragraphs switching topic at random."""
    rng = np.random.default_rng(seed)
    topics = [[f"t{t}w{j}" for j in range(12)] for t in range(5)]
    docs = root / "library_docs" / "library_gamma"
    (docs / "sub").mkdir(parents=True)
    for d, name in enumerate(["b.md", "a.md", "sub/c.md", "d.md"]):
        paras = []
        for _ in range(5):
            topic = topics[rng.integers(5)]
            sents = [" ".join(rng.choice(topic, rng.integers(5, 12))).capitalize() + "."
                     for _ in range(rng.integers(3, 6))]
            paras.append(" ".join(sents))
        (docs / name).write_text(f"# Doc {d}\n\n" + "\n\n".join(paras), encoding="utf-8")
    return root / "library_docs"


def _build(pkg, embedder, root, strategy="hierarchical"):
    """``pkg``'s build_module over the gamma docs into ``root/pkg``; returns
    the index dir."""
    ok = _mod(pkg, "indexing.builder").build_module(
        "gamma", embedder, library_docs_dir=root / "library_docs", indexes_dir=root / pkg, sources=SOURCES,
        embedding_model="tiny-embedder", chunking_strategy=strategy, **CHUNK,
    )
    assert ok
    return root / pkg / "tiny-embedder" / "library_gamma"


def _key(n):
    return (n.doc_id, n.level, n.start, n.end, n.text)


def _shape(pkg, path):
    """(nodes by key in store order, {key: parent key}, leaf keys in row
    order, f32 rows, metadata without created_at) of the index at ``path``."""
    index = _mod(pkg, "index").VectorIndex.load(path)
    nodes = list(index.store.nodes())
    by_id = {n.node_id: n for n in nodes}
    parents = {_key(n): _key(by_id[n.parent_id]) if n.parent_id else None for n in nodes}
    rows = [_key(n) for n in index.rows_to_nodes(np.arange(index.n_rows))]
    meta = json.loads((path / "index_metadata.json").read_text())
    meta.pop("created_at")
    return [_key(n) for n in nodes], parents, rows, np.asarray(index.matrix()[0]), meta


def _decisive_gaps(embedder, docs_dir):
    """For every doc, how far the distance between adjacent 3-sentence
    groups nearest to the 95th-percentile threshold lies from it: a
    float-level difference could move a distance that close across it."""
    from tensortruth_tpu_torch.index.chunker import split_sentences

    gaps = []
    for path in sorted(docs_dir.rglob("*.md")):
        sents = [s for s, _, _ in split_sentences(path.read_text(encoding="utf-8"))]
        groups = [" ".join(sents[max(0, i - 1): i + 2]) for i in range(len(sents))]
        emb = embedder.encode(groups)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9
        dists = 1.0 - (emb[:-1] * emb[1:]).sum(axis=1)
        thresh = np.percentile(dists, 95.0)
        gaps.append(np.abs(dists - thresh)[dists != thresh].min())
    return gaps


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_build_module_gives_the_reference_index(tmp_path, runtimes, strategy):  # noqa: F811
    _write_docs(tmp_path)
    if strategy != "hierarchical":
        assert min(_decisive_gaps(runtimes["port"][0], tmp_path / "library_docs" / "library_gamma")) > 1e-3
    want, got = (_shape(pkg, _build(pkg, runtimes[side][0], tmp_path, strategy))
                 for pkg, side in ((REF, "ref"), (PORT, "port")))
    assert got[0] == want[0] and len(got[0]) > 4  # nodes, in store order
    assert got[1] == want[1]  # parent/child structure
    assert got[2] == want[2]  # leaf row order
    assert [k[0] for k in got[2]][:1] == ["a.md"]  # rows follow the sorted files
    np.testing.assert_allclose(got[3], want[3], atol=1e-5, rtol=0)
    assert got[3].dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got[3], axis=1), 1.0, atol=1e-5)
    assert got[4] == want[4] and got[4]["chunking_strategy"] == strategy


@pytest.mark.parametrize("writer", PKGS)
def test_index_built_by_one_package_serves_both(env, runtimes, writer):  # noqa: F811
    """``env`` seats the tiny runtimes in both packages' managers; the
    ``gamma`` index comes from ``writer``'s build_module."""
    from test_torch_e2e import RefService

    from tensortruth_tpu_torch.services.rag_service import RAGService

    tmp_path, (ref_cfg, cfg) = env
    _write_docs(tmp_path)
    embedder = runtimes["ref" if writer == REF else "port"][0]
    assert _mod(writer, "indexing.builder").build_module(
        "gamma", embedder, library_docs_dir=tmp_path / "library_docs", indexes_dir=tmp_path / "indexes",
        sources=SOURCES, embedding_model="tiny-embedder", **CHUNK)
    params = {"reranker_top_n": 3, "corpus_dtype": "float32"}
    ref = RefService(config=ref_cfg, llm_factory=lambda p: None)
    ref.load_engine(["gamma"], params, indexes_dir=tmp_path / "indexes")
    port = RAGService(config=cfg, llm_factory=lambda p: None)
    port.load_engine(["gamma"], params, indexes_dir=tmp_path / "indexes", device="cpu")
    merged = False
    for q in QUERIES:
        want, got = ref.engine.pipeline.retrieve_one(q), port.engine.pipeline.retrieve_one(q)
        assert [(r.node_id, r.module) for r in got] == [(r.node_id, r.module) for r in want] and got
        np.testing.assert_allclose([r.score for r in got], [r.score for r in want], atol=1e-5, rtol=0)
        merged |= any(not r.node.is_leaf for r in got)
        want, got = ref.retrieve(q), port.retrieve(q)
        assert [s.id for s in got.sources] == [s.id for s in want.sources] and got.sources
        np.testing.assert_allclose([s.score for s in got.sources], [s.score for s in want.sources], atol=1e-5)
        assert got.confidence == want.confidence
    assert merged  # auto-merge took part


def test_measure_build_makes_the_reference_scripts_inputs():
    """The port's measure_build draws the same leaves and docs from the seed
    as the JAX package's two scripts (their generators, read from source:
    importing those scripts starts JAX and sets a cache directory)."""
    from tensortruth_tpu_torch.scripts import measure_build

    def reference(script, name):
        tree = ast.parse((REPO / "scripts" / script).read_text(encoding="utf-8"))
        keep = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name
                or isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name) and n.targets[0].id.isupper()]
        scope = {"np": np}
        exec(compile(ast.Module(body=keep, type_ignores=[]), script, "exec"), scope)
        return scope[name]

    assert measure_build.synth_chunks(64) == reference("measure_build_throughput.py", "synth_chunks")(64)
    assert measure_build.synth_docs(3) == reference("measure_e2e_build.py", "synth_docs")(3)


def test_measure_build_runs_on_the_cpu_when_asked(tmp_path, monkeypatch):
    from tensortruth_tpu_torch.models.manager import ModelManager, ModelSpec
    from tensortruth_tpu_torch.scripts import measure_build

    monkeypatch.setenv("TENSOR_TRUTH_TPU_NATIVE_CACHE", str(tmp_path / "native"))
    ModelManager.reset_instance()
    try:
        embedder = ModelManager.get_instance().get_embedder(ModelSpec("tiny-embedder"), device="cpu")
        out = measure_build.run(embedder, n_chunks=32, n_docs=1)
    finally:
        ModelManager.reset_instance()
    assert out["docs"] == 1 and out["leaves"] > 40 and out["nodes"] > out["leaves"]
    assert out["encode_only"]["chunks"] == 32 and out["build_chunks_per_s_native"] > 0


# -- the CLIs, against both packages -------------------------------------------


def _seat_cpu_embedder(pkg, model_id="tiny-embedder"):
    """The port's CLI loads its embedder on ``cuda`` unless one is resident:
    seat a CPU one under the spec the CLI asks for. The reference needs
    nothing (its tiny model loads on the JAX CPU backend)."""
    manager = _mod(pkg, "models.manager")
    manager.ModelManager.reset_instance()
    if pkg == PORT:
        mc = _mod(pkg, "app.config").load_config().rag.get_embedding_model_config(model_id)
        spec = manager.ModelSpec(model_id, dtype=mc.dtype, max_length=mc.max_length, local_dir=mc.local_dir,
                                 tokenizer_path=mc.tokenizer_path)
        manager.ModelManager.get_instance().get_embedder(spec, device="cpu")


@pytest.fixture
def data_env(tmp_path, monkeypatch):
    """A data dir with tiny-embedder as the default model; sources with one
    module per section, each with docs."""
    monkeypatch.setenv("TENSOR_TRUTH_TPU_DATA_DIR", str(tmp_path))
    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig, save_config

    cfg = TensorTruthTPUConfig.default()
    cfg.rag.default_embedding_model = "tiny-embedder"
    cfg.rag.use_fused_topk = False
    save_config(cfg)
    sources = {"libraries": {"lib1": {"doc_type": "sphinx", "inventory_url": "http://x/objects.inv"}},
               "papers": {"micro": {"papers": ["1234.0001"]}}, "books": {"bk1": {"url": "http://b.pdf"}}}
    (tmp_path / "sources.json").write_text(json.dumps(sources))
    for name, text in (("papers_micro", "retrieval on GPUs. "), ("library_lib1", "array docs. "),
                       ("book_bk1", "chapter text. ")):
        (tmp_path / "library_docs" / name).mkdir(parents=True)
        (tmp_path / "library_docs" / name / "p1.md").write_text("# Doc\n\n" + text * 120)
    yield tmp_path
    for pkg in PKGS:
        _mod(pkg, "models.manager").ModelManager.reset_instance()


def _record_builds(monkeypatch, pkg):
    """Replace ``pkg``'s build_module in its CLI by a recorder."""
    seen = []
    build_db = _mod(pkg, "build_db")
    monkeypatch.setattr(build_db, "build_module", lambda m, embedder, **kw: seen.append((m, kw)) or True)
    return build_db, seen


@pytest.mark.parametrize("pkg", PKGS)
def test_build_db_builds_module_and_writes_index(data_env, pkg):
    _seat_cpu_embedder(pkg)
    rc = _mod(pkg, "build_db").main(["--modules", "micro", "--chunk-sizes", "128", "32", "--chunk-overlap", "8"])
    assert rc == 0
    idx = data_env / "indexes" / "tiny-embedder" / "papers_micro"
    meta = json.loads((idx / "index_metadata.json").read_text())
    assert meta["embedding_model"] == "tiny-embedder" and meta["chunk_sizes"] == [128, 32]
    assert _mod(pkg, "index").VectorIndex.load(idx).n_alive > 0


@pytest.mark.parametrize("pkg", PKGS)
def test_build_db_unknown_module_fails_fast(data_env, pkg):
    """Fails before it loads a model: the port's CLI, with none resident,
    would otherwise reach for ``cuda``."""
    assert _mod(pkg, "build_db").main(["--modules", "ghost"]) == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_build_db_requires_selection(data_env, pkg):
    with pytest.raises(SystemExit):
        _mod(pkg, "build_db").main([])


@pytest.mark.parametrize(
    "argv,want",
    [
        (["--all"], ["lib1", "micro", "bk1"]),
        (["--libraries"], ["lib1"]),
        (["--papers"], ["micro"]),
        (["--books"], ["bk1"]),
        (["--modules", "bk1", "micro"], ["bk1", "micro"]),
    ],
)
@pytest.mark.parametrize("pkg", PKGS)
def test_build_db_selectors_pick_configured_modules(data_env, monkeypatch, pkg, argv, want):
    _seat_cpu_embedder(pkg)
    build_db, seen = _record_builds(monkeypatch, pkg)
    assert build_db.main(argv) == 0
    assert [m for m, _ in seen] == want


@pytest.mark.parametrize("pkg", PKGS)
def test_build_db_no_validate_and_path_overrides(data_env, pkg):
    alt = data_env / "alt"
    (alt / "docs" / "papers_solo").mkdir(parents=True)
    (alt / "docs" / "papers_solo" / "d.md").write_text("alt layout doc " * 100)
    (alt / "sources.json").write_text(json.dumps({"libraries": {}, "papers": {"solo": {"papers": []}}, "books": {}}))
    _seat_cpu_embedder(pkg)
    rc = _mod(pkg, "build_db").main([
        "--modules", "solo", "--embedding-model", "tiny-embedder", "--no-validate",
        "--library-docs-dir", str(alt / "docs"), "--sources-config", str(alt / "sources.json"),
        "--indexes-dir", str(alt / "idx"),
    ])
    assert rc == 0
    assert (alt / "idx" / "tiny-embedder" / "papers_solo" / "index_metadata.json").exists()


@pytest.mark.parametrize("pkg", PKGS)
def test_build_db_passes_extensions_and_strategy(data_env, monkeypatch, pkg):
    _seat_cpu_embedder(pkg)
    build_db, seen = _record_builds(monkeypatch, pkg)
    rc = build_db.main(["--modules", "micro", "--extensions", ".md", "--chunking-strategy", "semantic",
                        "--semantic-breakpoint-threshold", "90"])
    assert rc == 0
    (_, kw), = seen
    assert kw["extensions"] == [".md"] and kw["chunking_strategy"] == "semantic"
    assert kw["semantic_breakpoint_threshold"] == 90.0 and kw["embedding_model"] == "tiny-embedder"


@pytest.mark.parametrize("pkg", PKGS)
def test_load_documents_extensions_and_pdf(tmp_path, pkg):
    from test_pdf_toc import _make_pdf

    load_documents = _mod(pkg, "indexing.builder").load_documents
    (tmp_path / "a.md").write_text("markdown doc")
    (tmp_path / "b.rst").write_text("rst doc")
    assert [n for n, _ in load_documents(tmp_path, [".md"])] == ["a.md"]
    (tmp_path / "c.pdf").write_bytes(_make_pdf(["pdf page text"]))
    docs = load_documents(tmp_path, [".md", ".pdf"])
    assert [n for n, _ in docs] == ["a.md", "c.pdf"]
    assert "pdf page text" in dict(docs)["c.pdf"]
    assert [n for n, _ in load_documents(tmp_path, ["md"])] == ["a.md"]


def test_port_build_cli_defaults_to_the_card(data_env, monkeypatch):
    """With no resident model the port's CLI loads on ``cuda``: without a
    card it raises and writes nothing, and never builds on the CPU."""
    from tensortruth_tpu_torch import build_db
    from tensortruth_tpu_torch.models.manager import ModelManager

    ModelManager.reset_instance()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        build_db.main(["--modules", "micro"])
    assert ModelManager.get_instance().status()["embedder"] is None
    assert not (data_env / "indexes").exists()


def test_port_build_db_differs_from_the_reference_in_two_places():
    """The XLA cache call is gone and the docstring says so; everything else
    is the reference with the package renamed."""
    ref = (REPO / REF / "build_db.py").read_text(encoding="utf-8").replace(f"{REF}.", f"{PORT}.")
    port = (REPO / PORT / "build_db.py").read_text(encoding="utf-8")
    cache = (f"    from {PORT}.models.manager import enable_persistent_compilation_cache\n\n"
             "    enable_persistent_compilation_cache()\n")
    body = ref[ref.index('"""', 3) + 3:]
    assert cache in body and port.endswith(body.replace(cache, ""))
    assert "enable_persistent_compilation_cache" in port[: port.index('"""', 3)]


@pytest.mark.parametrize("pkg", PKGS)
def test_fetch_sources_list_validate_add(data_env, capsys, pkg):
    fetch_sources = _mod(pkg, "fetch_sources")
    assert fetch_sources.main(["list"]) == 0
    assert "micro" in capsys.readouterr().out
    assert fetch_sources.main(["validate"]) == 0
    cfg = json.dumps({"doc_type": "sphinx", "inventory_url": "http://x/objects.inv"})
    assert fetch_sources.main(["add", "libraries", "mylib", "--config", cfg]) == 0
    assert fetch_sources.main(["add", "libraries", "badlib", "--config", json.dumps({"doc_type": "sphinx"})]) != 0
    assert fetch_sources.main(["add", "libraries", "structlib", "--url", "http://y/objects.inv", "--type",
                               "sphinx"]) == 0
    assert fetch_sources.main(["add", "papers", "newcat", "--arxiv-ids", "1234.0001", "2345.0002"]) == 0
    sources = json.loads((data_env / "sources.json").read_text())
    assert "mylib" in sources["libraries"] and "badlib" not in sources["libraries"]
    assert sources["libraries"]["structlib"] == {"inventory_url": "http://y/objects.inv", "doc_type": "sphinx"}
    assert set(sources["papers"]["newcat"]["papers"]) == {"1234.0001", "2345.0002"}


@pytest.mark.parametrize("pkg", PKGS)
def test_fetch_sources_add_without_args_runs_the_wizard(data_env, monkeypatch, pkg):
    called = {}
    monkeypatch.setattr(_mod(pkg, "utils.interactive"), "interactive_add",
                        lambda *a, **k: called.setdefault("yes", True))
    assert _mod(pkg, "fetch_sources").main(["add"]) == 0 and called.get("yes")


@pytest.mark.parametrize("pkg", PKGS)
def test_fetch_sources_fetch_passes_scraper_knobs(data_env, monkeypatch, pkg):
    seen = {}
    monkeypatch.setattr(_mod(pkg, "scrapers.library"), "scrape_library",
                        lambda name, cfg, docs_dir, **kw: seen.setdefault("lib", kw) is kw)
    monkeypatch.setattr(_mod(pkg, "scrapers.book"), "fetch_book",
                        lambda name, cfg, docs_dir, **kw: seen.setdefault("book", (cfg, kw)) is not None)
    monkeypatch.setattr(_mod(pkg, "scrapers.arxiv"), "fetch_paper_category",
                        lambda name, cfg, docs_dir, **kw: seen.setdefault("papers", kw) is kw)
    rc = _mod(pkg, "fetch_sources").main([
        "fetch", "--modules", "lib1", "bk1", "micro", "--workers", "3", "--min-size", "99",
        "--pages-per-chunk", "7", "--max-pages-per-chapter", "11", "--converter", "fallback",
    ])
    assert rc == 0
    assert seen["lib"] == {"max_workers": 3, "min_size": 99}
    book_cfg, book_kw = seen["book"]
    assert book_kw == {"converter": "fallback", "pages_per_chunk": 7} and book_cfg["max_pages_per_chapter"] == 11
    assert seen["papers"] == {"converter": "fallback"}
    assert _mod(pkg, "fetch_sources").main(["fetch", "--modules", "ghost"]) == 1
