"""Import isolation and dispatch guards of the PyTorch/CUDA port.

* A fresh interpreter imports every module of ``tensortruth_tpu_torch``,
  builds nothing, loads a tiny CPU engine through the port's
  ``RAGService.load_engine`` and answers one ``retrieve()``, then builds an
  index through the port's ``build_db.main`` (a tiny CPU embedder seated in
  its model manager), lists the sources through ``fetch_sources.main`` and
  answers one ``retrieve()`` on a 2 x 2 mesh of CPU slots:
  afterwards no module of the JAX package (``tensortruth_tpu`` or under it),
  no ``jax`` and no ``triton`` is in ``sys.modules``. The same holds after
  a document upload and a WS chat through the port's app on the CPU, and in
  a slice worker spawned on the CPU that has answered a search (its import
  log, ``PYTHONPROFILEIMPORTTIME``, names no such module). The serving and
  recall drivers' run in a fresh interpreter is held to the same in
  ``test_torch_serving.py``.
* No source file of the port and not ``chip_smoke.py`` imports the JAX
  package or jax, lazily or not (an AST walk over every import); the two
  drivers and ``chip_smoke.py``'s serving, orchestrator and recall phases
  import no triton either.
* The CUDA-only wrappers (B1, B2, B3, B4, B5) raise on inputs their kernels
  do not take instead of falling back; these checks run on the CPU because
  they come before the device check.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from tensortruth_tpu_torch.ops import attention, ivf, matmul, topk

torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parents[2] / "tensortruth_tpu_torch"


_FRESH = """
import importlib, pathlib, pkgutil, sys
import tensortruth_tpu_torch as p

mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from tensortruth_tpu_torch import _build

assert _build._lib is None and _build.build_seconds is None
from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig
from tensortruth_tpu_torch.index import VectorIndex, chunk_document
from tensortruth_tpu_torch.models.manager import ModelManager, ModelSpec
from tensortruth_tpu_torch.services.rag_service import RAGService

work = pathlib.Path(sys.argv[1])
cfg = TensorTruthTPUConfig.default()
cfg.rag.default_embedding_model, cfg.rag.default_reranker = "tiny-embedder", "tiny-reranker"
embedder = ModelManager.get_instance().get_embedder(ModelSpec("tiny-embedder"), device="cpu")
text = (pathlib.Path(p.__file__).parents[1] / "README.md").read_text(encoding="utf-8")
nodes = chunk_document(text, embedder.tokenizer, doc_id="readme", module="docs", chunk_sizes=[128, 32],
                       chunk_overlap=8, metadata={"filename": "README.md", "doc_type": "library"})
VectorIndex.build(nodes, embedder.encode, embedding_model="tiny-embedder", chunk_sizes=[128, 32],
                  chunk_overlap=8).save(work / "indexes" / "tiny-embedder" / "docs")
svc = RAGService(config=cfg, llm_factory=lambda params: None)
svc.load_engine(["docs"], {"reranker_top_n": 3}, indexes_dir=work / "indexes", device="cpu")
result = svc.retrieve("How does the engine merge chunks?")
assert result.sources, result

from tensortruth_tpu_torch import build_db, fetch_sources
from tensortruth_tpu_torch.app.sources import save_user_sources

save_user_sources({"libraries": {"readme": {}}, "papers": {}, "books": {}})
docs = work / "data" / "library_docs" / "library_readme"
docs.mkdir(parents=True)
(docs / "README.md").write_text(text, encoding="utf-8")
assert build_db.main(["--modules", "readme", "--embedding-model", "tiny-embedder", "--chunk-sizes", "128", "32",
                      "--chunk-overlap", "8"]) == 0
assert VectorIndex.is_valid(work / "data" / "indexes" / "tiny-embedder" / "library_readme")
assert fetch_sources.main(["list"]) == 0

from tensortruth_tpu_torch.parallel import make_mesh

mesh = make_mesh(n_shards=2, n_data=2, devices=["cpu"] * 4)
svc.load_engine(["docs"], {"reranker_top_n": 2}, indexes_dir=work / "indexes", mesh=mesh)
assert svc.engine.retriever.mesh is mesh and svc.engine.embedder.mesh is mesh
assert svc.retrieve("How does the engine merge chunks?").sources
foreign = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("tensortruth_tpu", "jax", "jaxlib", "triton"))
print(len(mods), len(result.sources), foreign)
"""


def test_every_module_imports_without_jax(tmp_path):
    env = {**os.environ, "TENSOR_TRUTH_TPU_DATA_DIR": str(tmp_path / "data"),
           "TENSOR_TRUTH_TPU_NATIVE_CACHE": str(tmp_path / "native")}
    out = subprocess.run([sys.executable, "-c", _FRESH, str(tmp_path)], capture_output=True, text=True,
                         timeout=300, cwd=PKG.parent, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    n, n_sources, foreign = out.stdout.strip().splitlines()[-1].split(" ", 2)
    assert int(n) >= 40 and int(n_sources) > 0
    assert foreign == "[]", foreign


_FRESH_APP = """
import asyncio, pathlib, sys
from aiohttp.test_utils import TestClient, TestServer
from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig
from tensortruth_tpu_torch.core.providers import ChatDelta
from tensortruth_tpu_torch.server.app import create_app

class LLM:
    def complete(self, prompt):
        return "title"

    def stream_chat(self, messages, system=None):
        yield ChatDelta(text="answer")

work = pathlib.Path(sys.argv[1])
cfg = TensorTruthTPUConfig.default()
cfg.rag.default_embedding_model, cfg.rag.default_reranker = "tiny-embedder", "tiny-reranker"
app = create_app(data_dir=work / "data", config=cfg, device="cpu")
app["services"].rag_service._llm_factory = lambda params: LLM()

async def chat():
    client = TestClient(TestServer(app))
    await client.start_server()
    sid = (await (await client.post("/api/sessions", json={})).json())["id"]
    r = await client.post(f"/api/sessions/{sid}/documents",
                          json={"filename": "a.md", "text": "The engine merges leaves into parents. " * 60})
    assert (await r.json())["status"] == "success"
    ws = await client.ws_connect(f"/ws/chat/{sid}")
    await ws.send_json({"message": "How are leaves merged?"})
    frames = []
    while not frames or frames[-1]["type"] not in ("done", "error"):
        frames.append(await ws.receive_json(timeout=120))
    await ws.close()
    await client.close()
    return frames

frames = asyncio.run(chat())
types = [f["type"] for f in frames]
assert "sources" in types and types[-1] == "done", frames
foreign = sorted(k for k in sys.modules
                 if k.split(".")[0] in ("tensortruth_tpu", "jax", "jaxlib", "triton"))
print(types.count("sources"), foreign)
"""


def test_cpu_chat_through_the_app_loads_no_jax(tmp_path):
    """A document upload and a WS chat through the port's app on the CPU,
    in a fresh interpreter: nothing of the JAX package, jax or triton loads."""
    env = {**os.environ, "TENSOR_TRUTH_TPU_NATIVE_CACHE": str(tmp_path / "native")}
    out = subprocess.run([sys.executable, "-c", _FRESH_APP, str(tmp_path)], capture_output=True, text=True,
                         timeout=300, cwd=PKG.parent, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    n_sources, foreign = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n_sources) == 1
    assert foreign == "[]", foreign


def test_spawned_slice_worker_loads_no_jax(tmp_path):
    """A slice worker spawned by the port's transport imports nothing of the
    JAX package, jax or triton, also after serving a search."""
    import numpy as np

    from tensortruth_tpu_torch.parallel.transport import SocketTransport, save_ivf_part, spawn_slice_worker

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((400, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    save_ivf_part(ivf.build_ivf(emb, n_clusters=4, sample_size=400, kmeans_iters=2, device="cpu"), tmp_path / "p.npz")
    log = tmp_path / "worker.log"
    proc, port = spawn_slice_worker(tmp_path / "p.npz", startup_timeout=60, device="cpu", log_path=log,
                                    env_extra={"PYTHONPROFILEIMPORTTIME": "1", "OMP_NUM_THREADS": "1"})
    try:
        t = SocketTransport("127.0.0.1", port, timeout=60)
        vals, rows = t.search(emb[:2], k=3, nprobe=2)
        assert (rows[:, 0] == [0, 1]).all()
        t.shutdown_worker()
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    imported = [line.rsplit("|", 1)[1].strip() for line in log.read_text().splitlines()
                if line.startswith("import time:") and "|" in line]
    assert {"tensortruth_tpu_torch.parallel.multislice", "tensortruth_tpu_torch.ops.ivf", "torch"} <= set(imported)
    foreign = sorted(m for m in imported if m.split(".")[0] in ("tensortruth_tpu", "jax", "jaxlib", "triton"))
    assert foreign == [], foreign


def _imported_roots(path: pathlib.Path) -> set[str]:
    """Top-level names of every absolute import in ``path``, wherever it
    stands (module level or inside a function)."""
    return _imported_roots_of(ast.parse(path.read_text(encoding="utf-8")))


def _imported_roots_of(tree: ast.AST) -> set[str]:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module", "__import__"
        ) and node.args and isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG.parent)))
def test_no_source_imports_the_jax_package(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "tensortruth_tpu"}, (path, roots)


def test_chip_smoke_imports_only_the_port():
    roots = _imported_roots(PKG.parent / "chip_smoke.py")
    assert "tensortruth_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "tensortruth_tpu"}, roots


# The serving, orchestrator, recall and bench phases of chip_smoke.py, with
# the drivers they call.
SMOKE_PHASES = ["orchestrate", "run_orchestrator_path", "run_serving_path", "run_recall_path",
                "check_searches_against_plain", "run_bench_path", "check_bench_searches"]
DRIVERS = ["scripts/measure_serving_e2e.py", "scripts/measure_recall.py", "scripts/bench.py",
           "scripts/bench_configs.py", "scripts/probe_ivf_build.py", "scripts/probe_seq_buckets.py",
           "scripts/measure_rerank_serving.py"]


@pytest.mark.parametrize("target", [*DRIVERS, *SMOKE_PHASES])
def test_serving_phases_and_their_drivers_import_no_jax_or_triton(target):
    if target.endswith(".py"):
        roots = _imported_roots(PKG / target)
    else:
        tree = ast.parse((PKG.parent / "chip_smoke.py").read_text(encoding="utf-8"))
        (fn,) = [n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == target]
        roots = _imported_roots_of(fn)
        assert "tensortruth_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "tensortruth_tpu", "triton"}, roots


def test_package_sources_avoid_forbidden_shortcuts():
    """No packaged attention, no compiler shortcut, no jax, and no kernel
    wrapper that catches an error to run the plain version."""
    for path in PKG.rglob("*.py"):
        src = path.read_text()
        assert "scaled_dot_product_attention" not in src, path
        assert "torch.compile" not in src, path
        assert not re.search(r"^\s*(import|from)\s+jax\b", src, re.M), path
    for name in ("topk.py", "attention.py", "ivf.py", "matmul.py"):
        assert "except" not in (PKG / "ops" / name).read_text(), name


def _q(dtype=torch.bfloat16, n=4, d=32):
    return torch.zeros((n, d), dtype=dtype)


@pytest.mark.parametrize(
    "q,emb,err",
    [
        (_q(torch.float32), _q(n=2048), TypeError),  # wrong dtype
        (_q(), _q(torch.float16, n=2048), TypeError),
        (_q(d=64)[:, ::2], _q(n=2048), ValueError),  # non-contiguous
        (_q(), _q(n=4096, d=64)[:, ::2], ValueError),
        (_q(d=24), _q(n=2048, d=24), ValueError),  # D % 16
        (_q(d=4096), _q(n=2048, d=4096), ValueError),  # queries exceed shared memory
        (_q(), _q(n=2048), ValueError),  # CPU tensors
    ],
)
def test_fused_topk_kernel_wrapper_refuses(q, emb, err):
    with pytest.raises(err):
        topk.fused_candidates_cuda(q, emb, tile_n=2048, m=1, c_out=2048, n_actual=emb.shape[0])


@pytest.mark.parametrize(
    "q,emb,scales,err",
    [
        (_q(), _q(n=2048), torch.ones(2048), TypeError),  # bf16 rows
        (_q(torch.float32), torch.zeros((2048, 32), dtype=torch.int8), torch.ones(2048), TypeError),
        (_q(), torch.zeros((2048, 32), dtype=torch.int8), torch.ones(2048, dtype=torch.float64), TypeError),
        (_q(), torch.zeros((2048, 32), dtype=torch.int8), torch.ones(2047), ValueError),  # one scale per row
        (_q(), torch.zeros((2048, 64), dtype=torch.int8)[:, ::2], torch.ones(2048), ValueError),
        (_q(d=24), torch.zeros((2048, 24), dtype=torch.int8), torch.ones(2048), ValueError),  # D % 16
        (_q(), torch.zeros((2048, 32), dtype=torch.int8), torch.ones(2048), ValueError),  # CPU tensors
    ],
)
def test_fused_topk_int8_kernel_wrapper_refuses(q, emb, scales, err):
    with pytest.raises(err):
        topk.fused_candidates_int8_cuda(q, emb, scales, tile_n=2048, m=1, c_out=2048, n_actual=emb.shape[0])


def _probe_args(blocks_dtype=torch.bfloat16, d=32, q_dtype=torch.bfloat16, scales=False, probe_dtype=torch.int32):
    return dict(
        probe=torch.zeros((2, 3), dtype=probe_dtype),
        q=torch.zeros((2, d), dtype=q_dtype),
        blocks=torch.zeros((4, 128, d), dtype=blocks_dtype),
        valid=torch.ones((4, 128), dtype=torch.int32),
        scales=torch.ones((4, 128)) if scales else None,
    )


@pytest.mark.parametrize(
    "args,err",
    [
        (_probe_args(torch.float32), TypeError),  # f32 blocks
        (_probe_args(torch.int8), TypeError),  # int8 blocks without scales
        (_probe_args(scales=True), TypeError),  # bf16 blocks with scales
        (_probe_args(q_dtype=torch.float32), TypeError),
        (_probe_args(probe_dtype=torch.int64), TypeError),
        (_probe_args(d=24), ValueError),  # D % 16
        (_probe_args(), ValueError),  # CPU tensors
        (_probe_args(torch.int8, scales=True), ValueError),
    ],
)
def test_probe_kernel_wrapper_refuses(args, err):
    with pytest.raises(err):
        ivf.probe_scores_cuda(**args)


def _qkv(dtype=torch.bfloat16, s=256, dh=64):
    return torch.zeros((2, 2, s, dh), dtype=dtype)


@pytest.mark.parametrize(
    "q,k,mask,err",
    [
        (_qkv(torch.float32), _qkv(torch.float32), torch.ones((2, 256), dtype=torch.int32), TypeError),
        (_qkv(dh=32), _qkv(dh=32), torch.ones((2, 256), dtype=torch.int32), ValueError),  # head dim
        (_qkv(), _qkv().transpose(2, 3).contiguous().transpose(2, 3), torch.ones((2, 256), dtype=torch.int32),
         ValueError),  # k strided differently from q
        (_qkv(), _qkv(), torch.ones((2, 256), dtype=torch.int64), ValueError),  # mask dtype
        (_qkv(), _qkv(), torch.ones((2, 256), dtype=torch.int32), ValueError),  # CPU tensors
    ],
)
def test_attention_kernel_wrapper_refuses(q, k, mask, err):
    with pytest.raises(err):
        attention.blocked_attention_cuda(q, k, k, mask)


def _mm(m=128, k=64, n=128, dtype=torch.bfloat16):
    return torch.zeros((m, k), dtype=dtype), torch.zeros((k, n), dtype=dtype)


@pytest.mark.parametrize(
    "a,b,err",
    [
        (*_mm(dtype=torch.float32), TypeError),  # f32 operands
        (_mm()[0], _mm(dtype=torch.int8)[1], TypeError),  # mixed operand types
        (_mm()[0], torch.zeros((32, 128), dtype=torch.bfloat16), ValueError),  # K mismatch
        (*_mm(m=100), ValueError),  # M not a multiple of the 128-row tile
        (*_mm(n=200), ValueError),  # N not a multiple of the 128-column tile
        (*_mm(k=48), ValueError),  # bf16 K not a multiple of 32
        (*_mm(k=96, dtype=torch.int8), ValueError),  # int8 K not a multiple of 64
        (torch.zeros((128, 128), dtype=torch.bfloat16)[:, ::2], _mm()[1], ValueError),  # non-contiguous
        (*_mm(), ValueError),  # CPU tensors
        (*_mm(dtype=torch.int8), ValueError),
    ],
)
def test_tc_matmul_kernel_wrapper_refuses(a, b, err):
    with pytest.raises(err):
        matmul.tc_matmul_cuda(a, b)


def _counts():
    return (topk.fused_topk.launches, topk.fused_topk_int8.launches, attention.blocked_attention.launches,
            ivf.probe_scores.launches, ivf.probe_scores.launches_int8, matmul.tc_matmul.launches,
            matmul.tc_matmul.launches_int8)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = _counts()
    topk.fused_topk(torch.randn(3, 16), torch.randn(5000, 16), 5)
    topk.fused_topk_int8(torch.randn(3, 16), torch.ones((5000, 16), dtype=torch.int8), torch.ones(5000), 5)
    q = torch.randn(1, 1, 256, 16)
    attention.blocked_attention(q, q, q, torch.ones((1, 256), dtype=torch.int32))
    for int8 in (False, True):
        args = _probe_args(torch.int8 if int8 else torch.bfloat16, scales=int8)
        ivf.probe_scores(**args)
        matmul.tc_matmul(*_mm(dtype=torch.int8 if int8 else torch.bfloat16), n_outer=int8)
    assert _counts() == before


def test_engine_default_device_is_cuda_and_never_moves_to_cpu():
    """No code path moves to the CPU when CUDA is missing: asking for the
    default device on a machine without CUDA fails loudly."""
    import numpy as np

    from tensortruth_tpu_torch.index import HierarchyStore, Node, VectorIndex
    from tensortruth_tpu_torch.retrieval.engine import MultiIndexEngine

    store = HierarchyStore()
    store.add(Node(node_id="a", text="a", level=0, doc_id="d"))
    rows = store.finalize_leaves()
    idx = VectorIndex(np.ones((1, 8), np.float32), rows, store)
    engine = MultiIndexEngine({"m": idx}, device="cpu")
    assert engine._stacked.device.type == "cpu" and not engine.use_fused
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            MultiIndexEngine({"m": idx})
