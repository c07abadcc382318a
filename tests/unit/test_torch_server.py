"""The port's server surface against the reference's, over HTTP and WebSocket.

One tiny module index (``alpha``, chunked from the ``sample_text`` fixture
and embedded by the reference's tiny embedder) is written to disk and served
by the reference's ``create_app(config=cfg)`` and by the port's
``create_app(config=cfg, device="cpu")``. Both packages' model managers hand
out the same tiny float32 weights (``test_torch_e2e.py``'s ``runtimes``), both
apps get the same fake LLM, and the same requests go to each through
``aiohttp.test_utils``. Each app runs on its own data directory, one after the
other: a ``ServiceContainer`` points the data-dir variable at its own.

The responses must agree after ids, timestamps and host timings are dropped:
the same keys, the same values, the same source texts in the same order, and
scores within 1e-5 (float32 corpus; float32 math in other orders through two
encoder layers), as in ``test_torch_e2e.py``. The device routes differ by
design: the reference lists the JAX CPU devices (the test harness forces
eight), the port its one device, with the same keys.

The port's own checks: its default app loads on ``cuda``, so with no card a
chat gets an error frame naming CUDA and no answer; each adapted module
differs from its original only in the functions named below; ``static/`` is
byte-equal to the reference's.
"""

import ast
import asyncio
import importlib
import pathlib
import re

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from test_torch_e2e import runtimes  # noqa: F401 (fixture)

from tensortruth_tpu.index import VectorIndex, chunk_document

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[2]
REF, PORT = "tensortruth_tpu", "tensortruth_tpu_torch"
PKGS = [REF, PORT]
# Keys whose values differ from run to run: ids drawn at random (sessions,
# the uploaded document's chunks), clocks and host timings.
VOLATILE = {"id", "session_id", "project_id", "created_at", "updated_at", "timestamp", "timings", "duration_ms",
            "tokens_per_s", "log_dir", "trace"}
SCORE_ATOL = 1e-5
UPLOAD = {"filename": "mxu.md", "text": "The MXU is a 128x128 systolic array that multiplies bf16 tiles. " * 40}
# Functions of each adapted module that differ from the original beyond the
# package name; every other top-level statement is the same.
ADAPTED = {
    "server/app.py": {"create_app"},
    "server/deps.py": {"ServiceContainer.__init__", "ServiceContainer.rag_service",
                       "ServiceContainer.document_service"},
    "server/routes/system.py": {"<docstring>", "device_entries", "memory", "devices", "profile_start",
                                "profile_stop", "rag_status"},
    "server/routes/config.py": {"get_devices"},
    # ws_chat draws each message's id and opens the spans of utils/profiling.py
    "server/routes/chat.py": {"_current_reranker", "ws_chat", "_session_io", "import contextvars", "import os",
                              "from tensortruth_tpu_torch.utils import profiling"},
    "utils/profiling.py": {"<docstring>", "import os", "_active", "start_trace", "stop_trace", "device_trace",
                           # the span recorder
                           "import itertools", "import threading", "from collections import deque, namedtuple",
                           "from contextvars import ContextVar", "import torch.autograd.profiler as _torch_profiler",
                           "RING_SIZE", "Record", "_ring", "_message_ids", "_span_ids", "_current", "next_id", "_ids",
                           "_Span.__init__", "_Span.__enter__", "_Span.__exit__", "_Span.count", "_Span.close",
                           "_Off.__enter__", "_Off.__exit__", "_Off.__bool__", "_Off.count", "_Off.close", "_OFF",
                           "span", "record", "current_span", "recorded",
                           # the set-up account
                           "import functools", "_BusyClock.<docstring>",
                           '_BusyClock.__slots__ = ("in_flight", "state")', "_BusyClock.__init__", "_BusyClock.enter",
                           "_BusyClock.leave", "_BusyClock.seconds", '_InFlight.__slots__ = ("account", "count")',
                           "_InFlight.__init__", "_InFlight.__enter__", "_InFlight.__exit__", "SetupAccount.<docstring>", "SetupAccount.__init__", "SetupAccount.add",
                           "SetupAccount.busy_s", "SetupAccount.phase", "SetupAccount.serving", "SetupAccount.snapshot",
                           "SETUP", "setup_phase"},
    # stamps each request's submit time and message ids, and spans the
    # dispatch, the finisher and each request's wait in the queue
    "services/batcher.py": {"import time", "from tensortruth_tpu_torch.utils import profiling",
                            "_Request.rids: tuple = ()",
                            "_Request.t_submit: float = field(default_factory=time.perf_counter)",
                            "QueryBatcher.submit", "QueryBatcher._loop", "QueryBatcher._resolve"},
    # takes no exclusive lock when there is nothing to heal (ROADMAP C)
    "index/packed.py": {"is_packed"},
    # a failed rag_query raises out of the agent instead of becoming an
    # "ERROR: ..." tool result (ROADMAP C): the tool declares it
    "agents/function_agent.py": {"FunctionAgent.run"},
    "services/tool_service.py": {"ToolSpec.propagate_errors: bool = False"},
    "services/orchestrator_service.py": {"OrchestratorService._rag_tool"},
}


class FakeLLM:
    def __init__(self, delta):
        self.delta = delta

    def complete(self, prompt):
        return "standalone"

    def stream_chat(self, messages, system=None):
        yield self.delta(thinking="let me think")
        yield self.delta(text="answered ")
        yield self.delta(text="from context")


@pytest.fixture
def served(tmp_path, monkeypatch, sample_text, runtimes):  # noqa: F811
    """``start(pkg, device=...)`` -> a started TestClient over ``pkg``'s app
    on its own data dir; the ``alpha`` index lies in a shared indexes dir."""
    embedder = runtimes["ref"][0]
    nodes = chunk_document(sample_text, embedder.tokenizer, doc_id="alpha", module="alpha",
                           chunk_sizes=[128, 32], chunk_overlap=8,
                           metadata={"filename": "alpha.md", "doc_type": "library"})
    VectorIndex.build(nodes, embedder.encode, embedding_model="tiny-embedder", chunk_sizes=[128, 32],
                      chunk_overlap=8, gelu_flavor=embedder.gelu_flavor).save(
        tmp_path / "indexes" / "tiny-embedder" / "alpha")
    monkeypatch.setenv("TENSOR_TRUTH_TPU_INDEXES_DIR", str(tmp_path / "indexes"))
    monkeypatch.setenv("TENSOR_TRUTH_TPU_DATA_DIR", str(tmp_path / "data"))
    loop = asyncio.new_event_loop()
    clients = []

    def start(pkg, seat=True, **kw):
        manager = importlib.import_module(f"{pkg}.models.manager").ModelManager
        manager.reset_instance()
        if seat:
            emb, rr = runtimes["ref" if pkg == REF else "port"]
            monkeypatch.setattr(manager.get_instance(), "get_embedder", lambda spec=None, **_: emb)
            monkeypatch.setattr(manager.get_instance(), "get_reranker", lambda spec=None, **_: rr)
        cfg = importlib.import_module(f"{pkg}.app.config").TensorTruthTPUConfig.default()
        cfg.rag.default_embedding_model = "tiny-embedder"
        cfg.rag.default_reranker = "tiny-reranker"
        cfg.rag.use_fused_topk = False
        cfg.rag.corpus_dtype = "float32"
        kw = {"device": "cpu", **kw} if pkg == PORT else kw
        app = importlib.import_module(f"{pkg}.server.app").create_app(data_dir=tmp_path / pkg, config=cfg, **kw)
        delta = importlib.import_module(f"{pkg}.core.providers").ChatDelta
        app["services"].rag_service._llm_factory = lambda params: FakeLLM(delta)
        client = TestClient(TestServer(app, loop=loop), loop=loop)
        loop.run_until_complete(client.start_server())
        clients.append(client)
        return client

    def run(coro):
        return loop.run_until_complete(coro)

    yield start, run
    for client in clients:
        loop.run_until_complete(client.close())
    loop.close()
    for pkg in PKGS:
        importlib.import_module(f"{pkg}.models.manager").ModelManager.reset_instance()


def _scrub(obj):
    """``obj`` with the values of VOLATILE keys replaced by a marker, a
    scope index's name (its session id, then ``/index``) by ``<scope>``, and
    the port's package name by the reference's."""
    if isinstance(obj, dict):
        return {k: "<volatile>" if k in VOLATILE else _scrub(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    if isinstance(obj, str):  # a module path names its own package
        return re.sub(r"\b[0-9a-f]{12}/index\b", "<scope>/index", obj).replace(f"{PORT}.", f"{REF}.")
    return obj


def assert_same(got, want, where="$"):
    """Same keys and values; floats within SCORE_ATOL."""
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, (where, got, want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (where, sorted(set(got) ^ set(want)))
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), (where, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0, err_msg=where)
    else:
        assert got == want, (where, got, want)


async def _json(resp):
    return [resp.status, _scrub(await resp.json())]


async def _ws(client, sid, *messages):
    """Send each message on one socket; the frames of each up to its done
    or error (and the title frame that follows a first exchange)."""
    ws = await client.ws_connect(f"/ws/chat/{sid}")
    out = []
    for i, message in enumerate(messages):
        await ws.send_json({"message": message})
        frames = []
        while True:
            frames.append(await ws.receive_json(timeout=120))
            if frames[-1]["type"] in ("done", "error"):
                break
        if frames[-1]["type"] == "done" and not message.startswith("/") and i == 0:
            frames.append(await ws.receive_json(timeout=30))  # the title
        out.append(_scrub(frames))
    await ws.close()
    return out


async def _session(client, **body):
    r = await client.post("/api/sessions", json=body)
    assert r.status == 200
    return (await r.json())["id"]


# -- the flows, each run against both apps ------------------------------------


async def flow_health(client):
    return [await _json(await client.get("/health"))]


async def flow_session_lifecycle(client):
    out = []
    r = await client.post("/api/sessions", json={"modules": ["alpha"], "title": "T"})
    sid = (await r.json())["id"]
    out.append(_scrub(await r.json()))
    out.append(await _json(await client.post(f"/api/sessions/{sid}/messages", json={"role": "user", "content": "hi"})))
    out.append(await _json(await client.get(f"/api/sessions/{sid}/messages")))
    out.append(await _json(await client.patch(f"/api/sessions/{sid}", json={"title": "renamed"})))
    out.append(await _json(await client.get("/api/sessions")))
    out.append(await _json(await client.delete(f"/api/sessions/{sid}")))
    out.append((await client.get(f"/api/sessions/{sid}")).status)
    return out


async def flow_config_round_trip(client):
    out = [await _json(await client.get("/api/config"))]
    out.append(await _json(await client.patch("/api/config", json={"llm": {"default_temperature": 0.42}})))
    out.append(await _json(await client.get("/api/config/defaults")))
    sid = await _session(client)
    out.append(await _json(await client.get(f"/api/sessions/{sid}")))  # the patched default applies
    return out


async def flow_rerankers_crud(client):
    out = [await _json(await client.get("/api/rerankers"))]
    out.append(await _json(await client.post("/api/rerankers", json={"model_id": "tiny-reranker"})))
    out.append((await client.post("/api/rerankers", json={"model_id": "no-such-model"})).status)
    out.append(await _json(await client.delete("/api/rerankers/tiny-reranker")))
    out.append(await _json(await client.get("/api/rerankers")))
    return out


async def flow_upload_then_rag_query(client):
    sid = await _session(client, modules=["alpha"])
    out = [await _json(await client.post(f"/api/sessions/{sid}/documents", json=UPLOAD))]
    out.append(await _json(await client.get(f"/api/sessions/{sid}/documents")))
    out += await _ws(client, sid, "what is the MXU?", "Paragraph 3 about topic 3")
    sources = [f for f in out[2] if f["type"] == "sources"][0]["sources"]
    assert any("systolic" in s["content"] for s in sources)  # the uploaded document
    return out


async def flow_rest_chat(client):
    sid = await _session(client, modules=["alpha"])
    out = [await _json(await client.post(f"/api/sessions/{sid}/chat", json={"message": "Paragraph 7 about topic 0"}))]
    assert out[0][0] == 200 and out[0][1]["sources"]
    out.append(await _json(await client.get(f"/api/sessions/{sid}/messages")))
    return out


async def flow_ws_help(client):
    sid = await _session(client)
    out = await _ws(client, sid, "/help")
    assert out[0][-1]["type"] == "done" and any("Available commands" in f.get("content", "") for f in out[0])
    return out


async def flow_ws_chat(client):
    sid = await _session(client, modules=["alpha"])
    out = await _ws(client, sid, "w12_5 w12_6 w12_7", "topic 5 w30_1 w30_2")
    for frames in out:
        types = [f["type"] for f in frames]
        assert "error" not in types and "sources" in types and "done" in types, types
    out.append(await _json(await client.get(f"/api/sessions/{sid}/messages")))
    return out


async def flow_project_lifecycle(client):
    r = await client.post("/api/projects", json={"name": "P", "modules": ["alpha"], "params": {"temperature": 0.3},
                                                 "system_prompt": "Answer tersely."})
    pid = (await r.json())["id"]
    out = [_scrub(await r.json())]
    out.append(await _json(await client.post(f"/api/projects/{pid}/sessions", json={})))
    out.append(await _json(await client.get(f"/api/projects/{pid}/sessions")))
    out.append(await _json(await client.get("/api/projects")))
    out.append(await _json(await client.delete(f"/api/projects/{pid}")))
    return out


async def flow_documents_reindex_and_delete(client):
    sid = await _session(client)
    r = await client.post(f"/api/sessions/{sid}/documents", json=UPLOAD)
    doc = await r.json()
    out = [_scrub(doc)]
    out.append(await _json(await client.post(f"/api/sessions/{sid}/documents/reindex")))
    out.append(await _json(await client.delete(f"/api/sessions/{sid}/documents/{doc['doc_id']}")))
    out.append(await _json(await client.get(f"/api/sessions/{sid}/pdfs")))
    return out


async def flow_startup_modules_and_rag_status(client):
    out = [await _json(await client.get(path)) for path in ("/api/startup/status", "/api/modules",
                                                            "/api/embedding-models")]
    sid = await _session(client, modules=["alpha"])
    for _ in range(2):  # before and after a chat; the resident models' entries differ by package
        status = await (await client.get("/api/system/rag/status")).json()
        # the port's own set-up account, also beside its batcher's counters (test_torch_setup_account.py)
        (status["batcher"] or {}).pop("setup", None)
        out.append({**{k: _scrub(status[k]) for k in ("engine", "batcher")},
                    "stages": sorted(status["last_query_timings"])})  # host ms: the names only
        await client.post(f"/api/sessions/{sid}/chat", json={"message": "topic 5 w30_1 w30_2"})
    return out


async def flow_tools_tasks_commands_mcp(client):
    out = [await _json(await client.get(path)) for path in (
        "/api/tools", "/api/agents", "/api/tasks", "/api/commands", "/api/mcp-servers", "/api/mcp-servers/presets")]
    out.append(await _json(await client.post("/api/mcp-servers", json={"name": "t", "command": "python"})))
    out.append(await _json(await client.patch("/api/mcp-servers/t/toggle")))
    out.append(await _json(await client.delete("/api/mcp-servers/t")))
    return out


FLOWS = {name[5:]: fn for name, fn in globals().items() if name.startswith("flow_")}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_port_app_answers_as_the_reference(served, flow):
    start, run = served
    want, got = (run(FLOWS[flow](start(pkg))) for pkg in PKGS)
    assert_same(got, want)


def test_device_routes_report_the_servers_device(served):
    start, run = served

    async def devices(client):
        return [await (await client.get(path)).json() for path in
                ("/api/system/devices", "/api/config/devices", "/api/system/memory")]

    want, got = (run(devices(start(pkg))) for pkg in PKGS)
    assert want[0]["backend"] == want[1]["default_backend"] == "cpu"
    assert got[0]["backend"] == got[1]["default_backend"] == "cpu"
    for i in range(3):
        assert len(got[i]["devices"]) == 1
        assert got[i]["devices"][0]["platform"] == got[i]["devices"][0]["kind"] == "cpu"
        assert all(sorted(d) == sorted(got[i]["devices"][0]) for d in want[i]["devices"])
        assert {d["platform"] for d in want[i]["devices"]} == {"cpu"}
    assert got[2]["devices"][0]["bytes_in_use"] is None and got[2]["ram"].keys() == want[2]["ram"].keys()


def test_profile_routes_write_a_torch_trace(served, tmp_path):
    start, run = served

    async def profile(client):
        start_r = await client.post("/api/system/profile/start", json={"log_dir": str(tmp_path / "prof")})
        again = await client.post("/api/system/profile/start", json={})
        sid = await _session(client, modules=["alpha"])
        await client.post(f"/api/sessions/{sid}/chat", json={"message": "Paragraph 3 about topic 3"})
        stop = await client.post("/api/system/profile/stop")
        stop_again = await client.post("/api/system/profile/stop")
        return start_r.status, again.status, await stop.json(), stop_again.status

    started, again, stopped, stop_again = run(profile(start(PORT)))
    assert (started, again, stop_again) == (200, 409, 409)
    trace = pathlib.Path(stopped["trace"])
    assert stopped["status"] == "stopped" and trace.parent == tmp_path / "prof"
    assert "aten::" in trace.read_text()  # the chat's host ops


# The serving path's spans (utils/profiling.py), one WebSocket message through it.
SPANS = {"ws.message", "route.session_io", "route.title", "route.context", "rag.retrieve", "batcher.queue",
         "batcher.dispatch", "batcher.finish", "query_step", "search", "rerank.launch", "rerank.finish", "llm.stream"}
# The set-up spans of the engine's cold load that the first message waits for (the models are seated here, so no
# tt.setup.model): the load runs on the executor and serves every message that waits for it, so they carry no id.
SETUP_SPANS = {"setup.engine", "setup.index_read"}


def test_ws_message_spans_each_layer_under_its_id(served, tmp_path):
    """A trace taken through the profile routes around one WebSocket message
    (the app's default batcher on) holds every span of the serving path
    under the message's id, in the ring and in the exported Chrome trace
    (``tt.<name>@<id>``; the queue wait crosses threads and is kept in the
    ring only). The dispatch names the message, no span counts more real
    tokens than slots, and the reranker scores each of the query's 10
    candidates."""
    import json
    import time

    from tensortruth_tpu_torch.utils import profiling

    start, run = served
    client = start(PORT)

    async def chat():
        sid = await _session(client, modules=["alpha"])
        await client.post("/api/system/profile/start", json={"log_dir": str(tmp_path / "prof")})
        t0 = time.perf_counter()
        frames = (await _ws(client, sid, "Paragraph 3 about topic 3"))[0]
        t1 = time.perf_counter()
        stop = await (await client.post("/api/system/profile/stop")).json()
        return frames, t0, t1, stop

    frames, t0, t1, stop = run(chat())
    assert [f["type"] for f in frames][-3:] == ["sources", "done", "title"]
    recs = profiling.recorded(t0, t1)
    assert {r.name for r in recs} == {"tt." + name for name in SPANS | SETUP_SPANS}
    cold = [r for r in recs if r.name in {"tt." + name for name in SETUP_SPANS}]
    assert [r.rids for r in cold] == [(), ()]
    recs = [r for r in recs if r not in cold]
    (msg,) = [r for r in recs if r.name == "tt.ws.message"]
    assert len(msg.rids) == 1 and all(r.rids == msg.rids for r in recs)
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
    (dispatch,) = by_name["tt.batcher.dispatch"]
    (queue,) = by_name["tt.batcher.queue"]
    (launch,) = by_name["tt.rerank.launch"]
    (step,) = by_name["tt.query_step"]
    assert dispatch.counts == {"requests": 1} and queue.t1 <= dispatch.t0 + 1e-3
    assert step.counts["queries"] == 1 and 0 < step.counts["tokens"] <= step.counts["slots"]
    assert launch.counts["pairs"] == 10 * dispatch.counts["requests"]
    assert 0 < launch.counts["tokens"] <= launch.counts["slots"] and launch.counts["forwards"] >= 1
    assert {r.thread for r in by_name["tt.route.session_io"]} == {msg.thread}
    assert [r.counts.get("bytes", 0) > 0 for r in by_name["tt.route.session_io"]] == [False, True, True, True]
    (rid,) = msg.rids
    events = json.loads(pathlib.Path(stop["trace"]).read_text())["traceEvents"]
    named = {e["name"] for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith("tt.")}
    assert named == {f"tt.{name}@{rid}" for name in SPANS - {"batcher.queue"}} | {f"tt.{name}" for name in SETUP_SPANS}


def test_default_app_loads_on_cuda_and_never_answers_from_the_cpu(served):
    """No card here: the engine load raises, the chat gets an error frame
    that names CUDA, and no token, sources or done frame."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default app would load on it")
    start, run = served
    client = start(PORT, seat=False, device="cuda")
    assert client.server.app["services"].device == "cuda"

    async def chat():
        sid = await _session(client, modules=["alpha"])
        return (await _ws(client, sid, "Paragraph 3 about topic 3"))[0]

    frames = run(chat())
    assert [f["type"] for f in frames] == ["error"]
    assert "CUDA" in frames[0]["error"] or "cuda" in frames[0]["error"]


def _top_level(path: pathlib.Path) -> dict[str, str]:
    """Each top-level statement (functions and class methods by qualified
    name, the module's or a class's docstring as ``<docstring>``, anything
    else by its source) -> its source."""
    src = path.read_text(encoding="utf-8")
    tree = ast.parse(src)
    out = {}
    for i, node in enumerate(tree.body):
        text = ast.get_source_segment(src, node)
        if i == 0 and isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
            out["<docstring>"] = text
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = text
        elif isinstance(node, ast.ClassDef):
            for j, item in enumerate(node.body):
                name = getattr(item, "name", None) or ast.get_source_segment(src, item)
                if j == 0 and isinstance(item, ast.Expr) and isinstance(item.value, ast.Constant):
                    name = "<docstring>"
                out[f"{node.name}.{name}"] = ast.get_source_segment(src, item)
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = text
        elif isinstance(node, ast.AnnAssign):
            out[node.target.id] = text
        else:
            out[text] = text
    return out


@pytest.mark.parametrize("path", sorted(ADAPTED))
def test_adapted_module_differs_only_in_its_named_functions(path):
    ref = _top_level(REPO / REF / path)
    port = _top_level(REPO / PORT / path)
    ref = {k.replace(f"{REF}.", f"{PORT}."): v.replace(f"{REF}.", f"{PORT}.") for k, v in ref.items()}
    differ = {k for k in ref.keys() | port.keys() if ref.get(k) != port.get(k)}
    assert differ == ADAPTED[path], sorted(differ)


def test_port_rag_service_takes_the_servers_device():
    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig
    from tensortruth_tpu_torch.server.deps import ServiceContainer

    assert ServiceContainer(config=TensorTruthTPUConfig.default()).rag_service.device == "cuda"
    assert ServiceContainer(config=TensorTruthTPUConfig.default(), device="cpu").rag_service.device == "cpu"


STATIC = sorted(p.relative_to(REPO / REF / "static") for p in (REPO / REF / "static").rglob("*") if p.is_file())


@pytest.mark.parametrize("rel", STATIC, ids=str)
def test_static_file_is_byte_equal(rel):
    assert (REPO / PORT / "static" / rel).read_bytes() == (REPO / REF / "static" / rel).read_bytes()


def test_static_dirs_hold_the_same_files():
    port = sorted(p.relative_to(REPO / PORT / "static") for p in (REPO / PORT / "static").rglob("*") if p.is_file())
    assert port == STATIC and len(STATIC) > 50
    from tensortruth_tpu_torch.server.app import STATIC_DIR

    assert STATIC_DIR == REPO / PORT / "static"
