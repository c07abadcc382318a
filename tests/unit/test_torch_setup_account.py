"""The port's set-up account (``tensortruth_tpu_torch/utils/profiling.py``:
``SetupAccount``, the process's ``SETUP``), on the CPU with the tiny models.

* Served through the port's app (``aiohttp.test_utils``) over a tiny module,
  one session create and one WebSocket chat message leave ``setup`` in
  ``/api/system/rag/status`` (and beside the batcher's counters): the
  engine's cold load, its index read and its two model loads, all inside the
  served time, and one message and one session counted.
* A second message loads nothing and adds served time.
* On a fake clock, overlapping requests count their wall time once, and a
  phase keeps the part of it that fell in served time.
* The totals fill with no profiler running, and recording nothing then;
  under a profiler a cold load is span ``tt.setup.engine`` with
  ``tt.setup.index_read`` and ``tt.setup.model`` under it.
"""

import asyncio
import time

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from torch.profiler import ProfilerActivity, profile

from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig
from tensortruth_tpu_torch.core.providers import ChatDelta
from tensortruth_tpu_torch.engine import load_engine_for_modules
from tensortruth_tpu_torch.index import VectorIndex, chunk_document
from tensortruth_tpu_torch.models.manager import ModelManager, ModelSpec
from tensortruth_tpu_torch.server.app import create_app
from tensortruth_tpu_torch.utils import profiling

torch.set_num_threads(1)


class FakeLLM:
    def complete(self, prompt):
        return "standalone"

    def stream_chat(self, messages, system=None):
        yield ChatDelta(text="answered")


def tiny_config() -> TensorTruthTPUConfig:
    cfg = TensorTruthTPUConfig.default()
    cfg.rag.default_embedding_model = "tiny-embedder"
    cfg.rag.default_reranker = "tiny-reranker"
    cfg.rag.use_fused_topk = False
    cfg.rag.corpus_dtype = "float32"
    return cfg


@pytest.fixture
def module(tmp_path, monkeypatch, sample_text):
    """The ``alpha`` module's index under ``tmp_path/indexes``, embedded by
    the tiny embedder; then an empty model manager and a fresh account."""
    monkeypatch.setenv("TENSOR_TRUTH_TPU_INDEXES_DIR", str(tmp_path / "indexes"))
    monkeypatch.setenv("TENSOR_TRUTH_TPU_DATA_DIR", str(tmp_path / "data"))
    ModelManager.reset_instance()
    embedder = ModelManager.get_instance().get_embedder(ModelSpec("tiny-embedder", dtype="float32"), device="cpu")
    nodes = chunk_document(sample_text, embedder.tokenizer, doc_id="alpha", module="alpha",
                           chunk_sizes=[128, 32], chunk_overlap=8,
                           metadata={"filename": "alpha.md", "doc_type": "library"})
    path = tmp_path / "indexes" / "tiny-embedder" / "alpha"
    VectorIndex.build(nodes, embedder.encode, embedding_model="tiny-embedder", chunk_sizes=[128, 32],
                      chunk_overlap=8, gelu_flavor=embedder.gelu_flavor).save(path)
    ModelManager.reset_instance()
    monkeypatch.setattr(profiling, "SETUP", profiling.SetupAccount())
    yield path
    ModelManager.reset_instance()


@pytest.fixture
def chat(module, tmp_path):
    """``chat(n)``: on the port's app over ``alpha``, one session create and
    ``n`` messages on one socket, then ``/api/system/rag/status`` after
    each message."""
    app = create_app(data_dir=tmp_path / "data", config=tiny_config(), device="cpu")
    app["services"].rag_service._llm_factory = lambda params: FakeLLM()
    loop = asyncio.new_event_loop()
    client = TestClient(TestServer(app, loop=loop), loop=loop)
    loop.run_until_complete(client.start_server())

    async def session(n):
        sid = (await (await client.post("/api/sessions", json={"modules": ["alpha"]})).json())["id"]
        ws = await client.ws_connect(f"/ws/chat/{sid}")
        statuses = []
        for i in range(n):
            await ws.send_json({"message": f"topic {i} w30_1 w30_2"})
            while True:
                frame = await ws.receive_json(timeout=120)
                assert frame["type"] != "error", frame
                if frame["type"] == "done":
                    break
            # the title frame follows a first exchange
            if i == 0:
                assert (await ws.receive_json(timeout=120))["type"] == "title"
            statuses.append(await (await client.get("/api/system/rag/status")).json())
        await ws.close()
        return statuses

    yield lambda n: loop.run_until_complete(session(n))
    loop.run_until_complete(client.close())
    loop.close()


def test_one_message_leaves_the_cold_load_inside_the_served_time(chat, module):
    (status,) = chat(1)
    setup = status["setup"]
    assert status["batcher"]["setup"] == setup
    assert setup["engine_s"] > 0 and setup["index_read_s"] > 0 and setup["models_s"] > 0
    assert setup["engine_n"] == setup["index_read_n"] == 1 and setup["models_n"] == 2
    assert setup["index_read_s"] + setup["models_s"] <= setup["engine_s"]
    # the first message waits for the cold load: all of it is served time
    assert setup["engine_busy_s"] == pytest.approx(setup["engine_s"], abs=1e-3)
    assert setup["busy_s"] >= setup["engine_s"]
    index = VectorIndex.load(module)
    assert setup["index_read_rows"] == index.n_rows and setup["index_read_nodes"] == len(index.store)
    for role in ("embedder", "reranker"):
        assert 0 < setup[f"{role}_tokenizer_s"] + setup[f"{role}_weights_s"] <= setup[f"{role}_s"]
    assert setup["embedder_s"] + setup["reranker_s"] <= setup["models_s"]
    assert (setup["messages"], setup["sessions"]) == (1, 1)
    assert setup["kernels_n"] == 0  # no kernel library on the CPU


def test_a_second_message_loads_nothing_and_adds_served_time(chat):
    first, second = (status["setup"] for status in chat(2))
    for key in ("engine_s", "engine_n", "index_read_s", "models_s", "models_n"):
        assert second[key] == first[key], key
    assert second["busy_s"] > first["busy_s"]
    assert (second["messages"], second["sessions"]) == (2, 1)


def test_overlapping_requests_count_once_on_a_fake_clock():
    now = [0.0]
    account = profiling.SetupAccount(clock=lambda: now[0])

    def at(t):
        now[0] = t

    message, session, handshake = account.serving("messages"), account.serving("sessions"), account.serving()
    at(1.0)
    message.__enter__()
    at(3.0)
    session.__enter__()
    with account.phase("engine", served=True):
        at(4.0)
        message.__exit__(None, None, None)
        handshake.__enter__()
        at(6.0)
        session.__exit__(None, None, None)
        at(7.0)
        handshake.__exit__(None, None, None)
        at(8.0)
    assert account.snapshot()["busy_s"] == 6.0  # 1 to 7, the overlaps once
    at(10.0)
    with account.serving("messages"):
        at(12.0)
        open_stretch = account.snapshot()  # a request in flight counts up to now
    snap = account.snapshot()
    assert open_stretch["busy_s"] == snap["busy_s"] == 8.0
    assert (snap["messages"], snap["sessions"]) == (2, 1)  # a handshake is served time, not counted
    assert (snap["engine_s"], snap["engine_n"], snap["engine_busy_s"]) == (5.0, 1, 4.0)  # 3 to 8, served 3 to 7


def test_totals_fill_without_a_profiler_and_spans_nest_under_one(module, tmp_path):
    def cold_load():
        ModelManager.reset_instance()
        return load_engine_for_modules(["alpha"], config=tiny_config(), indexes_dir=tmp_path / "indexes",
                                       device="cpu")

    assert not torch.autograd.profiler._is_profiler_enabled
    before = list(profiling._ring)
    cold_load()
    snap = profiling.SETUP.snapshot()
    assert snap["engine_n"] == snap["index_read_n"] == 1 and snap["models_n"] == 2
    assert snap["engine_s"] > snap["index_read_s"] + snap["models_s"] > 0
    assert snap["engine_busy_s"] == snap["busy_s"] == 0  # nothing served: no request in flight
    assert list(profiling._ring) == before  # no profiler, no record

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        cold_load()
        t1 = time.perf_counter()
    recs = profiling.recorded(t0, t1)
    (engine,) = [r for r in recs if r.name == "tt.setup.engine"]
    (read,) = [r for r in recs if r.name == "tt.setup.index_read"]
    models = [r for r in recs if r.name == "tt.setup.model"]
    assert engine.parent is None and read.parent == engine.seq and len(models) == 2
    assert all(m.parent == engine.seq and engine.t0 <= m.t0 <= m.t1 <= engine.t1 for m in models)
    names = {e.key for e in prof.key_averages()}
    assert {"tt.setup.engine", "tt.setup.index_read", "tt.setup.model"} <= names
    assert profiling.SETUP.snapshot()["engine_n"] == 2
