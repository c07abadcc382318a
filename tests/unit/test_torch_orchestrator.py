"""The orchestrator's path (a session whose model reports tool calling)
through both packages' apps, side by side.

Each app's config points its Ollama provider at the fake Ollama of the
port's serving driver (``scripts/measure_serving_e2e.py``), run in a thread:
its ``fake-tools`` model reports tool calling on ``/api/show`` and answers a
turn that carries tools with one ``rag_query`` call on the user's message.
No LLM factory is seated, so each package's own provider code (the
registry's capability probe, ``create_llm``, ``OllamaLLM.chat_with_tools``)
talks to it. Both apps serve one ``alpha`` index over the same tiny float32
weights (``test_torch_e2e.py``'s ``runtimes``).

C-4 (ROADMAP C): when retrieval raises (a failed kernel), the reference's
agent turns the exception into an ``ERROR: ...`` tool result and the client
gets ``done`` with no sources; the port lets it leave the agent, the route
falls back to the direct path, which raises too, and the client gets an
``error`` frame. With retrieval working, both give the same ``sources`` for
the same message: node ids and order equal, scores within 1e-5 (float32
math in other orders through two encoder layers). The port's agent lets an
exception out only for a tool whose ``ToolSpec.propagate_errors`` is set,
whatever its name.
"""

import asyncio
import importlib

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from test_torch_e2e import runtimes  # noqa: F401 (fixture)

from tensortruth_tpu.index import VectorIndex, chunk_document
from tensortruth_tpu_torch.scripts.measure_serving_e2e import TOOLS_MODEL, ThreadedApp, fake_ollama_app

torch.set_num_threads(1)

REF, PORT = "tensortruth_tpu", "tensortruth_tpu_torch"
SCORE_ATOL = 1e-5


def _reset_providers():
    for pkg in (REF, PORT):
        providers = importlib.import_module(f"{pkg}.core.providers")
        providers.ProviderRegistry.reset_instance()
        providers.clear_llm_cache()


@pytest.fixture
def apps(tmp_path, monkeypatch, sample_text, runtimes):  # noqa: F811
    """``start(pkg)`` -> a started TestClient over ``pkg``'s app, its
    provider at the fake Ollama; and the ``alpha`` index's longest leaf."""
    embedder = runtimes["ref"][0]
    nodes = chunk_document(sample_text, embedder.tokenizer, doc_id="alpha", module="alpha",
                           chunk_sizes=[128, 32], chunk_overlap=8,
                           metadata={"filename": "alpha.md", "doc_type": "library"})
    VectorIndex.build(nodes, embedder.encode, embedding_model="tiny-embedder", chunk_sizes=[128, 32],
                      chunk_overlap=8, gelu_flavor=embedder.gelu_flavor).save(
        tmp_path / "indexes" / "tiny-embedder" / "alpha")
    monkeypatch.setenv("TENSOR_TRUTH_TPU_INDEXES_DIR", str(tmp_path / "indexes"))
    monkeypatch.setenv("TENSOR_TRUTH_TPU_DATA_DIR", str(tmp_path / "data"))
    ollama = ThreadedApp(fake_ollama_app()).start()
    loop = asyncio.new_event_loop()
    clients = []

    def start(pkg):
        _reset_providers()
        manager = importlib.import_module(f"{pkg}.models.manager").ModelManager
        manager.reset_instance()
        emb, rr = runtimes["ref" if pkg == REF else "port"]
        monkeypatch.setattr(manager.get_instance(), "get_embedder", lambda spec=None, **_: emb)
        monkeypatch.setattr(manager.get_instance(), "get_reranker", lambda spec=None, **_: rr)
        cfg = importlib.import_module(f"{pkg}.app.config").TensorTruthTPUConfig.default()
        cfg.rag.default_embedding_model = "tiny-embedder"
        cfg.rag.default_reranker = "tiny-reranker"
        cfg.rag.use_fused_topk = False
        cfg.rag.corpus_dtype = "float32"
        cfg.conversation.max_history_turns = 0
        cfg.providers[0].base_url = f"http://127.0.0.1:{ollama.port}"
        kw = {"device": "cpu"} if pkg == PORT else {}
        app = importlib.import_module(f"{pkg}.server.app").create_app(data_dir=tmp_path / pkg, config=cfg, **kw)
        assert app["services"].rag_service._llm_factory is None
        client = TestClient(TestServer(app, loop=loop), loop=loop)
        loop.run_until_complete(client.start_server())
        clients.append(client)
        return client

    leaf = max((n for n in nodes if n.is_leaf), key=lambda n: len(n.text))
    yield start, loop.run_until_complete, leaf
    for client in clients:
        loop.run_until_complete(client.close())
    loop.close()
    ollama.stop()
    _reset_providers()
    for pkg in (REF, PORT):
        importlib.import_module(f"{pkg}.models.manager").ModelManager.reset_instance()


async def _orchestrate(client, message: str) -> list[dict]:
    """One message through a ``fake-tools`` session over ``alpha``: its
    frames up to ``done`` or ``error``."""
    r = await client.post("/api/sessions", json={"modules": ["alpha"], "params": {"model": TOOLS_MODEL}})
    assert r.status == 200
    sid = (await r.json())["id"]
    ws = await client.ws_connect(f"/ws/chat/{sid}")
    await ws.send_json({"message": message})
    frames = []
    while not frames or frames[-1]["type"] not in ("done", "error"):
        frames.append(await ws.receive_json(timeout=120))
    await ws.close()
    return frames


def _failing(pkg, monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    service = importlib.import_module(f"{pkg}.services.rag_service").RAGService
    monkeypatch.setattr(service, "_retrieve_and_rank", boom)


def test_failed_retrieval_reaches_the_reference_llm_as_text(apps, monkeypatch):
    start, run, leaf = apps
    client = start(REF)
    _failing(REF, monkeypatch)
    frames = run(_orchestrate(client, leaf.text))
    kinds = [f["type"] for f in frames]
    assert kinds[0] == "tool_phase" and frames[0]["tools"] == ["rag_query"]
    progress = next(f for f in frames if f["type"] == "tool_progress")
    assert progress["phase"] == "failed" and progress["output"] == "ERROR: kernel launch failed"
    assert kinds[-1] == "done" and "sources" not in kinds and "error" not in kinds


def test_failed_retrieval_reaches_the_port_client_as_an_error_frame(apps, monkeypatch):
    start, run, leaf = apps
    client = start(PORT)
    _failing(PORT, monkeypatch)
    frames = run(_orchestrate(client, leaf.text))
    kinds = [f["type"] for f in frames]
    assert kinds[0] == "tool_phase" and frames[0]["tools"] == ["rag_query"]
    assert kinds[-1] == "error" and "kernel launch failed" in frames[-1]["error"]
    assert "done" not in kinds and "sources" not in kinds and "tool_progress" not in kinds


def test_orchestrator_sources_match_reference(apps):
    start, run, leaf = apps
    got = {}
    for pkg in (REF, PORT):
        frames = run(_orchestrate(start(pkg), leaf.text))
        kinds = [f["type"] for f in frames]
        assert kinds[0] == "tool_phase" and kinds[-1] == "done" and "error" not in kinds, kinds
        assert frames[0]["calls"] == [{"tool": "rag_query", "params": {"query": leaf.text}}]
        assert kinds.index("sources") < kinds.index("done")
        got[pkg] = next(f for f in frames if f["type"] == "sources")["sources"]
    want, port = got[REF], got[PORT]
    assert want and [s["id"] for s in port] == [s["id"] for s in want]
    np.testing.assert_allclose([s["score"] for s in port], [s["score"] for s in want], atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("propagate", [False, True])
def test_port_agent_raises_only_for_a_tool_that_declares_it(propagate):
    """The port's agent lets a tool's exception out only where the tool's
    ``ToolSpec.propagate_errors`` says so (``rag_query``'s does); the name
    alone decides nothing."""
    from tensortruth_tpu_torch.agents.function_agent import FunctionAgent
    from tensortruth_tpu_torch.services.tool_service import ToolSpec

    async def boom(**kw):
        raise RuntimeError("kernel launch failed")

    class LLM:
        turns = [("", [{"name": "rag_query", "arguments": {"query": "q"}}]), ("fine", None)]

        def chat_with_tools(self, messages, schemas, system_prompt=None):
            return self.turns.pop(0)

    tool = ToolSpec(name="rag_query", description="search", parameters={}, fn=boom, propagate_errors=propagate)
    agent = FunctionAgent(context={"extra_tools": {"rag_query": tool}})

    async def collect():
        return [e async for e in agent.run("q", {"llm": LLM()})]

    if propagate:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            asyncio.run(collect())
    else:
        events = asyncio.run(collect())
        assert agent.full_outputs[0]["output"] == "ERROR: kernel launch failed"
        assert events[-1]["type"] == "agent_done"
