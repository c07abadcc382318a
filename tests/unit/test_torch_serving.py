"""Serving under load and B1's recall: the port's two drivers on the CPU.

* The serving driver (``scripts/measure_serving_e2e.py``) at its
  ``SERVE_TINY`` size: 4,096 synthetic leaves of D = 64, the tiny models,
  8 concurrent WebSocket sessions, a 2 s window, its fake Ollama and the
  port's app in threads of one fresh interpreter (``in_process=True``; the
  subprocess bounds the test at 120 s and keeps the app's singletons out of
  this one). The batcher must coalesce (fewer batches than requests), every
  answer must carry sources, and the first 32 queries of the window (all of
  them, if a loaded host answers fewer), sent again one at a time, must
  give the concurrent answers' sources. The recall driver then runs in the
  same interpreter, and nothing of the JAX package, jax or triton may have
  loaded.
* The driver's subprocess layout: each child binds a free port and reports
  it through a file; a child that cannot bind fails the start, and a dead
  child fails the health wait, instead of the driver measuring whatever
  else answers on that port.
* The same queries sent concurrently through both packages'
  ``RAGService.enable_batching`` over one index dir (``test_torch_e2e.py``'s
  ``env``): the same node ids in the same order, scores within 1e-5
  (float32 corpus; float32 math in other orders through two encoder layers).
* The fake Ollama's ``fake-tools`` turn, parsed by the port's own Ollama
  provider, is one ``rag_query`` call on the user's message.
* The recall driver (``scripts/measure_recall.py``) at a small N on the CPU
  (B1's plain version) gives the recall that the reference's ``fused_topk``
  in interpret mode gives on the same inputs, against each package's exact
  top-k.
"""

import json
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_e2e import QUERIES, _services, env, runtimes  # noqa: F401 (fixtures)

from tensortruth_tpu.ops import topk as ref_topk
from tensortruth_tpu_torch.core.providers import ModelReference, OllamaLLM, ProviderRegistry
from tensortruth_tpu_torch.app.config import ProviderConfig
from tensortruth_tpu_torch.scripts import measure_recall, measure_serving_e2e
from tensortruth_tpu_torch.scripts.measure_serving_e2e import FAKE_MODEL, TOOLS_MODEL, ThreadedApp, fake_ollama_app

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[2]
SCORE_ATOL = 1e-5

_DRIVE = """
import json, sys
import torch
torch.set_num_threads(2)
from tensortruth_tpu_torch.scripts import measure_recall, measure_serving_e2e as m
out = m.run(n_chunks=4096, dim=64, concurrency=8, measure_s=2.0, warmup=1, data_dir=sys.argv[1],
            in_process=True, tiny=True)
out["recall"] = measure_recall.run(device="cpu", n=4096, d=64, b=4)
out["foreign"] = sorted(k for k in sys.modules if k.split(".")[0] in ("tensortruth_tpu", "jax", "jaxlib", "triton"))
print(json.dumps(out))
"""


def test_serving_driver_coalesces_and_batched_answers_equal_sequential(tmp_path):
    out = subprocess.run([sys.executable, "-c", _DRIVE, str(tmp_path)], capture_output=True, text=True,
                         timeout=120, cwd=REPO, env={**os.environ, "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    batcher = res["batcher"]
    assert batcher["batches_run"] < batcher["requests_served"], batcher
    assert res["n_chunks"] == 4096 and res["messages"] > 0 and res["qps"] > 0 and res["device"] == "cpu"
    # the window's first 32 answers (fewer when a loaded host answers fewer)
    compared = res["batched_vs_sequential"]
    assert compared["queries"] == min(32, res["messages"]) and compared["disagree"] == [], compared
    assert res["sourceless"] == 0 and res["answered"] >= res["messages"] + compared["queries"]
    assert res["p50_ms"] <= res["p95_ms"]
    assert res["recall"]["recall@10"] > 0 and res["foreign"] == [], res["foreign"]


def test_subprocess_children_bind_free_ports_and_report_them(tmp_path):
    procs, ports = [], set()
    try:
        for sub in ("a", "b"):  # two drivers' fakes side by side
            (tmp_path / sub).mkdir()
            proc, port = measure_serving_e2e.start_child("fake-ollama", tmp_path / sub, 0, "cpu", timeout=60)
            procs.append(proc)
            ports.add(port)
            llm = OllamaLLM(f"http://127.0.0.1:{port}", FAKE_MODEL)
            assert [d.text for d in llm.stream_chat([{"role": "user", "content": "hi"}])] == ["Answer."]
        assert len(ports) == 2 and 0 not in ports
    finally:
        measure_serving_e2e.stop_children(procs)
    assert all(p.returncode is not None for p in procs)


def test_a_child_that_cannot_bind_fails_the_start_and_a_dead_one_the_health_wait(tmp_path):
    import asyncio
    import socket

    with socket.socket() as held:
        held.bind(("127.0.0.1", 0))
        held.listen()
        with pytest.raises(RuntimeError, match="fake-ollama exited"):
            measure_serving_e2e.start_child("fake-ollama", tmp_path, held.getsockname()[1], "cpu", timeout=60)
        assert "did not start" in (tmp_path / "fake-ollama.log").read_text()
        proc, port = measure_serving_e2e.start_child("fake-ollama", tmp_path, 0, "cpu", timeout=60)
        measure_serving_e2e.stop_children([proc])
        # a dead child fails the wait even while another server answers
        with pytest.raises(RuntimeError, match="fake-ollama exited"):
            asyncio.run(measure_serving_e2e.wait_health(f"http://127.0.0.1:{held.getsockname()[1]}",
                                                        timeout=5, procs=[proc]))


def test_concurrent_batched_retrieval_matches_reference(env):  # noqa: F811
    ref, port, _ = _services(env, {"reranker_top_n": 3, "corpus_dtype": "float32"})
    queries = [f"{q} {i}" for i in range(4) for q in QUERIES]
    answers = {}
    for name, svc in (("ref", ref), ("port", port)):
        svc.enable_batching(max_batch=8, max_wait_ms=50.0)
        try:
            with ThreadPoolExecutor(len(queries)) as pool:
                answers[name] = list(pool.map(svc.retrieve, queries))
            served, batches = svc._batcher.requests_served, svc._batcher.batches_run
        finally:
            svc.disable_batching()
        assert served == len(queries) and batches < served, (name, batches, served)
    for want, got in zip(answers["ref"], answers["port"]):
        assert got.sources and [s.id for s in got.sources] == [s.id for s in want.sources]
        np.testing.assert_allclose([s.score for s in got.sources], [s.score for s in want.sources],
                                   atol=SCORE_ATOL, rtol=0)


@pytest.fixture
def fake_ollama():
    app = ThreadedApp(fake_ollama_app()).start()
    yield f"http://127.0.0.1:{app.port}"
    app.stop()


RAG_QUERY_SCHEMA = {"name": "rag_query", "description": "search", "parameters": {
    "type": "object", "properties": {"query": {"type": "string"}}, "required": ["query"]}}


def test_fake_tools_turn_is_one_rag_query_call(fake_ollama):
    llm = OllamaLLM(fake_ollama, TOOLS_MODEL)
    messages = [{"role": "user", "content": "How are leaves merged?"}]
    text, calls = llm.chat_with_tools(messages, [RAG_QUERY_SCHEMA])
    assert text == "" and calls == [{"name": "rag_query", "arguments": {"query": "How are leaves merged?"}}]
    # with the tool's result in the history, the model answers
    messages += [{"role": "assistant", "content": "", "tool_calls": []},
                 {"role": "tool", "name": "rag_query", "content": "[1] leaves"}]
    assert llm.chat_with_tools(messages, [RAG_QUERY_SCHEMA]) == (measure_serving_e2e.FAKE_ANSWER, [])
    assert [d.text for d in OllamaLLM(fake_ollama, FAKE_MODEL).stream_chat(messages[:1])] == ["Answer."]


@pytest.mark.parametrize("model,tools", [(TOOLS_MODEL, True), (FAKE_MODEL, False)])
def test_fake_ollama_reports_tool_calling_for_fake_tools_only(fake_ollama, model, tools):
    registry = ProviderRegistry([ProviderConfig(base_url=fake_ollama)])
    ref = registry.resolve_model(model)
    assert ref == ModelReference("ollama", model)
    assert registry.check_capability(ref, "tools") is tools


def test_recall_driver_matches_reference_interpret():
    n, d, b = 32_768, 64, 8
    got = measure_recall.run(device="cpu", n=n, d=d, b=b)
    q, corpus = measure_recall.make_inputs("cpu", n, d, b)
    jq, jcorpus = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, corpus[:n]))
    for k in measure_recall.KS:
        _, exact = ref_topk.exact_topk(jq, jcorpus, k)
        _, fused = ref_topk.fused_topk(jq, jcorpus, k, m=measure_recall.M, tile_n=measure_recall.TILE_N,
                                       c_out=measure_recall.C_OUT)
        want = measure_recall.recall_of(np.asarray(exact), np.asarray(fused))
        assert got[f"recall@{k}"] == want, (k, got, want)
        assert got[f"predicted@{k}"] == 1 - k * (k - 1) / (2 * 8192) / k
    assert got["n"] == n and got["c_out"] == 8192 and got["card"] is None
