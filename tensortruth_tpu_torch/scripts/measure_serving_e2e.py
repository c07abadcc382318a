"""Serving throughput through the port's real server: concurrent WebSocket
chat sessions coalesced by the query batcher.

    python -m tensortruth_tpu_torch.scripts.measure_serving_e2e              # 1M chunks, one CUDA card
    SERVE_TINY=1 python -m tensortruth_tpu_torch.scripts.measure_serving_e2e # CPU, tiny models

Port of the JAX package's ``scripts/measure_serving_e2e.py``, step for step:
a synthetic module index (1,000,000 distinct leaves at the measured leaf
length mix, four under each parent, random unit rows from numpy's seed 0),
a config with history off and the Ollama provider pointed at a local fake
Ollama (instant short answers, so the time measured is this system's, not a
model's), the port's aiohttp server (``server/app.py::create_app``, which
serves on ``cuda``), and N concurrent WebSocket sessions: WS protocol -> session
service -> ``RAGService`` -> ``QueryBatcher`` micro-batches -> embed + kernel
B1 top-k -> docstore hydration and auto-merge -> cross-query rerank (kernel
B3 on pairs of 512 tokens and more) -> provider-streamed answer -> sources
and done frames. A warm-up runs until the batcher has served CONCURRENCY x
WARMUP requests; the window that follows is measured.

Past the reference, the first CHECK_QUERIES queries of the window are sent
again one at a time in one session after it: each answer's sources must be
the concurrent answer's (``compare_answers``), so the batched path is shown
to give what the unbatched one gives. The fake Ollama also serves
``fake-tools``, a model that reports tool calling and calls ``rag_query``
with the user's message, which drives the orchestrator path.

``run(...)`` takes the reference's sizes as arguments, an existing indexes
directory and module list in place of the synthetic index, and
``in_process=True``: the fake Ollama and the app then run in threads of the
caller's process, each on its own event loop, so the caller's kernel launch
counters see the server's launches. The default is the reference's layout,
two subprocesses. Either way each binds a free port (SERVE_PORT and
SERVE_OLLAMA_PORT name fixed ones); a subprocess writes the port it bound
to a file in the data directory and its output to a log there.

The index persists under $SERVE_DATA_DIR (default ``.serve_data/`` in the
checkout) and is reused across runs; delete it to regenerate. Prints one
JSON line: qps, p50_ms, p95_ms, the batcher's counters, n_chunks, the
batched-vs-sequential comparison and the card's name and power limit.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path

from tensortruth_tpu_torch.scripts import card_line

REPO = Path(__file__).resolve().parents[2]

TINY = bool(os.environ.get("SERVE_TINY"))
DATA_DIR = Path(os.environ.get("SERVE_DATA_DIR", REPO / ".serve_data" / ("tiny" if TINY else "1m")))
PORT = int(os.environ.get("SERVE_PORT", "0"))  # 0: a free port
OLLAMA_PORT = int(os.environ.get("SERVE_OLLAMA_PORT", "0"))
N_CHUNKS = 4_096 if TINY else 1_000_000
DIM = 64 if TINY else 1024
MODULE = "synth1m"
CONCURRENCY = 8 if TINY else 64
MEASURE_S = 10.0 if TINY else 60.0
WARMUP_MSGS_PER_WORKER = 1 if TINY else 2
CHECK_QUERIES = 32
# Batched against sequential answers: the same forwards row for row, at
# another batch bucket. On an H100 they are bit-equal (PERF.md); another
# bucket may pick another GEMM kernel, so sources may differ by this much in
# score (two bf16 steps of a rerank logit near 0, through the sigmoid), and
# two neighbours whose scores lie within it may swap.
SCORE_TOL = 1e-3
# Word counts reproducing the measured leaf-token mix (bench.py _CHUNK_WORDS).
CHUNK_WORDS = [242, 242, 242, 242, 242, 242, 118, 118, 118, 215]
WORDS = "retrieval engine shard merge index token kernel matmul embed chunk".split()
FAKE_MODEL, TOOLS_MODEL = "fake-llm", "fake-tools"
FAKE_ANSWER = "Answer."


# ---------------------------------------------------------------- prepare


def prepare_index(indexes_dir: Path, n_chunks: int = N_CHUNKS, dim: int = DIM, tiny: bool = TINY) -> Path:
    """Build the synthetic module index once; reused while it is valid."""
    import numpy as np

    from tensortruth_tpu_torch.index.nodes import HierarchyStore, Node
    from tensortruth_tpu_torch.index.store import VectorIndex, sanitize_model_id
    from tensortruth_tpu_torch.models.manager import _EMBEDDER_ARCHS, BGE_M3_CONFIG
    from tensortruth_tpu_torch.models.xlmr import use_approx_gelu

    model_id = "tiny-embedder" if tiny else "BAAI/bge-m3"
    idx_dir = indexes_dir / sanitize_model_id(model_id) / f"library_{MODULE}"
    if VectorIndex.is_valid(idx_dir):
        print(f"[prepare] reusing index at {idx_dir}", file=sys.stderr)
        return idx_dir

    t0 = time.time()
    print(f"[prepare] generating {n_chunks}-chunk index at {idx_dir}", file=sys.stderr)
    store = HierarchyStore()
    row_ids: list[str] = []
    # 4 leaves per parent: auto-merge has a real hierarchy to walk.
    for p in range(-(-n_chunks // 4)):
        pid = f"p{p:07d}"
        child_ids = [f"n{j:07d}" for j in range(p * 4, min((p + 1) * 4, n_chunks))]
        first_words = CHUNK_WORDS[(p * 4) % len(CHUNK_WORDS)]
        store.add(Node(
            node_id=pid,
            text=" ".join(f"p{p}" if i == 0 else WORDS[(i + p) % len(WORDS)] for i in range(min(first_words * 4, 900))),
            level=0, doc_id=f"d{p // 256}", module=MODULE, child_ids=child_ids,
        ))
        for j_str in child_ids:
            j = int(j_str[1:])
            store.add(Node(
                node_id=j_str,
                # the leading c{j} makes every text distinct: host pair
                # tokenization can never memoize across candidates
                text=" ".join(f"c{j}" if i == 0 else WORDS[(i + j) % len(WORDS)]
                              for i in range(CHUNK_WORDS[j % len(CHUNK_WORDS)])),
                level=1, doc_id=f"d{p // 256}", module=MODULE, parent_id=pid,
            ))
            row_ids.append(j_str)
    store.finalize_leaves()

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n_chunks, dim), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    # the serving embedder's GELU, so the engine load's flavour check stays quiet
    gelu = "tanh" if use_approx_gelu(_EMBEDDER_ARCHS.get(model_id, BGE_M3_CONFIG)) else "exact"
    VectorIndex(emb, row_ids, store, metadata={
        "embedding_model": model_id, "created_at": "synthetic", "index_version": "1.0",
        "chunk_sizes": [2048, 512, 256], "chunk_overlap": 64, "chunking_strategy": "hierarchical", "gelu": gelu,
    }).save(idx_dir)
    print(f"[prepare] done in {time.time() - t0:.0f}s", file=sys.stderr)
    return idx_dir


def write_config(data_dir: Path, ollama_url: str, tiny: bool = TINY) -> None:
    """config.yaml in ``data_dir``: history off (no condenser hop, each
    message retrieves on its own), the Ollama provider at ``ollama_url``."""
    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig, save_config

    cfg = TensorTruthTPUConfig.default()
    if tiny:
        cfg.rag.default_embedding_model = "tiny-embedder"
        cfg.rag.default_reranker = "tiny-reranker"
        cfg.rag.use_fused_topk = False
    cfg.conversation.max_history_turns = 0
    for p in cfg.providers:
        if p.type == "ollama":
            p.base_url = ollama_url
    cfg.llm.default_model = FAKE_MODEL
    with scoped_env(TENSOR_TRUTH_TPU_DATA_DIR=str(data_dir)):
        save_config(cfg)


@contextmanager
def scoped_env(**values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------- servers


def fake_ollama_app():
    """A local stand-in for Ollama (the wire format of the port's
    ``core/providers.py`` ``OllamaLLM``). ``fake-llm`` streams a short
    answer. ``fake-tools`` reports tool calling; asked with tools and no
    tool result yet, it calls ``rag_query`` with the user's message."""
    from aiohttp import web

    async def tags(_):
        return web.json_response({"models": [{"name": FAKE_MODEL}, {"name": TOOLS_MODEL}]})

    async def show(request):
        model = (await request.json()).get("model")
        return web.json_response({"capabilities": ["tools"] if model == TOOLS_MODEL else []})

    async def chat(request):
        body = await request.json()
        messages = body.get("messages", [])
        message = {"role": "assistant", "content": FAKE_ANSWER}
        if body.get("tools") and not any(m.get("role") == "tool" for m in messages):
            user = next(m["content"] for m in reversed(messages) if m.get("role") == "user")
            message = {"role": "assistant", "content": "",
                       "tool_calls": [{"function": {"name": "rag_query", "arguments": {"query": user}}}]}
        if body.get("stream") is False:
            return web.json_response({"model": body.get("model"), "message": message, "done": True})
        resp = web.StreamResponse()
        resp.content_type = "application/x-ndjson"
        await resp.prepare(request)
        await resp.write((json.dumps({"message": message}) + "\n").encode())
        await resp.write((json.dumps({"message": {}, "done": True}) + "\n").encode())
        return resp

    app = web.Application()
    app.router.add_get("/api/tags", tags)
    app.router.add_post("/api/show", show)
    app.router.add_post("/api/chat", chat)
    return app


class ThreadedApp:
    """An aiohttp app served on 127.0.0.1 by a thread with its own event
    loop; ``port`` 0 takes a free one."""

    def __init__(self, app, port: int = 0):
        self.app, self.loop = app, asyncio.new_event_loop()
        self.port, self._runner, self._error = port, None, None
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)

    def _serve(self) -> None:
        from aiohttp import web

        asyncio.set_event_loop(self.loop)
        try:
            self._runner = web.AppRunner(self.app)
            self.loop.run_until_complete(self._runner.setup())
            site = web.TCPSite(self._runner, "127.0.0.1", self.port)
            self.loop.run_until_complete(site.start())
            self.port = self._runner.addresses[0][1]
        except BaseException as e:  # raised in start()
            self._error = e
            self._ready.set()
            return
        self._ready.set()
        self.loop.run_forever()
        self.loop.run_until_complete(self._runner.cleanup())
        self.loop.close()

    def start(self) -> "ThreadedApp":
        self._thread.start()
        self._ready.wait()
        if self._error is not None:
            raise RuntimeError(f"app did not start: {self._error!r}") from self._error
        return self

    def stop(self) -> None:
        if self._thread.is_alive():
            self.loop.call_soon_threadsafe(self.loop.stop)
            self._thread.join(timeout=60)


def serve_child(which: str, port_file: Path, port: int, device: str) -> None:
    """A subprocess's body: serve the fake Ollama or the port's app on
    ``port`` (0: a free one), write the bound port to ``port_file``, serve
    until SIGTERM, then run the app's cleanup."""
    if which == "fake-ollama":
        app = fake_ollama_app()
    else:
        import logging

        from tensortruth_tpu_torch.server.app import create_app

        logging.basicConfig(level=logging.INFO)
        app = create_app(device=device)
    served = ThreadedApp(app, port).start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    tmp = port_file.with_suffix(".tmp")
    tmp.write_text(str(served.port))
    tmp.rename(port_file)  # the reader never sees a partial number
    while not stop.wait(1.0):
        pass
    served.stop()


def start_child(which: str, data_dir: Path, port: int, device: str, env: dict | None = None,
                timeout: float = 600.0) -> tuple[subprocess.Popen, int]:
    """Start ``serve_child`` in a subprocess, its output in
    ``data_dir/<which>.log``; wait for the port it bound. Raises if it exits
    first."""
    port_file = data_dir / f"{which}.port"
    port_file.unlink(missing_ok=True)
    with open(data_dir / f"{which}.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tensortruth_tpu_torch.scripts.measure_serving_e2e", "--serve", which,
             str(port_file), str(port), device], cwd=REPO, env=dict(os.environ, **(env or {})),
            stdout=log, stderr=subprocess.STDOUT)
    t0 = time.time()
    while not port_file.exists():
        check_alive([proc])
        if time.time() - t0 > timeout:
            stop_children([proc])
            raise TimeoutError(f"{which} bound no port in {timeout:.0f} s; see {data_dir / (which + '.log')}")
        time.sleep(0.2)
    return proc, int(port_file.read_text())


def check_alive(procs) -> None:
    """Raise if one of the subprocesses has exited."""
    for p in procs:
        if p.poll() is not None:
            raise RuntimeError(f"{p.args[4]} exited with code {p.returncode}; see {Path(p.args[5]).with_suffix('.log')}")


def stop_children(procs) -> None:
    for p in procs:
        p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


@dataclass
class Served:
    """The running server: ``base`` is its URL, ``services`` its
    ``ServiceContainer`` when it runs in process."""

    base: str
    services: object = None
    procs: tuple = ()


@contextmanager
def launch(data_dir: Path, indexes_dir: Path, device: str, in_process: bool, tiny: bool = TINY):
    """Start the fake Ollama, write the config, start the server; yield a
    ``Served``; stop both (and reset the port's provider singletons, which
    the server seeded from this config)."""
    from tensortruth_tpu_torch.core.providers import ProviderRegistry, clear_llm_cache

    data_dir, indexes_dir = Path(data_dir).resolve(), Path(indexes_dir).resolve()
    env = {"TENSOR_TRUTH_TPU_DATA_DIR": str(data_dir), "TENSOR_TRUTH_TPU_INDEXES_DIR": str(indexes_dir)}
    if not in_process:
        procs = []
        try:
            proc, ollama_port = start_child("fake-ollama", data_dir, OLLAMA_PORT, "cpu")
            procs.append(proc)
            write_config(data_dir, f"http://127.0.0.1:{ollama_port}", tiny)
            proc, port = start_child("server", data_dir, PORT, device, env)
            procs.insert(0, proc)
            yield Served(f"http://127.0.0.1:{port}", procs=tuple(procs))
        finally:
            stop_children(procs)
        return

    from tensortruth_tpu_torch.server.app import create_app

    ollama = ThreadedApp(fake_ollama_app(), OLLAMA_PORT).start()
    server = None
    ProviderRegistry.reset_instance()
    clear_llm_cache()
    try:
        write_config(data_dir, f"http://127.0.0.1:{ollama.port}", tiny)
        with scoped_env(**env):
            app = create_app(device=device)
            server = ThreadedApp(app, PORT).start()
            yield Served(f"http://127.0.0.1:{server.port}", app["services"])
    finally:
        if server is not None:
            server.stop()
        ollama.stop()
        ProviderRegistry.reset_instance()
        clear_llm_cache()


async def wait_health(base: str, timeout: float = 120.0, procs=()) -> None:
    """Poll ``base``/health until it answers 200; raise if one of ``procs``
    (the server's subprocesses) exits meanwhile."""
    import aiohttp

    t0 = time.time()
    async with aiohttp.ClientSession() as s:
        while True:
            check_alive(procs)
            try:
                async with s.get(f"{base}/health") as r:
                    if r.status == 200:
                        return
            except aiohttp.ClientError:
                pass
            if time.time() - t0 > timeout:
                raise TimeoutError("server never became healthy")
            await asyncio.sleep(1.0)


# ---------------------------------------------------------------- drive


def query_text(n: int) -> str:
    return f"how does component {n} interact with the sharded engine"


async def ask(ws, message: str, timeout: float = 1800) -> list[dict]:
    """Send one message; its frames up to its ``done`` or ``error``."""
    import aiohttp

    await ws.send_json({"message": message})
    frames = []
    while True:
        raw = await asyncio.wait_for(ws.receive(), timeout=timeout)
        if raw.type != aiohttp.WSMsgType.TEXT:
            raise RuntimeError(f"ws closed: {raw.type!r} data={raw.data!r}")
        frames.append(json.loads(raw.data))
        if frames[-1]["type"] in ("done", "error"):
            return frames


def answer_of(frames: list[dict]) -> list[tuple[str, float]]:
    """(node id, score) of each source, in order; [] without a sources frame."""
    sources = next((f["sources"] for f in frames if f["type"] == "sources"), [])
    return [(s["id"], s["score"]) for s in sources]


def compare_answers(batched: list, sequential: list, tol: float = SCORE_TOL) -> dict:
    """One query's sources, concurrent against sequential: the same node ids
    in the same order, except two neighbours whose scores lie within ``tol``
    (swapped); every score within ``tol``. Returns the largest score
    difference, the swaps, and whether they agree."""
    ok = len(batched) == len(sequential)
    err, swaps, i = 0.0, 0, 0
    while ok and i < len(batched):
        (a_id, a_s), (b_id, b_s) = batched[i], sequential[i]
        if a_id == b_id:
            err = max(err, abs(a_s - b_s))
            i += 1
            continue
        if (i + 1 < len(batched) and batched[i + 1][0] == b_id and sequential[i + 1][0] == a_id
                and abs(a_s - batched[i + 1][1]) <= tol):
            err = max(err, abs(a_s - sequential[i + 1][1]), abs(b_s - batched[i + 1][1]))
            swaps += 1
            i += 2
            continue
        ok = False
    return {"agree": ok and err <= tol, "max_score_diff": err, "swaps": swaps}


async def drive(base: str, modules: list[str], concurrency: int, measure_s: float, warmup: int,
                tiny: bool = TINY) -> dict:
    import aiohttp

    results: list[float] = []  # per-message latencies in the measure window
    answers: dict[int, list] = {}  # query number -> sources, in the window
    errors: list[str] = []
    state = {"measuring": False, "sent": 0, "sourceless": 0}
    qn = iter(range(10_000_000))

    async def worker(sess: aiohttp.ClientSession, stop_at: list) -> None:
        r = await sess.post(f"{base}/api/sessions", json={"modules": modules})
        sid = (await r.json())["id"]
        async with sess.ws_connect(f"{base.replace('http', 'ws', 1)}/ws/chat/{sid}") as ws:
            while True:
                if stop_at[0] and time.time() >= stop_at[0]:
                    return
                n = next(qn)
                t0 = time.time()
                frames = await ask(ws, query_text(n))
                if frames[-1]["type"] == "error":
                    errors.append(str(frames[-1])[:200])
                    return
                state["sent"] += 1
                state["sourceless"] += not answer_of(frames)
                if state["measuring"]:
                    results.append(time.time() - t0)
                    answers[n] = answer_of(frames)

    async def status(sess) -> dict:
        async with sess.get(f"{base}/api/system/rag/status") as r:
            return await r.json()

    async with aiohttp.ClientSession() as sess:
        stop_at = [None]
        tasks = [asyncio.create_task(worker(sess, stop_at)) for _ in range(concurrency)]
        # warm-up: the first messages pay the engine load and first launches
        warm_deadline = time.time() + (600 if tiny else 3600)
        t_start = None
        while True:
            await asyncio.sleep(0.5 if tiny else 2.0)
            served = ((await status(sess)).get("batcher") or {}).get("requests_served", 0)
            if served >= concurrency * warmup:
                state["measuring"] = True
                t_start = time.time()
                stop_at[0] = t_start + measure_s
                break
            if time.time() > warm_deadline:
                raise TimeoutError("warmup never completed")
            if any(t.done() for t in tasks) or errors:
                break
        for t in tasks:
            try:
                await t
            except Exception:  # a worker's crash, with its traceback
                import traceback

                errors.append(traceback.format_exc(limit=5)[-500:])
        if t_start is None:
            raise RuntimeError(f"no measurement window: {len(errors)} worker errors, "
                               f"first: {errors[0] if errors else 'none'}")
        elapsed = time.time() - t_start
        st = await status(sess)
        if errors:
            raise RuntimeError(f"{len(errors)} worker errors, first: {errors[0]}")

        # the first queries of the window again, one at a time in one session
        checked = sorted(answers)[:CHECK_QUERIES]
        r = await sess.post(f"{base}/api/sessions", json={"modules": modules})
        sid = (await r.json())["id"]
        comparisons = []
        async with sess.ws_connect(f"{base.replace('http', 'ws', 1)}/ws/chat/{sid}") as ws:
            for n in checked:
                frames = await ask(ws, query_text(n))
                if frames[-1]["type"] == "error":
                    raise RuntimeError(f"sequential query {n}: {frames[-1]}")
                state["sent"] += 1
                state["sourceless"] += not answer_of(frames)
                comparisons.append({"query": n, **compare_answers(answers[n], answer_of(frames))})

    lat = sorted(results)
    return {
        "qps": len(results) / elapsed,
        "messages": len(results),
        "elapsed_s": elapsed,
        "p50_ms": lat[len(lat) // 2] * 1e3 if lat else None,
        "p95_ms": lat[int(len(lat) * 0.95)] * 1e3 if lat else None,
        "batcher": st.get("batcher"),
        "n_chunks": (st.get("engine") or {}).get("n_chunks"),
        # every message answered (warm-up and the sequential ones included)
        # and how many of them came without sources
        "answered": state["sent"],
        "sourceless": state["sourceless"],
        "batched_vs_sequential": {
            "queries": len(comparisons),
            "disagree": [c["query"] for c in comparisons if not c["agree"]],
            "max_score_diff": max((c["max_score_diff"] for c in comparisons), default=None),
            "swaps": sum(c["swaps"] for c in comparisons),
            "score_tol": SCORE_TOL,
        },
    }


def run(n_chunks: int = N_CHUNKS, dim: int = DIM, concurrency: int = CONCURRENCY, measure_s: float = MEASURE_S,
        warmup: int = WARMUP_MSGS_PER_WORKER, data_dir: Path | None = None, indexes_dir: Path | None = None,
        modules: list[str] | None = None, in_process: bool = False, tiny: bool = TINY) -> dict:
    """Serve and drive; returns the numbers (see the module docstring).
    With ``indexes_dir`` and ``modules`` the server serves those, else the
    synthetic index of ``n_chunks`` x ``dim`` under ``data_dir``. The
    server runs on ``cuda``, or on the CPU when ``tiny``."""
    data_dir = Path(data_dir or DATA_DIR)
    data_dir.mkdir(parents=True, exist_ok=True)
    device = "cpu" if tiny else "cuda"
    if modules is None:
        indexes_dir = data_dir / "indexes"
        prepare_index(indexes_dir, n_chunks, dim, tiny)
        modules = [MODULE]
    with launch(data_dir, Path(indexes_dir), device, in_process, tiny) as served:
        asyncio.run(wait_health(served.base, timeout=600, procs=served.procs))
        out = asyncio.run(drive(served.base, modules, concurrency, measure_s, warmup, tiny))
    return {**out, "concurrency": concurrency, "modules": modules, "tiny": tiny, "in_process": in_process,
            "device": device, "card": card_line()}


def main() -> None:
    if sys.argv[1:2] == ["--serve"]:
        which, port_file, port, device = sys.argv[2:6]
        serve_child(which, Path(port_file), int(port), device)
        return
    out = run()
    print(json.dumps({"metric": "serving_qps_through_server", "value": out.pop("qps"), "unit": "qps",
                      "detail": {**out, "n_chunks_built": N_CHUNKS}}))


if __name__ == "__main__":
    main()
