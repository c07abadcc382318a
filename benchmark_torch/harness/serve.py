"""The served path in the harness's own process, and its clients.

The program's aiohttp app (``server/app.py::create_app``) and a stand-in
for Ollama (instant one-token answers, so the time measured is the port's)
each run on their own event loop in a thread of this process; the client
runs on the main thread's loop. A message is a WebSocket chat turn on
``/ws/chat/{session}``: route -> session service -> ``RAGService`` ->
``QueryBatcher`` -> query step -> rerank -> ``sources`` and ``done``
frames. The fake Ollama and the threaded app are copies of the port's
serving driver's (``scripts/measure_serving_e2e.py``); the loops are the
benchmark's own.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from dataclasses import dataclass, field

FAKE_MODEL = "fake-llm"
FAKE_ANSWER = "Answer."


def fake_ollama_app():
    from aiohttp import web

    async def tags(_):
        return web.json_response({"models": [{"name": FAKE_MODEL}]})

    async def show(_):
        return web.json_response({"capabilities": []})

    async def chat(request):
        body = await request.json()
        message = {"role": "assistant", "content": FAKE_ANSWER}
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
    """An aiohttp app served on 127.0.0.1 (a free port) by a thread with
    its own event loop."""

    def __init__(self, app):
        self.app, self.loop = app, asyncio.new_event_loop()
        self.port, self._runner, self._error = 0, None, None
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)

    def _serve(self) -> None:
        from aiohttp import web

        asyncio.set_event_loop(self.loop)
        try:
            self._runner = web.AppRunner(self.app)
            self.loop.run_until_complete(self._runner.setup())
            site = web.TCPSite(self._runner, "127.0.0.1", 0)
            self.loop.run_until_complete(site.start())
            self.port = self._runner.addresses[0][1]
        except BaseException as e:  # re-raised by start()
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
            self._thread.join(timeout=120)


def write_config(config: dict, ollama_url: str, tiny: bool) -> None:
    """The app's config.yaml in its data directory: the configuration's
    serving settings, history off, the Ollama provider at ``ollama_url``."""
    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig, save_config

    s = config["serving"]
    cfg = TensorTruthTPUConfig.default()
    cfg.rag.default_embedding_model = config["embedder"]["model_id"]
    cfg.rag.default_reranker = config["reranker"]["model_id"]
    cfg.rag.default_top_n = s["reranker_top_n"]
    cfg.rag.default_confidence_threshold = s["confidence_cutoff"]
    cfg.rag.default_confidence_cutoff_hard = s["confidence_cutoff_hard"]
    cfg.rag.query_batching = True
    cfg.rag.query_batching_max_batch = s["query_batching_max_batch"]
    cfg.rag.query_batching_max_wait_ms = s["query_batching_max_wait_ms"]
    cfg.rag.corpus_dtype = config["dtype"]
    if tiny:
        cfg.rag.use_fused_topk = False
    cfg.conversation.max_history_turns = s["max_history_turns"]
    for p in cfg.providers:
        if p.type == "ollama":
            p.base_url = ollama_url
    cfg.llm.default_model = FAKE_MODEL
    save_config(cfg)


@dataclass
class Message:
    text: str
    due: float = 0.0  # host clock the message was due (open loop) or sent
    sources_at: float | None = None
    sources: list = field(default_factory=list)
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.error is None and self.sources_at is not None and bool(self.sources)


class Client:
    """WebSocket chat sessions on one module, each retired after
    ``per_session`` messages."""

    def __init__(self, base: str, modules: list[str], per_session: int):
        self.base, self.modules, self.per_session = base, modules, per_session
        self.idle: list = []
        self._closing: list = []
        self.http = None

    async def __aenter__(self):
        import aiohttp

        # no cap on connections: every open session holds one
        self.http = aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=0),
                                          timeout=aiohttp.ClientTimeout(total=None))
        return self

    async def __aexit__(self, *exc):
        for ws, _ in self.idle:
            await ws.close()
        self.idle.clear()
        if self._closing:
            await asyncio.gather(*self._closing, return_exceptions=True)
        await self.http.close()

    async def open(self):
        async with self.http.post(f"{self.base}/api/sessions", json={"modules": self.modules}) as r:
            sid = (await r.json())["id"]
        ws = await self.http.ws_connect(f"{self.base.replace('http', 'ws', 1)}/ws/chat/{sid}", max_msg_size=0)
        return [ws, 0]

    async def fill(self, n: int) -> None:
        self.idle.extend(await asyncio.gather(*(self.open() for _ in range(n))))

    async def status(self) -> dict:
        async with self.http.get(f"{self.base}/api/system/rag/status") as r:
            return await r.json()

    async def ask(self, msg: Message, timeout: float) -> None:
        """Send ``msg`` on an idle session (a new one when none is idle) and
        read its frames up to ``done`` or ``error``."""
        import aiohttp

        sess = self.idle.pop() if self.idle else await self.open()
        ws = sess[0]
        try:
            await ws.send_json({"message": msg.text})
            while True:
                raw = await asyncio.wait_for(ws.receive(), timeout=timeout)
                if raw.type != aiohttp.WSMsgType.TEXT:
                    raise RuntimeError(f"socket closed: {raw.type!r}")
                frame = json.loads(raw.data)
                if frame["type"] == "sources":
                    msg.sources_at = time.perf_counter()
                    msg.sources = [(s["id"], float(s["score"])) for s in frame["sources"]]
                elif frame["type"] == "error":
                    msg.error = str(frame.get("error"))[:300]
                    break
                elif frame["type"] == "done":
                    break
        except Exception as e:  # the message failed; its session is dropped
            msg.error = msg.error or f"{type(e).__name__}: {e}"[:300]
            self._closing.append(asyncio.ensure_future(ws.close()))
            return
        sess[1] += 1
        if sess[1] >= self.per_session:
            self._closing.append(asyncio.ensure_future(ws.close()))
        else:
            self.idle.append(sess)


async def burst(client: Client, texts: list[str], timeout: float = 600.0) -> list[Message]:
    msgs = [Message(t) for t in texts]
    await asyncio.gather(*(client.ask(m, timeout) for m in msgs))
    return msgs


async def open_loop(client: Client, texts: list[str], offsets: list[float], t0: float,
                    drain_s: float) -> tuple[list[Message], list[float]]:
    """Send message i at ``t0 + offsets[i]`` whatever is outstanding; wait
    for every answer up to ``drain_s`` past the last due time. Returns the
    messages and how late the generator sent each."""
    msgs = [Message(t, due=t0 + o) for t, o in zip(texts, offsets)]
    tasks, late = [], []
    for m in msgs:
        wait = m.due - time.perf_counter()
        if wait > 0:
            await asyncio.sleep(wait)
        late.append(time.perf_counter() - m.due)
        tasks.append(asyncio.ensure_future(client.ask(m, drain_s + 600.0)))
    deadline = msgs[-1].due + drain_s
    done, pending = await asyncio.wait(tasks, timeout=max(0.0, deadline - time.perf_counter()))
    for t in pending:
        t.cancel()
    await asyncio.gather(*pending, return_exceptions=True)
    for m in msgs:
        if m.sources_at is None and m.error is None:
            m.error = "no answer within the drain time"
    return msgs, late


async def closed_loop(client: Client, n_sessions: int, next_text, t_start: float, t_end: float,
                      drain_s: float) -> list[Message]:
    """``n_sessions`` clients, each sending its next message once the last
    one is done, from ``t_start`` (staggered over the first second) until
    ``t_end``; then the outstanding messages are waited for."""
    msgs: list[Message] = []

    async def user(i: int) -> None:
        await asyncio.sleep(max(0.0, t_start + i / n_sessions - time.perf_counter()))
        while time.perf_counter() < t_end:
            m = Message(next_text())
            m.due = time.perf_counter()
            msgs.append(m)
            await client.ask(m, drain_s + 600.0)

    users = [asyncio.ensure_future(user(i)) for i in range(n_sessions)]
    done, pending = await asyncio.wait(users, timeout=max(0.0, t_end + drain_s - time.perf_counter()))
    for t in pending:
        t.cancel()
    await asyncio.gather(*pending, return_exceptions=True)
    for m in msgs:
        if m.sources_at is None and m.error is None:
            m.error = "no answer within the drain time"
    return msgs
