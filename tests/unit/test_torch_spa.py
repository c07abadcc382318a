"""The port's SPA against the port's app, held to the reference's SPA
against the reference's app (tests/integration/test_spa_fullstack.py), both
run on one JS runtime: the reference's ``tensortruth_tpu/jsrt/``, a module
only tests use, so the apps and their static trees are the only difference
between the two sides.

Each side: the app on the CPU (the port's through ``create_app(device="cpu")``)
with the same tiny float32 embedder and reranker weights seated in each
package's model manager (test_torch_e2e.py's ``runtimes``: the reference's
parameters carried into the port), each package's provider registry and LLM
cache built anew (a registry left by an earlier test in the process would
change what the SPA paints), a session and a project made through its API,
then the SPA's ``app.js`` booted with ``fetch`` bridged into the live app,
and one chat: a document upload, a WebSocket message answered by a stub
streaming LLM, and every frame replayed through the SPA's ``ws.js``
handlers. The request log and the painted text (sidebar, projects, status
bar, messages) must be equal, once the ids the two apps drew (sessions,
projects, messages) and the measured times are replaced by placeholders.
"""

import importlib
import json
import re
from pathlib import Path

import torch
from aiohttp.test_utils import TestClient, TestServer
from test_torch_e2e import runtimes  # noqa: F401 (fixture)

from tensortruth_tpu import jsrt
from tensortruth_tpu.jsrt.builtins import JSPromise, get_member
from tensortruth_tpu.jsrt.interp import JSObject

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
SHIM = ROOT / "tests" / "fixtures" / "jsrt_dom_shim.js"
PACKAGES = ["tensortruth_tpu", "tensortruth_tpu_torch"]
RICH = "Use $$E = mc^2$$ for energy.\n\n```python\nprint('hi')\n```\n"
UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}|[0-9a-f]{32}|[0-9a-f]{12}")
TIMES = re.compile(r"\d+(\.\d+)?\s*(ms|s|tok/s)\b")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _text(el) -> str:
    out = []

    def walk(e):
        for key in ("_text", "_html"):
            if isinstance(e.props.get(key), str):
                out.append(e.props[key])
        for c in e.props.get("children", []):
            walk(c)

    walk(el)
    return " ".join(out)


def _normalise(text: str) -> str:
    return TIMES.sub("<time>", UUID.sub("<id>", text))


class _FakeLLM:
    def __init__(self, delta):
        self.delta = delta

    def complete(self, prompt):
        return "Energy title"

    def stream_chat(self, messages, system=None):
        yield self.delta(thinking="recalling physics")
        for piece in RICH.split(" "):
            yield self.delta(text=piece + " ")


def _drive(pkg: str, models, tmp_path, monkeypatch, event_loop) -> dict:
    """Boot ``pkg``'s SPA against ``pkg``'s app (``models``: its embedder
    and reranker), then one chat; returns the request log and the painted
    text."""
    monkeypatch.setenv("TENSOR_TRUTH_TPU_DATA_DIR", str(tmp_path))
    _fresh_singletons(pkg)
    manager = _mod(pkg, "models.manager").ModelManager
    emb, rr = models
    monkeypatch.setattr(manager.get_instance(), "get_embedder", lambda spec=None, **_: emb)
    monkeypatch.setattr(manager.get_instance(), "get_reranker", lambda spec=None, **_: rr)
    cfg = _mod(pkg, "app.config").TensorTruthTPUConfig.default()
    cfg.rag.default_embedding_model, cfg.rag.default_reranker = "tiny-embedder", "tiny-reranker"
    cfg.rag.use_fused_topk = False
    cfg.rag.corpus_dtype = "float32"
    kw = {"device": "cpu"} if pkg == "tensortruth_tpu_torch" else {}
    app = _mod(pkg, "server.app").create_app(data_dir=tmp_path, config=cfg, **kw)
    app["services"].rag_service._llm_factory = lambda params: _FakeLLM(_mod(pkg, "core.providers").ChatDelta)
    client = TestClient(TestServer(app, loop=event_loop), loop=event_loop)
    event_loop.run_until_complete(client.start_server())
    js = ROOT / pkg / "static" / "assets" / "js"
    try:
        async def seed():
            sid = (await (await client.post("/api/sessions", json={})).json())["id"]
            await client.patch(f"/api/sessions/{sid}", json={"title": "Fullstack boot session"})
            await client.post("/api/projects", json={"name": "FS Project"})
            return sid

        sid = event_loop.run_until_complete(seed())
        rt = jsrt.Runtime(root=js)
        env_obj = rt.interp.call_any(rt.load_module(SHIM)["install"], [])
        for k, v in env_obj.props.items():
            if k not in ("__shim__", "fetch"):
                rt.globals.declare(k, v)
        shim = env_obj.props["__shim__"].props
        log = []

        def js_fetch(path, opts=jsrt.UNDEF):
            method, body = "GET", None
            if opts is not None and opts is not jsrt.UNDEF:
                o = jsrt.from_js(opts) or {}
                method, body = o.get("method", "GET"), o.get("body")
            log.append((method, path))

            async def do():
                resp = await client.request(method, path, data=body, headers={"Content-Type": "application/json"})
                return resp.status, await resp.text()

            status, text = event_loop.run_until_complete(do())

            def settled(value, state="fulfilled"):
                p = JSPromise(rt)
                p._settle(state, value)
                return p

            def jsn():
                try:
                    return settled(jsrt.to_js(json.loads(text or "null")))
                except Exception as e:  # a body that is not JSON
                    return settled(jsrt.to_js(str(e)), "rejected")

            return settled(JSObject({"ok": status < 400, "status": status, "json": jsn,
                                     "text": lambda: settled(text)}))

        rt.globals.declare("fetch", js_fetch)
        rt.load_module(js / "app.js")
        rt.drain_jobs()
        painted = {name: _text(rt.interp.call_any(shim["getById"], [name]))
                   for name in ("sessions", "projects", "status-bar")}
        boot_log = list(log)

        async def converse():
            await client.post(f"/api/sessions/{sid}/documents",
                              json={"filename": "phys.md", "text": "Mass energy equivalence. " * 120})
            ws = await client.ws_connect(f"/ws/chat/{sid}")
            await ws.send_json({"message": "explain E=mc2"})
            frames = []
            while not frames or frames[-1]["type"] not in ("done", "error"):
                frames.append(await ws.receive_json(timeout=60))
            await ws.close()
            return frames

        frames = event_loop.run_until_complete(converse())
        sock = rt.interp.call_any(shim["lastSocket"], [])
        receive = get_member(sock, "receive", rt.interp)
        for f in frames:
            rt.interp.call_any(receive, [jsrt.to_js(f)])
            rt.drain_jobs()
        painted["messages"] = _text(rt.interp.call_any(shim["getById"], ["messages"]))
        return {"boot_log": boot_log, "log": log, "frame_types": [f["type"] for f in frames],
                "painted": {k: _normalise(v) for k, v in painted.items()}, "sid": sid}
    finally:
        event_loop.run_until_complete(client.close())
        _fresh_singletons(pkg)


def _fresh_singletons(pkg: str) -> None:
    _mod(pkg, "models.manager").ModelManager.reset_instance()
    providers = _mod(pkg, "core.providers")
    providers.ProviderRegistry.reset_instance()
    providers.clear_llm_cache()


def test_spa_boot_and_chat_paint_the_same_on_both_packages(tmp_path, monkeypatch, event_loop, runtimes):  # noqa: F811
    runs = {pkg: _drive(pkg, runtimes["ref" if pkg == PACKAGES[0] else "port"], tmp_path / pkg, monkeypatch,
                        event_loop) for pkg in PACKAGES}
    ref, port = (runs[pkg] for pkg in PACKAGES)
    paths = [p for _, p in port["boot_log"]]
    for expected in ("/api/startup/status", "/api/system/devices", "/api/sessions", "/api/projects",
                     "/api/modules", f"/api/sessions/{port['sid']}"):
        assert any(p.startswith(expected) for p in paths), expected
    assert [(m, UUID.sub("<id>", p)) for m, p in port["log"]] == [(m, UUID.sub("<id>", p)) for m, p in ref["log"]]
    assert port["frame_types"] == ref["frame_types"] and port["frame_types"][-1] == "done"
    assert port["painted"] == ref["painted"]
    assert "Fullstack boot session" in port["painted"]["sessions"] and "FS Project" in port["painted"]["projects"]
    html = port["painted"]["messages"]
    assert "<pre>" in html and "print" in html and "recalling physics" in html and "tex" in html

