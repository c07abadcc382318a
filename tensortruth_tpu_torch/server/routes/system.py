"""System introspection routes (reference api/routes/system.py:69-385).

The reference reports CUDA/MPS/Ollama memory; here the equivalents are the
server's device (``torch.cuda`` memory of the card it loads on, or one CPU
entry), resident model accounting from the ModelManager, and provider
reachability.
"""

from __future__ import annotations

import asyncio

from aiohttp import web

from tensortruth_tpu_torch.server.schemas import read_json


def device_entries(device) -> list[dict]:
    """The server's device as the routes report it: id, platform, kind,
    bytes allocated and the card's total memory; on the CPU one entry
    without byte counts, as the CPU reports none."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return [{"id": 0, "platform": "cpu", "kind": "cpu", "bytes_in_use": None, "bytes_limit": None}]
    index = torch.cuda.current_device() if device.index is None else device.index
    return [
        {
            "id": index,
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(index),
            "bytes_in_use": torch.cuda.memory_allocated(index),
            "bytes_limit": torch.cuda.mem_get_info(index)[1],
        }
    ]


async def memory(request: web.Request):
    devices = device_entries(request.app["services"].device)
    import psutil

    vm = psutil.virtual_memory()
    return web.json_response(
        {
            "devices": devices,
            "ram": {"total": vm.total, "available": vm.available, "percent": vm.percent},
        }
    )


async def devices(request: web.Request):
    entries = device_entries(request.app["services"].device)
    return web.json_response(
        {
            "devices": [{k: d[k] for k in ("id", "platform", "kind")} for d in entries],
            "backend": entries[0]["platform"],
        }
    )


async def ollama_status(request: web.Request):
    services = request.app["services"]
    import requests

    base = services.config.ollama.base_url

    def probe():
        try:
            r = requests.get(f"{base}/api/tags", timeout=5)
            r.raise_for_status()
            models = [m["name"] for m in r.json().get("models", [])]
        except Exception as e:
            return {"reachable": False, "error": str(e)}
        # Loaded (resident) models via /api/ps — the reference UI's
        # ModelStatusDot contract (frontend ModelSelectContent.tsx); a ps
        # failure must not mask a reachable server.
        running: list[str] = []
        try:
            r = requests.get(f"{base}/api/ps", timeout=5)
            r.raise_for_status()
            running = [m["name"] for m in r.json().get("models", [])]
        except Exception:
            pass
        return {"reachable": True, "models": models, "running": running}

    return web.json_response(await asyncio.to_thread(probe))


async def ollama_load(request: web.Request):
    services = request.app["services"]
    body = await read_json(request)
    body = body if isinstance(body, dict) else {}
    import requests

    def load():
        r = requests.post(
            f"{services.config.ollama.base_url}/api/generate",
            json={"model": body.get("model", ""), "prompt": "", "keep_alive": "10m"},
            timeout=120,
        )
        r.raise_for_status()
        return {"status": "loaded"}

    try:
        return web.json_response(await asyncio.to_thread(load))
    except Exception as e:
        return web.json_response({"status": "error", "error": str(e)}, status=502)


async def ollama_unload(request: web.Request):
    services = request.app["services"]
    body = await read_json(request)
    body = body if isinstance(body, dict) else {}
    import requests

    def unload():
        requests.post(
            f"{services.config.ollama.base_url}/api/generate",
            json={"model": body.get("model", ""), "prompt": "", "keep_alive": 0},
            timeout=30,
        )
        return {"status": "unloaded"}

    try:
        return web.json_response(await asyncio.to_thread(unload))
    except Exception as e:
        return web.json_response({"status": "error", "error": str(e)}, status=502)


def _llama_cpp_provider(request: web.Request, provider_id: str | None = None):
    """First configured llama_cpp provider (reference system.py:159-235)."""
    from tensortruth_tpu_torch.core.providers import ProviderRegistry

    registry = ProviderRegistry.get_instance(
        request.app["services"].config.providers
    )
    if provider_id:
        p = registry.get_provider(provider_id)
        return p if p is not None and p.type == "llama_cpp" else None
    return next(
        (p for p in registry.providers.values() if p.type == "llama_cpp"), None
    )


async def llama_cpp_status(request: web.Request):
    from tensortruth_tpu_torch.core import llama_cpp

    provider = _llama_cpp_provider(request)
    if provider is None:
        return web.json_response({"running": False, "models": [], "base_url": ""})
    base = provider.base_url.rstrip("/")

    def probe():
        models = llama_cpp.get_available_models(base)
        return {
            "running": bool(models),
            "base_url": base,
            "models": [
                {**m, "display_name": llama_cpp.format_display_name(m["id"])}
                for m in models
            ],
        }

    return web.json_response(await asyncio.to_thread(probe))


async def llama_cpp_load(request: web.Request):
    from tensortruth_tpu_torch.core import llama_cpp

    body = await read_json(request)
    body = body if isinstance(body, dict) else {}
    provider = _llama_cpp_provider(request, body.get("provider_id"))
    if provider is None:
        return web.json_response(
            {"success": False, "message": "No llama_cpp provider found"}, status=404
        )
    model = body.get("model", "")
    if not model:
        return web.json_response(
            {"success": False, "message": "missing 'model'"}, status=422
        )
    ok = await asyncio.to_thread(
        llama_cpp.load_model, provider.base_url.rstrip("/"), model
    )
    return web.json_response(
        {"success": ok, "message": f"load {'ok' if ok else 'failed'}: {model}"},
        status=200 if ok else 502,
    )


async def llama_cpp_unload(request: web.Request):
    from tensortruth_tpu_torch.core import llama_cpp

    body = await read_json(request)
    body = body if isinstance(body, dict) else {}
    provider = _llama_cpp_provider(request, body.get("provider_id"))
    if provider is None:
        return web.json_response(
            {"success": False, "message": "No llama_cpp provider found"}, status=404
        )
    model = body.get("model", "")
    if not model:
        return web.json_response(
            {"success": False, "message": "missing 'model'"}, status=422
        )
    ok = await asyncio.to_thread(
        llama_cpp.unload_model, provider.base_url.rstrip("/"), model
    )
    return web.json_response(
        {"success": ok, "message": f"unload {'ok' if ok else 'failed'}: {model}"},
        status=200 if ok else 502,
    )


async def rag_status(request: web.Request):
    """Loaded embedder/reranker + memory (reference system.py:325-360), and
    the set-up account."""
    from tensortruth_tpu_torch.models.manager import ModelManager
    from tensortruth_tpu_torch.utils import profiling

    services = request.app["services"]
    status = ModelManager.get_instance().status()
    status["last_query_timings"] = services.rag_service.last_timings
    batcher = services.rag_service._batcher
    # The set-up account (utils/profiling.py). The copy beside the batcher's
    # counters is temporary: the benchmark's load process hands on only the
    # ``batcher`` entry (ROADMAP E9 removes the copy once it hands on the
    # whole status). With batching off ``batcher`` is None: only ``setup`` has it.
    status["setup"] = profiling.SETUP.snapshot()
    status["batcher"] = (
        {
            "batches_run": batcher.batches_run,
            "requests_served": batcher.requests_served,
            "setup": status["setup"],
        }
        if batcher is not None
        else None
    )
    engine = services.rag_service.engine
    status["engine"] = (
        {
            "modules": engine.modules,
            "n_chunks": engine.retriever.n_chunks,
            "similarity_top_k": engine.similarity_top_k,
            "params": {k: v for k, v in engine.params.items() if not callable(v)},
        }
        if engine
        else None
    )
    return web.json_response(status)


async def profile_start(request: web.Request):
    """Start a torch.profiler trace of the server's device (SURVEY §5.1)."""
    import torch

    from tensortruth_tpu_torch.utils.profiling import start_trace

    body = await read_json(request)
    body = body if isinstance(body, dict) else {}
    services = request.app["services"]
    log_dir = body.get("log_dir") or str(services.data_dir / "profiles")
    try:
        start_trace(log_dir, cuda=torch.device(services.device).type == "cuda")
    except Exception as e:
        return web.json_response({"status": "error", "error": str(e)}, status=409)
    return web.json_response({"status": "tracing", "log_dir": log_dir})


async def profile_stop(request: web.Request):
    """Stop the trace and write it into its log dir as a Chrome trace."""
    from tensortruth_tpu_torch.utils.profiling import stop_trace

    try:
        path = stop_trace()  # in the thread that started it, as the profiler needs
    except Exception as e:
        return web.json_response({"status": "error", "error": str(e)}, status=409)
    return web.json_response({"status": "stopped", "trace": path})


async def restart_engine(request: web.Request):
    services = request.app["services"]
    # a restart must drop the engine CACHE too — a cached engine would be
    # served back verbatim (old models and all) on the next request
    services.rag_service.clear_engines()
    from tensortruth_tpu_torch.models.manager import ModelManager

    ModelManager.get_instance().unload_all()
    return web.json_response({"status": "restarted"})


async def models_unload(request: web.Request):
    """Drop resident embedder/reranker param pytrees (XLA frees HBM when the
    last reference dies — reference model_manager.py:385-397 semantics)."""
    from tensortruth_tpu_torch.models.manager import ModelManager

    ModelManager.get_instance().unload_all()
    return web.json_response({"status": "unloaded"})


def setup(app: web.Application) -> None:
    r = app.router
    r.add_get("/api/system/memory", memory)
    r.add_get("/api/system/devices", devices)
    r.add_get("/api/system/ollama/status", ollama_status)
    r.add_post("/api/system/ollama/load", ollama_load)
    r.add_post("/api/system/ollama/unload", ollama_unload)
    r.add_get("/api/system/llama-cpp/status", llama_cpp_status)
    r.add_post("/api/system/llama-cpp/load", llama_cpp_load)
    r.add_post("/api/system/llama-cpp/unload", llama_cpp_unload)
    r.add_get("/api/system/rag/status", rag_status)
    r.add_post("/api/system/restart-engine", restart_engine)
    r.add_post("/api/system/models/unload", models_unload)
    r.add_post("/api/system/profile/start", profile_start)
    r.add_post("/api/system/profile/stop", profile_stop)
