"""Startup/status routes (reference api/routes/startup.py:75-378).

The reference's first-run flow downloads pre-built index tarballs from
HF Hub; offline, ``download-indexes`` submits a build task from local
sources instead and reports the network gap explicitly.
"""

from __future__ import annotations

from aiohttp import web

from tensortruth_tpu_torch.app.paths import (
    get_base_indexes_dir,
    get_config_path,
    get_library_docs_dir,
    get_sources_config_path,
)
from tensortruth_tpu_torch.app.sources import list_all_modules, load_user_sources
from tensortruth_tpu_torch.indexing.metadata import list_available_models, list_modules_for_model


async def status(request: web.Request):
    services = request.app["services"]
    model = services.config.rag.default_embedding_model
    indexes = list_modules_for_model(get_base_indexes_dir(), model)
    return web.json_response(
        {
            "config_exists": get_config_path().exists(),
            "sources_exist": get_sources_config_path().exists(),
            "indexes_present": bool(indexes),
            "index_count": len(indexes),
            "embedding_models": list_available_models(get_base_indexes_dir()),
            "default_embedding_model": model,
            "modules_configured": list_all_modules(load_user_sources()),
        }
    )


async def download_indexes(request: web.Request):
    """Build requested modules as a background task (offline equivalent of
    the reference's HF tarball download, startup.py:159-248)."""
    services = request.app["services"]
    body = await request.json() if request.can_read_body else {}
    modules = body.get("modules") or list_all_modules(load_user_sources())
    if not modules:
        raise web.HTTPUnprocessableEntity(reason="no modules configured in sources.json")

    def job(progress):
        from tensortruth_tpu_torch.build_db import main as build_main

        progress("building", 0, len(modules))
        rc = build_main(["--modules", *modules])
        if rc != 0:
            raise RuntimeError("build failed for some modules")
        return {"built": modules}

    info = services.task_runner.submit("build-indexes", job)
    return web.json_response({"task_id": info.id, "status": info.status})


async def pull_model(request: web.Request):
    """Ollama model pull passthrough (reference startup.py:265-339)."""
    services = request.app["services"]
    body = await request.json()
    model = body.get("model", "")

    def job(progress):
        import requests

        progress("pulling", 0, 1)
        r = requests.post(
            f"{services.config.ollama.base_url}/api/pull",
            json={"model": model},
            timeout=3600,
        )
        r.raise_for_status()
        return {"pulled": model}

    info = services.task_runner.submit(f"pull-{model}", job)
    return web.json_response({"task_id": info.id, "status": info.status})


async def reinitialize_indexes(request: web.Request):
    """Delete all built indexes (reference startup.py:340-378)."""
    import shutil

    base = get_base_indexes_dir()
    removed = []
    for d in base.iterdir():
        if d.is_dir():
            shutil.rmtree(d)
            removed.append(d.name)
    services = request.app["services"]
    # the index dirs are GONE — every cached engine is stale, not just the
    # current pointer
    services.rag_service.clear_engines()
    return web.json_response({"status": "reinitialized", "removed": removed})


async def available_indexes(request: web.Request):
    """Downloadable pre-built index bundles (reference routes/startup.py:159-248
    reads an HF Hub manifest; offline deployments return an empty list)."""
    import os

    manifest_path = os.environ.get("TENSOR_TRUTH_TPU_INDEX_MANIFEST")
    if manifest_path and os.path.exists(manifest_path):
        import json

        with open(manifest_path) as f:
            return web.json_response({"indexes": json.load(f)})
    return web.json_response({"indexes": []})


async def embedding_model_suggestions(request: web.Request):
    """Recommended embedding models for index building (reference
    routes/startup.py:107-152). Users can bring any local HF-format
    checkpoint (models/convert.py self-describes the architecture from
    config.json); these are the vetted starting points."""
    services = request.app["services"]
    suggestions = [
        {
            "model_name": "BAAI/bge-m3",
            "model_id": "bge-m3",
            "description": (
                "Multilingual, 1024-d, 8192-token max — the default; "
                "highest quality at 568M params"
            ),
        },
        {
            "model_name": "sentence-transformers/all-MiniLM-L6-v2",
            "model_id": "all-minilm-l6-v2",
            "description": "Very fast, lightweight (22M params), English only",
        },
        {
            "model_name": "BAAI/bge-small-en-v1.5",
            "model_id": "bge-small-en-v1.5",
            "description": "Small English model, good speed/quality balance",
        },
    ]
    return web.json_response(
        {
            "suggestions": suggestions,
            "default": services.config.rag.default_embedding_model,
        }
    )


def setup(app: web.Application) -> None:
    r = app.router
    r.add_get("/api/startup/status", status)
    r.add_get("/api/startup/available-indexes", available_indexes)
    # Reference paths (routes/startup.py:98-152) — same handlers.
    r.add_get(
        "/api/startup/embedding-models/available-indexes", available_indexes
    )
    r.add_get(
        "/api/startup/embedding-models/suggestions", embedding_model_suggestions
    )
    r.add_post("/api/startup/download-indexes", download_indexes)
    r.add_post("/api/startup/pull-model", pull_model)
    r.add_delete("/api/startup/reinitialize-indexes", reinitialize_indexes)
