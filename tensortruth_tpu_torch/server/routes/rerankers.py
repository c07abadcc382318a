"""Reranker model list/add/remove routes (reference api/routes/rerankers.py:67-154)."""

from __future__ import annotations

from aiohttp import web

from tensortruth_tpu_torch.app.config import save_config
from tensortruth_tpu_torch.models.manager import _RERANKER_ARCHS
from tensortruth_tpu_torch.server.schemas import RerankerAdd, parse_body


async def list_rerankers(request: web.Request):
    services = request.app["services"]
    return web.json_response({"rerankers": services.config.rag.get_reranker_models()})


async def add_reranker(request: web.Request):
    """Add a custom reranker id; validated against known architectures
    (the reference validates against HF Hub, reference rerankers.py:79-121 —
    offline here, so validation = architecture registry membership or
    explicit local_dir)."""
    services = request.app["services"]
    body = await parse_body(request, RerankerAdd)
    model_id = body.model_id
    known = model_id in _RERANKER_ARCHS or body.local_dir
    if not known:
        raise web.HTTPUnprocessableEntity(
            reason=f"unknown reranker architecture: {model_id}"
        )
    models = services.config.rag.get_reranker_models()
    if model_id in models:
        raise web.HTTPConflict(reason="reranker already registered")
    services.config.rag.reranker_models = models + [model_id]
    save_config(services.config)
    return web.json_response({"rerankers": services.config.rag.reranker_models})


async def remove_reranker(request: web.Request):
    services = request.app["services"]
    model_id = request.match_info["model_id"]
    models = services.config.rag.get_reranker_models()
    if model_id not in models:
        raise web.HTTPNotFound(reason="reranker not found")
    services.config.rag.reranker_models = [m for m in models if m != model_id]
    save_config(services.config)
    return web.json_response({"rerankers": services.config.rag.reranker_models})


def setup(app: web.Application) -> None:
    r = app.router
    r.add_get("/api/rerankers", list_rerankers)
    r.add_post("/api/rerankers", add_reranker)
    r.add_delete("/api/rerankers/{model_id:.+}", remove_reranker)
