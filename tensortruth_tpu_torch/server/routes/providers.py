"""Provider CRUD/test/discover routes (reference api/routes/providers.py:215-463)."""

from __future__ import annotations

from dataclasses import asdict

from aiohttp import web

from tensortruth_tpu_torch.app.config import ProviderConfig, save_config
from tensortruth_tpu_torch.core.providers import ProviderRegistry
from tensortruth_tpu_torch.server.schemas import (
    ProviderCreate,
    ProviderPatch,
    ProviderTest,
    parse_body,
)


def _find(services, provider_id: str) -> ProviderConfig | None:
    return next((p for p in services.config.providers if p.id == provider_id), None)


async def list_providers(request: web.Request):
    services = request.app["services"]
    return web.json_response({"providers": [asdict(p) for p in services.config.providers]})


async def create_provider(request: web.Request):
    services = request.app["services"]
    body = await parse_body(request, ProviderCreate)
    if _find(services, body.id) is not None:
        raise web.HTTPConflict(reason="provider id already exists")
    from tensortruth_tpu_torch.app.config import _from_dict

    p = _from_dict(ProviderConfig, body.model_dump())
    services.config.providers.append(p)
    save_config(services.config)
    ProviderRegistry.reset_instance()
    return web.json_response(asdict(p))


async def patch_provider(request: web.Request):
    services = request.app["services"]
    p = _find(services, request.match_info["provider_id"])
    if p is None:
        raise web.HTTPNotFound(reason="provider not found")
    body = (await parse_body(request, ProviderPatch)).model_dump(exclude_unset=True)
    for k, v in body.items():
        # no ProviderConfig field is nullable — explicit null means "leave"
        if v is not None and hasattr(p, k) and k != "id":
            setattr(p, k, v)
    save_config(services.config)
    ProviderRegistry.reset_instance()
    return web.json_response(asdict(p))


async def delete_provider(request: web.Request):
    services = request.app["services"]
    p = _find(services, request.match_info["provider_id"])
    if p is None:
        raise web.HTTPNotFound(reason="provider not found")
    services.config.providers.remove(p)
    save_config(services.config)
    ProviderRegistry.reset_instance()
    return web.json_response({"status": "deleted"})


async def test_provider(request: web.Request):
    """Connectivity test (reference providers.py:395-425)."""
    body = (await parse_body(request, ProviderTest)).model_dump()
    registry = ProviderRegistry(
        [ProviderConfig(id="test", type=body["type"],
                        base_url=body["base_url"], api_key=body["api_key"])]
    )
    try:
        # probe_models raises on an unreachable server; list_models would
        # swallow the failure into an empty success and the UI's "Test"
        # button would show ✓ for a dead provider
        models = registry.probe_models("test")
        return web.json_response({"ok": True, "models": models})
    except Exception as e:
        return web.json_response({"ok": False, "error": str(e)})


async def discover_models(request: web.Request):
    services = request.app["services"]
    registry = ProviderRegistry.get_instance(services.config.providers)
    provider_id = request.query.get("provider_id")
    ids = [provider_id] if provider_id else list(registry.providers)
    return web.json_response(
        {pid: registry.list_models(pid, ttl=0) for pid in ids}
    )


def setup(app: web.Application) -> None:
    r = app.router
    r.add_get("/api/providers", list_providers)
    r.add_post("/api/providers", create_provider)
    r.add_post("/api/providers/test", test_provider)
    r.add_get("/api/providers/discover", discover_models)
    r.add_patch("/api/providers/{provider_id}", patch_provider)
    r.add_delete("/api/providers/{provider_id}", delete_provider)
