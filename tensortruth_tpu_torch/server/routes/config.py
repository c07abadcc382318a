"""Config routes (reference api/routes/config.py:74-125)."""

from __future__ import annotations

from aiohttp import web

from tensortruth_tpu_torch.server.schemas import read_json, validate_config_patch


async def get_config(request: web.Request):
    return web.json_response(request.app["services"].config.to_dict())


async def patch_config(request: web.Request):
    """Deep-merge a partial config dict, persist, reload singletons."""
    services = request.app["services"]
    patch = validate_config_patch(await read_json(request))
    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig, save_config

    current = services.config.to_dict()

    def merge(dst: dict, src: dict) -> dict:
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v
        return dst

    merged = merge(current, patch)
    services.config = TensorTruthTPUConfig.from_dict(merged)
    services.rebind_config()  # already-built singletons hold their own ref
    save_config(services.config)
    if "providers" in patch:
        # get_instance no longer rebuilds on every call — a provider change
        # through the config editor must invalidate the registry singleton
        from tensortruth_tpu_torch.core.providers import ProviderRegistry

        ProviderRegistry.reset_instance()
    return web.json_response(services.config.to_dict())


async def get_defaults(request: web.Request):
    from tensortruth_tpu_torch.app.config import TensorTruthTPUConfig

    return web.json_response(TensorTruthTPUConfig.default().to_dict())


async def get_devices(request: web.Request):
    from tensortruth_tpu_torch.server.routes.system import device_entries

    devices = [
        {k: d[k] for k in ("id", "platform", "kind")}
        for d in device_entries(request.app["services"].device)
    ]
    return web.json_response({"devices": devices, "default_backend": devices[0]["platform"]})


async def model_capabilities(request: web.Request):
    from tensortruth_tpu_torch.core.providers import ModelReference, ProviderRegistry

    services = request.app["services"]
    model = request.query.get("model", "")
    provider_id = request.query.get("provider_id", "")
    registry = ProviderRegistry.get_instance(services.config.providers)
    ref = (
        ModelReference(provider_id, model)
        if provider_id
        else registry.resolve_model(model)
    )
    if ref is None:
        return web.json_response({"tools": False, "thinking": False})
    return web.json_response(
        {
            "tools": registry.check_capability(ref, "tools"),
            "thinking": registry.check_capability(ref, "thinking"),
        }
    )


def setup(app: web.Application) -> None:
    r = app.router
    r.add_get("/api/config", get_config)
    r.add_patch("/api/config", patch_config)
    r.add_get("/api/config/defaults", get_defaults)
    r.add_get("/api/config/devices", get_devices)
    r.add_get("/api/config/model-capabilities", model_capabilities)
