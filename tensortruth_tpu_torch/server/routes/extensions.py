"""Extension routes (reference api/routes/extensions.py:35-76)."""

from __future__ import annotations

from aiohttp import web

from tensortruth_tpu_torch.server.schemas import ExtensionInstall, parse_body


async def list_extensions(request: web.Request):
    from tensortruth_tpu_torch.extensions.loader import list_installed_extensions

    return web.json_response({"extensions": list_installed_extensions()})


async def library(request: web.Request):
    """Remote extension catalog; offline returns the bundled catalog."""
    from tensortruth_tpu_torch.extensions.loader import get_extension_catalog

    return web.json_response({"catalog": get_extension_catalog(request.app["services"].config)})


async def install(request: web.Request):
    from tensortruth_tpu_torch.extensions.loader import install_extension, install_from_catalog

    body = await parse_body(request, ExtensionInstall)
    try:
        if body.catalog_name:  # install a bundled catalog entry
            result = install_from_catalog(
                body.catalog_name, services=request.app["services"]
            )
        else:
            result = install_extension(
                body.ext_type,
                body.filename,
                body.content,
                services=request.app["services"],
            )
    except ValueError as e:
        raise web.HTTPUnprocessableEntity(reason=str(e))
    return web.json_response(result)


async def uninstall(request: web.Request):
    from tensortruth_tpu_torch.extensions.loader import uninstall_extension

    ok = uninstall_extension(
        request.match_info["ext_type"],
        request.match_info["filename"],
        services=request.app["services"],
    )
    if not ok:
        raise web.HTTPNotFound(reason="extension not found")
    return web.json_response({"status": "uninstalled"})


async def reload_extensions(request: web.Request):
    from tensortruth_tpu_torch.extensions.loader import load_user_extensions

    result = load_user_extensions(request.app["services"])
    return web.json_response(result)


def setup(app: web.Application) -> None:
    r = app.router
    r.add_get("/api/extensions", list_extensions)
    r.add_get("/api/extensions/", list_extensions)
    r.add_get("/api/extensions/library", library)
    r.add_post("/api/extensions/install", install)
    r.add_delete("/api/extensions/{ext_type}/{filename}", uninstall)
    r.add_post("/api/reload-extensions", reload_extensions)
