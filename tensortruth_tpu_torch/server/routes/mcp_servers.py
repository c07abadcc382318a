"""MCP server config routes (reference api/routes/mcp_servers.py:35-92)."""

from __future__ import annotations

from aiohttp import web

from tensortruth_tpu_torch.server.schemas import (
    MCPServerCreate,
    MCPServerPatch,
    parse_body,
)


def _svc(request):
    return request.app["services"].mcp_service


async def list_servers(request):
    """Configs + config-level errors + last-known connect status.

    A server with an unsupported transport or missing url/command shows a
    ``config_error`` immediately (pure validation); ``connection`` carries
    the most recent load attempt's outcome (connected/error/disabled) once
    the orchestrator has loaded tools. Reference surfaces the same failures
    only in logs (server_registry.py:147-174)."""
    from tensortruth_tpu_torch.agents.mcp_client import validate_server_config

    live = request.app["services"].mcp_connection_status()
    servers = []
    for cfg in _svc(request).list_servers():
        err = validate_server_config(cfg)
        if err:
            cfg["config_error"] = err
        if cfg["name"] in live:
            cfg["connection"] = live[cfg["name"]]
        servers.append(cfg)
    return web.json_response({"servers": servers})


async def presets(request):
    return web.json_response({"presets": _svc(request).get_presets()})


async def add_server(request):
    await request.app["services"].invalidate_mcp_tools()
    body = (await parse_body(request, MCPServerCreate)).model_dump()
    name = body.pop("name", "")
    if not name:
        raise web.HTTPUnprocessableEntity(reason="name required")
    try:
        return web.json_response(_svc(request).add_server(name, body))
    except ValueError as e:
        raise web.HTTPConflict(reason=str(e))


async def patch_server(request):
    await request.app["services"].invalidate_mcp_tools()
    patch = (await parse_body(request, MCPServerPatch)).model_dump(exclude_unset=True)
    out = _svc(request).update_server(request.match_info["name"], patch)
    if out is None:
        raise web.HTTPNotFound(reason="server not found")
    return web.json_response(out)


async def delete_server(request):
    await request.app["services"].invalidate_mcp_tools()
    if not _svc(request).delete_server(request.match_info["name"]):
        raise web.HTTPNotFound(reason="server not found")
    return web.json_response({"status": "deleted"})


async def toggle_server(request):
    await request.app["services"].invalidate_mcp_tools()
    out = _svc(request).toggle_server(request.match_info["name"])
    if out is None:
        raise web.HTTPNotFound(reason="server not found")
    return web.json_response(out)


def setup(app: web.Application) -> None:
    r = app.router
    r.add_get("/api/mcp-servers", list_servers)
    r.add_get("/api/mcp-servers/", list_servers)
    r.add_get("/api/mcp-servers/presets", presets)
    r.add_post("/api/mcp-servers", add_server)
    r.add_patch("/api/mcp-servers/{name}/toggle", toggle_server)
    r.add_patch("/api/mcp-servers/{name}", patch_server)
    r.add_delete("/api/mcp-servers/{name}", delete_server)
