"""Tool confirmation routes (reference api/routes/tool_confirmations.py:19-60)."""

from __future__ import annotations

from aiohttp import web


def _svc(request):
    return request.app["services"].confirmation_service


async def get_confirmation(request):
    conf = _svc(request).get(request.match_info["confirmation_id"])
    if conf is None:
        raise web.HTTPNotFound(reason="confirmation not found")
    return web.json_response(conf.to_dict())


async def approve(request):
    if not _svc(request).approve(request.match_info["confirmation_id"]):
        raise web.HTTPNotFound(reason="confirmation not found or already decided")
    return web.json_response({"status": "approved"})


async def reject(request):
    if not _svc(request).reject(request.match_info["confirmation_id"]):
        raise web.HTTPNotFound(reason="confirmation not found or already decided")
    return web.json_response({"status": "rejected"})


def setup(app: web.Application) -> None:
    r = app.router
    r.add_get("/api/tool-confirmations/{confirmation_id}", get_confirmation)
    r.add_post("/api/tool-confirmations/{confirmation_id}/approve", approve)
    r.add_post("/api/tool-confirmations/{confirmation_id}/reject", reject)
