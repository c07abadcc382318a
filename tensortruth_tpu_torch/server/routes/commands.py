"""Command listing route (reference api/routes/commands.py:313-320)."""

from __future__ import annotations

from aiohttp import web


async def list_commands(request: web.Request):
    registry = request.app["services"].command_registry
    return web.json_response({"commands": registry.list_commands()})


def setup(app: web.Application) -> None:
    app.router.add_get("/api/commands", list_commands)
