"""Tool + agent listing routes (reference api/routes/tools.py:15-27)."""

from __future__ import annotations

from aiohttp import web


async def list_tools(request: web.Request):
    return web.json_response({"tools": request.app["services"].tool_service.list_tools()})


async def list_agents(request: web.Request):
    from tensortruth_tpu_torch.agents.registry import AgentFactoryRegistry

    return web.json_response({"agents": AgentFactoryRegistry.get_instance().list_agents()})


def setup(app: web.Application) -> None:
    app.router.add_get("/api/tools", list_tools)
    app.router.add_get("/api/agents", list_agents)
