"""Background task routes (reference api/routes/tasks.py:30-39)."""

from __future__ import annotations

from aiohttp import web


async def list_tasks(request: web.Request):
    runner = request.app["services"].task_runner
    return web.json_response({"tasks": [t.to_dict() for t in runner.list()]})


async def get_task(request: web.Request):
    runner = request.app["services"].task_runner
    task = runner.get(request.match_info["task_id"])
    if task is None:
        raise web.HTTPNotFound(reason="task not found")
    return web.json_response(task.to_dict())


def setup(app: web.Application) -> None:
    app.router.add_get("/api/tasks", list_tasks)
    app.router.add_get("/api/tasks/{task_id}", get_task)
