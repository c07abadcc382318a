"""arXiv lookup route (reference api/routes/arxiv.py:17)."""

from __future__ import annotations

import asyncio

from aiohttp import web


async def lookup(request: web.Request):
    from tensortruth_tpu_torch.web.fetch import ArxivHandler

    arxiv_id = request.match_info["arxiv_id"]
    handler = ArxivHandler()
    url = f"https://arxiv.org/abs/{arxiv_id}"
    if not handler.matches(url):
        raise web.HTTPUnprocessableEntity(reason="invalid arXiv id")
    try:
        title, markdown = await asyncio.to_thread(handler.fetch, url)
    except Exception as e:
        return web.json_response({"error": f"arXiv unavailable: {e}"}, status=502)
    return web.json_response({"arxiv_id": arxiv_id, "title": title, "markdown": markdown})


def setup(app: web.Application) -> None:
    app.router.add_get("/api/arxiv/{arxiv_id:.+}", lookup)
