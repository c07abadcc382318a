"""aiohttp application factory.

Mirrors reference api/main.py:41-265 — CORS, all route modules under
``/api``, WS chat, ``/health``, SPA static serving, lifespan (startup checks
→ tool load → user extensions → TaskRunner; shutdown cleanup). FastAPI is
not available in this environment; aiohttp provides the same async REST+WS
surface with identical paths and JSON shapes.
"""

from __future__ import annotations

import asyncio
import logging
import re
from pathlib import Path

from aiohttp import web

from tensortruth_tpu_torch.server.deps import ServiceContainer

logger = logging.getLogger(__name__)

STATIC_DIR = Path(__file__).resolve().parent.parent / "static"

# Path-parameter allowlists. aiohttp decodes %2F to "/" in match_info values
# (unlike Starlette, which splits segments before decoding), so every id that
# reaches a filesystem join MUST be validated or traversal becomes arbitrary
# read/write/delete. ``model_id`` legitimately contains one "/" (org/name).
_SAFE_PARAM = re.compile(r"[A-Za-z0-9][A-Za-z0-9 _.\-]{0,127}$")
_SAFE_MODEL_ID = re.compile(
    r"[A-Za-z0-9][A-Za-z0-9_.\-]{0,127}(/[A-Za-z0-9][A-Za-z0-9_.\-]{0,127})?$"
)
# aiohttp's add_static binds nested asset paths (e.g. sub/app.css) to
# 'filename'; bundler output may start with '_' or '.' — allow multi-segment
# paths (the '..'-segment check below plus aiohttp's own resolve-inside-root
# protection keep it traversal-safe).
_SAFE_STATIC = re.compile(
    r"[A-Za-z0-9_.\-][A-Za-z0-9 _.\-]{0,127}(/[A-Za-z0-9_.\-][A-Za-z0-9 _.\-]{0,127})*$"
)
_UNVALIDATED_PARAMS = {"tail"}  # SPA catch-all; never touches the filesystem


@web.middleware
async def path_param_middleware(request: web.Request, handler):
    """Reject any decoded path parameter that could escape its directory."""
    for name, value in request.match_info.items():
        if name in _UNVALIDATED_PARAMS:
            continue
        if name == "model_id":
            pat = _SAFE_MODEL_ID
        elif name == "filename":
            pat = _SAFE_STATIC
        else:
            pat = _SAFE_PARAM
        if not pat.fullmatch(value) or ".." in value.split("/"):
            raise web.HTTPBadRequest(reason=f"invalid path parameter {name!r}")
    return await handler(request)


@web.middleware
async def cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        resp = web.Response()
    else:
        try:
            resp = await handler(request)
        except web.HTTPException as e:
            resp = e
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "GET,POST,PATCH,PUT,DELETE,OPTIONS"
    resp.headers["Access-Control-Allow-Headers"] = "Content-Type,Authorization"
    if isinstance(resp, web.HTTPException):
        raise resp
    return resp


@web.middleware
async def error_middleware(request: web.Request, handler):
    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except Exception as e:
        logger.exception("unhandled error on %s %s", request.method, request.path)
        return web.json_response({"detail": str(e)}, status=500)


def create_app(data_dir: str | Path | None = None, config=None, device="cuda") -> web.Application:
    """The app on ``device``: models and engines load there (``cuda`` unless
    the caller asks for the CPU)."""
    from tensortruth_tpu_torch.utils import profiling

    @web.middleware
    async def served_time(request: web.Request, handler):
        """A session create is served time on the set-up account's clock."""
        if request.method == "POST" and request.path == "/api/sessions":
            with profiling.SETUP.serving("sessions"):
                return await handler(request)
        return await handler(request)

    app = web.Application(
        middlewares=[served_time, cors_middleware, error_middleware, path_param_middleware],
        client_max_size=256 * 2**20,  # uploads
    )
    services = ServiceContainer(data_dir=data_dir, config=config, device=device)
    app["services"] = services

    async def health(_):
        return web.json_response({"status": "ok"})

    app.router.add_get("/health", health)

    from tensortruth_tpu_torch.server.routes import (
        arxiv,
        chat,
        commands,
        config as config_routes,
        documents,
        extensions,
        mcp_servers,
        modules,
        projects,
        providers,
        rerankers,
        sessions,
        startup,
        system,
        tasks,
        tool_confirmations,
        tools,
    )

    for mod in (
        startup, sessions, projects, chat, commands, config_routes, providers,
        rerankers, modules, documents, arxiv, system, tasks, tools,
        mcp_servers, extensions, tool_confirmations,
    ):
        mod.setup(app)

    # Bundled SPA (reference main.py:202-226): serve static files + catch-all.
    if STATIC_DIR.exists():
        async def index(_):
            return web.FileResponse(STATIC_DIR / "index.html")

        app.router.add_get("/", index)
        app.router.add_static("/assets", STATIC_DIR / "assets" if (STATIC_DIR / "assets").exists() else STATIC_DIR)

        # Renderer conformance harness (markdown/TeX/highlight golden cases,
        # executed in a real JS runtime — see static/conformance.html).
        conformance = STATIC_DIR / "conformance.html"
        if conformance.exists():
            async def conformance_page(_):
                return web.FileResponse(conformance)

            app.router.add_get("/conformance.html", conformance_page)

        app.router.add_get("/{tail:(?!api|ws|health).*}", index)

    async def on_startup(app: web.Application):
        services.task_runner  # start the queue
        if services.config.rag.query_batching:
            services.rag_service.enable_batching(
                max_batch=services.config.rag.query_batching_max_batch,
                max_wait_ms=services.config.rag.query_batching_max_wait_ms,
            )
            # The WS/REST chat paths pump sync query generators via
            # run_in_executor(None, ...); each pump BLOCKS on its batcher
            # future, so the default executor (min(32, cpus+4) threads —
            # 5 on a 1-core host) would cap batch coalescing far below
            # max_batch. These threads are device-wait-bound, not
            # CPU-bound: size the pool to the batching tier (two in-flight
            # double-buffered batches + engine loads + misc executor use).
            import concurrent.futures

            n = services.config.rag.query_batching_max_batch * 2 + 8
            asyncio.get_running_loop().set_default_executor(
                concurrent.futures.ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix="tt-pump"
                )
            )
        try:
            from tensortruth_tpu_torch.app.paths import get_base_indexes_dir
            from tensortruth_tpu_torch.indexing.migration import check_and_migrate_on_startup

            check_and_migrate_on_startup(
                get_base_indexes_dir(), services.config.rag.default_embedding_model
            )
        except Exception as e:
            logger.warning("index migration check failed: %s", e)
        try:
            from tensortruth_tpu_torch.extensions.loader import load_user_extensions

            load_user_extensions(services)
        except Exception as e:
            logger.warning("extension loading failed: %s", e)

    async def on_cleanup(app: web.Application):
        services.rag_service.disable_batching()
        services.shutdown()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def run(host: str = "0.0.0.0", port: int = 8000) -> None:
    logging.basicConfig(level=logging.INFO)
    web.run_app(create_app(), host=host, port=port)
