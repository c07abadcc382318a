"""Session routes (reference api/routes/sessions.py:45-294)."""

from __future__ import annotations

from aiohttp import web

from tensortruth_tpu_torch.server.schemas import (
    MessageCreate,
    SessionCreate,
    SessionPatch,
    parse_body,
    read_json,
)


def _svc(request):
    return request.app["services"].session_service


async def list_sessions(request):
    return web.json_response({"sessions": _svc(request).list_sessions()})


async def create_session(request):
    body = await parse_body(request, SessionCreate)
    params = dict(body.params or {})
    modules = body.modules
    if body.project_id:
        # Inherit project params/modules at creation exactly like the
        # project-sessions route: create_session pre-fills EVERY config
        # default into the session, so a later query-time merge of project
        # params would always lose to those defaults (silent no-op).
        services = request.app["services"]
        if services.project_service.get_project(body.project_id) is None:
            raise web.HTTPNotFound(reason="project not found")
        ctx = services.project_service.session_context(body.project_id)
        params = {**ctx["params"], **params}
        if modules is None:
            modules = ctx["modules"]
    session = _svc(request).create_session(
        modules=modules,
        params=params,
        title=body.title,
        project_id=body.project_id,
    )
    return web.json_response(session)


async def get_session(request):
    session = _svc(request).get_session(request.match_info["session_id"])
    if session is None:
        raise web.HTTPNotFound(reason="session not found")
    return web.json_response(session)


async def patch_session(request):
    body = (await parse_body(request, SessionPatch)).model_dump(exclude_unset=True)
    session = _svc(request).update_session(request.match_info["session_id"], body)
    if session is None:
        raise web.HTTPNotFound(reason="session not found")
    return web.json_response(session)


async def delete_session(request):
    if not _svc(request).delete_session(request.match_info["session_id"]):
        raise web.HTTPNotFound(reason="session not found")
    return web.json_response({"status": "deleted"})


async def get_messages(request):
    session = _svc(request).get_session(request.match_info["session_id"])
    if session is None:
        raise web.HTTPNotFound(reason="session not found")
    return web.json_response({"messages": session["messages"]})


async def add_message(request):
    body = await parse_body(request, MessageCreate)
    msg = _svc(request).add_message(
        request.match_info["session_id"],
        role=body.role,
        content=body.content,
        sources=body.sources,
        metrics=body.metrics,
    )
    if msg is None:
        raise web.HTTPNotFound(reason="session not found")
    return web.json_response(msg)


async def delete_message(request):
    svc = _svc(request)
    session = svc.get_session(request.match_info["session_id"])
    if session is None:
        raise web.HTTPNotFound(reason="session not found")
    idx = int(request.match_info["message_index"])
    if not 0 <= idx < len(session["messages"]):
        raise web.HTTPNotFound(reason="message index out of range")
    session["messages"].pop(idx)
    svc.save_session(session)
    return web.json_response({"status": "deleted"})


async def session_stats(request):
    """Per-session history stats (reference sessions.py:200): stored vs
    compiled-for-LLM message/char counts, model + context window."""
    services = request.app["services"]
    session = _svc(request).get_session(request.match_info["session_id"])
    if session is None:
        raise web.HTTPNotFound(reason="session not found")
    messages = session.get("messages", [])
    params = session.get("params", {})

    from tensortruth_tpu_torch.services.chat_history import ChatHistoryService

    history = ChatHistoryService(services.config).build_history(
        messages, max_turns=params.get("max_history_turns")
    )
    compiled = history.to_prompt_string()
    return web.json_response(
        {
            "history_messages": len(messages),
            "history_chars": sum(len(m.get("content", "")) for m in messages),
            "compiled_history_messages": len(history.messages),
            "compiled_history_chars": len(compiled),
            "model_name": params.get("model"),
            "context_length": params.get("context_window"),
        }
    )


async def global_stats(request):
    return web.json_response(_svc(request).stats())


async def get_image(request):
    from tensortruth_tpu_torch.app.paths import get_session_images_dir

    base = get_session_images_dir(request.match_info["session_id"]).resolve()
    path = (base / request.match_info["image_id"]).resolve()
    # Defense in depth behind the path-param middleware: never serve a file
    # that resolves outside this session's images directory.
    if not path.is_relative_to(base):
        raise web.HTTPBadRequest(reason="invalid image id")
    if not path.is_file():
        raise web.HTTPNotFound(reason="image not found")
    return web.FileResponse(path)


def setup(app: web.Application) -> None:
    r = app.router
    r.add_get("/api/sessions", list_sessions)
    r.add_post("/api/sessions", create_session)
    r.add_get("/api/sessions/stats", global_stats)
    r.add_get("/api/sessions/{session_id}/stats", session_stats)
    r.add_get("/api/sessions/{session_id}/messages", get_messages)
    r.add_post("/api/sessions/{session_id}/messages", add_message)
    r.add_delete("/api/sessions/{session_id}/messages/{message_index}", delete_message)
    r.add_get("/api/sessions/{session_id}/images/{image_id}", get_image)
    r.add_get("/api/sessions/{session_id}", get_session)
    r.add_patch("/api/sessions/{session_id}", patch_session)
    r.add_delete("/api/sessions/{session_id}", delete_session)
