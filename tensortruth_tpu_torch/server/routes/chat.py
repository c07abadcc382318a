"""Chat routes: REST + the WebSocket protocol.

Mirrors reference api/routes/chat.py:540-1002:

* ``POST /api/sessions/{id}/chat`` — non-streaming REST chat;
* ``WS /ws/chat/{session_id}`` — the primary path: slash-command detection
  (`/web`, `/help`, user commands), project context merge, engine reload on
  param change, direct RAG streaming (token/thinking/status/sources/done
  message types), message persistence + title generation.

The sync RAGService.query generator is pumped from an executor thread so
device dispatches never block the event loop (reference chat.py:849-994).
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import logging
import os
import re
import threading
import time
from collections import deque

from aiohttp import WSMsgType, web

from tensortruth_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

COMMAND_RE = re.compile(r"^/(\w+)(?:\s+(.*))?$", re.DOTALL)


def _chat_context(services, session: dict) -> dict:
    """Merge project catalog modules + session modules + index paths
    (reference chat.py:119-215 ChatContext.from_session)."""
    modules = list(session.get("modules", []))
    params = dict(session.get("params", {}))
    system_prompt = ""
    if session.get("project_id"):
        ctx = services.project_service.session_context(session["project_id"])
        modules = sorted(set(modules) | set(ctx["modules"]))
        params = {**ctx["params"], **params}
        system_prompt = ctx["system_prompt"]

    from tensortruth_tpu_torch.app.paths import get_project_dir, get_session_dir

    extra_paths = []
    s_idx = get_session_dir(session["id"]) / "index"
    if (s_idx / "index_metadata.json").exists():
        extra_paths.append(str(s_idx))
    if session.get("project_id"):
        p_idx = get_project_dir(session["project_id"]) / "index"
        if (p_idx / "index_metadata.json").exists():
            extra_paths.append(str(p_idx))
    return {
        "modules": modules,
        "params": params,
        "system_prompt": system_prompt,
        "extra_index_paths": extra_paths,
    }


def _persist_images(session_id: str, images) -> list[str]:
    """Save base64 attachments under the session; shared by the REST and WS
    chat paths (reference chat.py image handling + services/image_service.py).
    A failed save is logged, not fatal — the model still sees the inline
    bytes; only the reload-time display is lost."""
    if not images:
        return []
    from tensortruth_tpu_torch.services.image_service import ImageService

    img_svc = ImageService()
    image_ids: list[str] = []
    for b64 in images:
        try:
            image_ids.append(img_svc.save_base64(session_id, b64))
        except Exception as e:
            logger.warning("image save failed: %s", e)
    return image_ids


async def _ensure_engine(services, ctx: dict):
    """Load (or fetch from cache) THIS session's engine and return it.

    The returned engine must be passed to query()/retrieve(): the service's
    current-engine pointer is shared and a concurrent session may swap it
    between load and query (rag_service.retrieve docstring)."""
    rag = services.rag_service
    if not ctx["modules"] and not ctx["extra_index_paths"]:
        rag.unload()
        return None
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(
        None,
        lambda: rag.load_engine(
            ctx["modules"], ctx["params"], extra_index_paths=ctx["extra_index_paths"]
        ),
    )


def _pump_query(rag, prompt, params, messages, engine=None, images=None,
                system_prompt=None):
    """Run the sync generator to completion; returns (events, response)."""
    gen = rag.query(
        prompt, params=params, session_messages=messages, engine=engine,
        images=images, system_prompt=system_prompt,
    )
    events = []
    while True:
        try:
            events.append(next(gen))
        except StopIteration as stop:
            return events, stop.value


# Frames queued while a message streams (per socket). Beyond this the
# client is misbehaving; reply with an error instead of buffering forever.
_MAX_PENDING_FRAMES = 32


async def _stream_with_receive(ws, work_task, pending):
    """The listen-while-streaming obligation, shared by the engine-load,
    orchestrator and direct paths: await ``work_task`` while still reading
    the socket so a {"type": "stop"} frame or a peer drop is seen mid-work
    (reference chat.py:849-994 has the same contract).

    Returns ``(outcome, result)``:

    * outcome ``"done"`` — work finished; ``result`` is its value;
    * outcome ``"stopped"`` — client sent a stop frame;
    * outcome ``"client_gone"`` — socket closed/errored (possibly racing a
      completed work task — either way nothing more can be sent).

    Non-stop TEXT frames arriving mid-work — including one racing the
    completion — append to ``pending`` (a deque) and are processed in
    order after the current message, matching the reference's ``async for``
    loop which buffers them in the socket. A second user message sent while
    a cold engine loads must be answered, not bounced. Past
    ``_MAX_PENDING_FRAMES`` the client gets an error reply instead.

    The work task is NOT cancelled here: teardown differs per caller
    (thread-pump flag vs task cancel). CancelledError (aiohttp tearing the
    handler down on transport drop) propagates for the caller's teardown."""
    recv_task = asyncio.ensure_future(ws.receive())
    try:
        while True:
            done_set, _ = await asyncio.wait(
                {work_task, recv_task}, return_when=asyncio.FIRST_COMPLETED
            )
            if work_task in done_set:
                result = work_task.result()
                if recv_task.done():
                    raced = recv_task.result()
                    if raced.type != WSMsgType.TEXT:
                        return "client_gone", None
                    pending.append(raced)
                    return "done", result
                recv_task.cancel()
                try:
                    await recv_task
                except asyncio.CancelledError:
                    pass
                return "done", result
            inbound = recv_task.result()
            if inbound.type != WSMsgType.TEXT:
                return "client_gone", None
            try:
                req = json.loads(inbound.data)
            except json.JSONDecodeError:
                req = {}
            if req.get("type") == "stop":
                return "stopped", None
            if len(pending) < _MAX_PENDING_FRAMES:
                pending.append(inbound)
            else:
                await ws.send_json(
                    {"type": "error",
                     "error": "too many queued messages — send "
                              '{"type": "stop"} first'}
                )
            recv_task = asyncio.ensure_future(ws.receive())
    except (ConnectionResetError, RuntimeError) as e:
        logger.debug("ws stream peer lost: %r", e)
        return "client_gone", None


async def rest_chat(request: web.Request):
    """Non-streaming REST chat (reference chat.py:540-593)."""
    services = request.app["services"]
    session_id = request.match_info["session_id"]
    session = services.session_service.get_session(session_id)
    if session is None:
        raise web.HTTPNotFound(reason="session not found")
    body = await request.json()
    prompt = body.get("message", "")
    images = body.get("images") or None
    # Persist attachments like the WS path does — without the stored ids a
    # session reload shows a user turn with no images even though the model
    # answered about them.
    image_ids = _persist_images(session_id, images)
    ctx = _chat_context(services, session)
    engine = await _ensure_engine(services, ctx)
    messages = session.get("messages", [])
    loop = asyncio.get_running_loop()
    _, response = await loop.run_in_executor(
        None, _pump_query, services.rag_service, prompt, ctx["params"],
        messages, engine, images, ctx["system_prompt"] or None,
    )
    services.session_service.add_message(
        session_id, "user", prompt,
        **({"images": image_ids} if image_ids else {}),
    )
    services.session_service.add_message(
        session_id,
        "assistant",
        response.text,
        sources=[s.to_dict() for s in response.sources],
        metrics=response.metrics,
    )
    return web.json_response(
        {
            "response": response.text,
            "sources": [s.to_dict() for s in response.sources],
            "metrics": response.metrics,
            "confidence": response.confidence,
        }
    )


async def ws_chat(request: web.Request):
    """WS chat protocol (reference chat.py:596-1002)."""
    services = request.app["services"]
    session_id = request.match_info["session_id"]
    # Long heartbeat (5 min) rather than aiohttp's 30s default: on a
    # saturated single-core host the event loop blocks mid-compile and a
    # short pong deadline hard-closes the socket mid-stream. 300s survives
    # any compile while still reaping half-open peers, which with NO
    # heartbeat would leak a handler task + session state until restart.
    with profiling.SETUP.serving():  # served time until prepare returns
        ws = web.WebSocketResponse(heartbeat=300)
        await ws.prepare(request)

    # Frames that arrived while a message was being processed, in arrival
    # order (the reference's async-for loop gets this buffering from the
    # socket itself).
    pending: deque = deque()
    while True:
        msg = pending.popleft() if pending else await ws.receive()
        if msg.type != WSMsgType.TEXT:
            break
        rid = profiling.next_id()
        # The message's spans carry its id; tt.ws.message ends at its sources frame. The
        # message is served time until its handling ends.
        with profiling.SETUP.serving("messages"), profiling.span("ws.message", rid) as message:
            try:
                data = json.loads(msg.data)
            except json.JSONDecodeError:
                await ws.send_json({"type": "error", "error": "invalid JSON"})
                continue
            if data.get("type") == "stop":
                continue  # nothing streaming — stale stop, ignore
            prompt = data.get("message", "")
            session = _session_io(services, rid, "get_session", session_id)
            if session is None:
                await ws.send_json({"type": "error", "error": "session not found"})
                continue

            # Attached base64 images persist under the session and get local
            # URLs (reference chat.py image handling + services/image_service.py).
            with profiling.span("route.context", rid):
                image_ids = _persist_images(session_id, data.get("images"))

            # -- slash command? (reference chat.py:676-789) ----------------------
            m = COMMAND_RE.match(prompt.strip())
            if m:
                cmd = services.command_registry.get(m.group(1))
                if cmd is None:
                    await ws.send_json(
                        {"type": "error", "error": f"unknown command /{m.group(1)}"}
                    )
                    continue
                with profiling.span("route.context", rid):
                    ctx = _chat_context(services, session)
                context = {
                    "config": services.config,
                    "params": ctx["params"],
                    "session_id": session_id,
                    "services": services,
                    "llm": _make_llm(services, ctx["params"]),
                    "reranker": _current_reranker(services),
                }
                full_text = []
                try:
                    async for event in cmd.execute(m.group(2) or "", context):
                        await ws.send_json(event)
                        if event.get("type") == "token":
                            full_text.append(event.get("content", ""))
                except Exception as e:
                    logger.exception("command /%s failed", m.group(1))
                    await ws.send_json({"type": "error", "error": str(e)})
                    continue
                _session_io(services, rid, "add_message", session_id, "user", prompt)
                if full_text:
                    _session_io(
                        services, rid, "add_message", session_id, "assistant", "".join(full_text)
                    )
                continue

            with profiling.span("route.context", rid):
                ctx = _chat_context(services, session)
            # Engine load follows the SAME read-while-working contract as
            # streaming: a cold load at the 1M tier takes minutes (index mmap +
            # hierarchy parse + first compiles), and aiohttp only processes the
            # client's heartbeat PONGs inside ws.receive() — a bare await here
            # let _pong_not_received fire at heartbeat+grace (450 s) and reap
            # every connected session mid-load (found by
            # scripts/measure_serving_e2e.py driving 64 cold WS sessions).
            async def _safe_load():
                try:
                    return True, await _ensure_engine(services, ctx)
                except Exception as e:  # surfaced as a WS error frame below
                    logger.exception("engine load failed")
                    return False, e
            load_task = asyncio.ensure_future(_safe_load())
            try:
                outcome, load_result = await _stream_with_receive(ws, load_task, pending)
            except asyncio.CancelledError:
                load_task.cancel()
                raise
            if outcome == "client_gone":
                load_task.cancel()  # only this waiter; the shared build continues
                return ws
            if outcome == "stopped":
                load_task.cancel()
                await ws.send_json({"type": "done", "content": "", "cancelled": True})
                continue
            load_ok, engine = load_result
            if not load_ok:
                await ws.send_json(
                    {"type": "error", "error": f"engine load failed: {engine}"}
                )
                continue

            messages = session.get("messages", [])
            _session_io(
                services, rid, "add_message", session_id, "user", prompt,
                **({"images": image_ids} if image_ids else {}),
            )

            # -- orchestrator path (reference chat.py:245-537): enabled param +
            # tool-capable model; any failure falls back to the direct pipeline.
            # Same read-while-streaming contract as the direct path: the
            # orchestrator runs as a task while we keep receiving, so a
            # {"type": "stop"} cancels the whole agent loop (CancelledError
            # aborts the in-flight LLM/tool awaits) without losing the socket.
            if _orchestrator_enabled(services, ctx["params"]):
                orch_task = asyncio.ensure_future(_run_orchestrator(
                    services, ws, session_id, session, prompt, ctx, messages,
                    engine=engine, images=data.get("images") or None,
                ))
                try:
                    outcome, ok = await _stream_with_receive(ws, orch_task, pending)
                except asyncio.CancelledError:
                    orch_task.cancel()  # don't leave the agent loop running
                    raise
                if outcome != "done":
                    orch_task.cancel()
                    try:
                        await orch_task
                    except (asyncio.CancelledError, ConnectionResetError, RuntimeError):
                        pass
                    if outcome == "client_gone":
                        return ws
                    await ws.send_json({"type": "done", "content": "", "cancelled": True})
                    continue
                if ok:
                    continue

            # -- direct RAG path ---------------------------------------------------

            loop = asyncio.get_running_loop()
            queue: asyncio.Queue = asyncio.Queue()
            DONE = object()
            cancel = threading.Event()

            def pump():
                rag = services.rag_service
                gen = rag.query(
                    prompt, params=ctx["params"], session_messages=messages,
                    engine=engine, images=data.get("images") or None,
                    system_prompt=ctx["system_prompt"] or None,
                )
                while True:
                    # Client gone (Stop button / dropped peer): close the
                    # generator so GeneratorExit aborts the provider stream at
                    # its current yield — without this the pump keeps pulling
                    # LLM tokens into a queue nobody drains.
                    if cancel.is_set():
                        gen.close()
                        loop.call_soon_threadsafe(queue.put_nowait, (DONE, None))
                        return
                    try:
                        chunk = next(gen)
                        loop.call_soon_threadsafe(queue.put_nowait, chunk)
                    except StopIteration as stop:
                        loop.call_soon_threadsafe(queue.put_nowait, (DONE, stop.value))
                        return
                    except Exception as e:  # surface pipeline errors to the client
                        loop.call_soon_threadsafe(queue.put_nowait, (DONE, e))
                        return

            # In a copy of this task's context: the pump's spans carry the message's id.
            task = loop.run_in_executor(None, contextvars.copy_context().run, pump)

            async def drain_and_send():
                """Forward pump chunks to the socket; returns the RAGResponse."""
                while True:
                    item = await queue.get()
                    if isinstance(item, tuple) and item[0] is DONE:
                        return item[1]
                    if item.status:
                        await ws.send_json({"type": "status", "status": item.status})
                    if item.thinking:
                        await ws.send_json({"type": "thinking", "content": item.thinking})
                    if item.text:
                        await ws.send_json({"type": "token", "content": item.text})

            # Stream AND read concurrently (_stream_with_receive): a close frame
            # or stop must be seen while the server generates. On cancellation
            # or peer loss the executor pump is NOT cancelled with the task —
            # flag it (it closes the generator within one chunk) and join.
            send_task = asyncio.ensure_future(drain_and_send())
            t_gen0 = time.monotonic()
            try:
                outcome, response = await _stream_with_receive(ws, send_task, pending)
            except asyncio.CancelledError:
                logger.debug("ws handler cancelled by transport close")
                cancel.set()
                raise
            stopped = outcome == "stopped"
            client_gone = outcome == "client_gone"
            if outcome != "done":
                cancel.set()
                logger.debug("ws stream cancelling: gone=%s stopped=%s", client_gone, stopped)
                send_task.cancel()
                try:
                    await send_task
                except (asyncio.CancelledError, ConnectionResetError, RuntimeError):
                    pass
            await task
            logger.debug("ws stream pump joined (gone=%s stopped=%s)", client_gone, stopped)
            if client_gone:
                return ws
            if stopped:
                await ws.send_json({"type": "done", "content": "", "cancelled": True})
                continue
            if isinstance(response, Exception):
                await ws.send_json({"type": "error", "error": str(response)})
                continue

            sources = [s.to_dict() for s in response.sources]
            await ws.send_json({"type": "sources", "sources": sources})
            message.close()
            # generation stats (reference chat.py:934-942 done-message token
            # estimates; SPA shows them like ResponseStats) — ONE dict, sent on
            # the wire and persisted verbatim so frame and message can't drift
            stats = _gen_stats(response.text, time.monotonic() - t_gen0)
            await ws.send_json(
                {
                    "type": "done",
                    "content": response.text,
                    "metrics": response.metrics,
                    "confidence": response.confidence,
                    "stats": stats,
                }
            )
            _session_io(
                services, rid, "add_message", session_id, "assistant", response.text,
                sources=sources, metrics=response.metrics,
                # persisted so a reloaded session still shows the confidence
                # badge and generation stats (reference chat.py:507-519 metrics
                # persistence; SPA renderHistoryMessage reads these fields)
                confidence=response.confidence,
                stats=stats,
            )
            # Smart title from the first exchange (reference chat.py:501-537).
            if session.get("title_needs_update") and response.text:
                with profiling.span("route.title", rid):
                    title = _smart_title(prompt, services, ctx["params"])
                _session_io(services, rid, "set_title", session_id, title)
                await ws.send_json({"type": "title", "title": title})
    return ws


def _session_io(services, rid, method: str, session_id: str, *args, **kw):
    """``session_service.<method>(session_id, ...)`` on the event loop, under
    a ``tt.route.session_io`` span; a call that writes counts the bytes of
    the session file and the session index it leaves (each rewritten whole)."""
    svc = services.session_service
    with profiling.span("route.session_io", rid) as span:
        out = getattr(svc, method)(session_id, *args, **kw)
        if span and method != "get_session":
            files = (svc._session_file(session_id), svc.index_file)
            span.count(bytes=sum(os.path.getsize(f) for f in files if os.path.exists(f)))
    return out


def _orchestrator_enabled(services, params: dict) -> bool:
    """Param + model tool-capability probe (reference chat.py:245-290).

    A missing param means enabled — the reference defaults the config check
    to True (chat.py:267) and session defaults fill it from config anyway;
    defaulting False here silently forced legacy/stripped-params sessions
    onto the direct path."""
    if not params.get("orchestrator_enabled", True):
        return False
    try:
        from tensortruth_tpu_torch.core.providers import ProviderRegistry

        registry = ProviderRegistry.get_instance(services.config.providers)
        ref = registry.resolve_model(params.get("model"), params.get("provider_id"))
        return ref is not None and registry.check_capability(ref, "tools")
    except Exception:
        return False


async def _run_orchestrator(
    services, ws, session_id, session, prompt, ctx, messages, engine=None,
    images=None,
) -> bool:
    """Returns True when the orchestrator produced an answer; False → direct
    fallback (reference chat.py:839-847)."""
    from tensortruth_tpu_torch.services.orchestrator_service import OrchestratorService

    llm = _make_llm(services, {**ctx["params"], "temperature": 0.2, "thinking": False})
    synth_llm = _make_llm(services, ctx["params"])
    if llm is None:
        return False
    orch = OrchestratorService(
        services.rag_service, services.tool_service, services.config
    )
    from tensortruth_tpu_torch.services.orchestrator_tools import create_service_tools

    service_tools = create_service_tools(
        services, session_id=session_id, emit=ws.send_json
    )
    try:  # live MCP tools (reference tool_service.py:221-244 startup load)
        service_tools.update(await services.get_mcp_tools())
    except Exception as e:
        logger.warning("MCP tool load failed: %s", e)
    done_msg = None
    sources: list[dict] = []
    # Server-side mirror of the SPA's live timeline bookkeeping
    # (chat/progress.js beginToolCalls/resolveToolCall) so tool steps
    # survive a session reload (reference persists tool_steps on messages).
    tool_steps: list[dict] = []
    t_gen0 = time.monotonic()
    try:
        async for event in orch.execute(
            prompt, llm, synthesis_llm=synth_llm, extra_tools=service_tools,
            modules=ctx["modules"], params=ctx["params"], engine=engine,
            project_prompt=ctx["system_prompt"] or None, images=images,
            history=[
                {"role": m["role"], "content": m["content"]}
                for m in messages
                if m.get("role") in ("user", "assistant") and m.get("content")
            ],
        ):
            if event["type"] == "error":
                logger.warning("orchestrator failed: %s", event.get("error"))
                return False
            if event["type"] == "sources":
                sources = event["sources"]
            if event["type"] in ("tool_phase", "tool_progress"):
                mirror_tool_event(tool_steps, event)
            if event["type"] == "done":
                event = {
                    **event,
                    "stats": _gen_stats(
                        event.get("content", ""), time.monotonic() - t_gen0
                    ),
                }
                done_msg = event
            await ws.send_json(event)
    except Exception as e:
        logger.exception("orchestrator crashed; direct fallback")
        return False
    if done_msg is None:
        return False
    extra: dict = {}
    if tool_steps:
        extra["tool_steps"] = tool_steps
    if done_msg.get("stats"):
        extra["stats"] = done_msg["stats"]
    services.session_service.add_message(
        session_id, "assistant", done_msg.get("content", ""), sources=sources,
        **extra,
    )
    if session.get("title_needs_update") and done_msg.get("content"):
        title = _smart_title(prompt, services, ctx["params"])
        services.session_service.set_title(session_id, title)
        await ws.send_json({"type": "title", "title": title})
    return True


def mirror_tool_event(tool_steps: list[dict], event: dict) -> None:
    """Server-side mirror of the SPA's live-timeline bookkeeping
    (chat/progress.js beginToolCalls/resolveToolCall) so the persisted
    tool_steps agree with what the live view painted — including the
    failure inference for phase-less progress (message prefix) and
    positional same-tool pairing. A cross-language equivalence property
    test (tests/unit/test_property.py) holds the two implementations
    together."""
    if event["type"] == "tool_phase":
        # JS `msg.calls || fallback`: an empty ARRAY is truthy there, so a
        # present-but-empty calls list must NOT fall back to tools
        calls = event.get("calls")
        if calls is None:
            calls = [{"tool": t, "params": None} for t in event.get("tools", [])]
        for call in calls:
            tool_steps.append(
                {"tool": call["tool"], "params": call.get("params"),
                 "status": "calling"}
            )
        return
    msg_text = event.get("message") or ""
    failed = event.get("phase") == "failed" or (
        not event.get("phase") and re.match(r"(?i)(error|failed)\b", msg_text)
    )
    status = "failed" if failed else "completed"
    for step in tool_steps:
        if step["tool"] == event.get("tool") and step["status"] == "calling":
            step["status"] = status
            step["message"] = event.get("message")
            step["output"] = (event.get("output") or "")[:2000] or None
            return
    tool_steps.append(
        {"tool": event.get("tool"), "status": status,
         "message": event.get("message"),
         "output": (event.get("output") or "")[:2000] or None}
    )


def _gen_stats(text: str, gen_s: float) -> dict:
    """Done-frame generation stats (reference chat.py:934-942 token
    estimates, CHARS_PER_TOKEN=4) — single source for the wire frame AND
    the persisted message."""
    est_tokens = len(text) // 4
    return {
        "duration_ms": round(gen_s * 1e3),
        "est_tokens": est_tokens,
        "tokens_per_s": round(est_tokens / gen_s, 1) if gen_s > 0 else None,
    }


def _smart_title(prompt: str, services=None, params=None) -> str:
    """LLM title with heuristic fallback (app/title_generation.py)."""
    from tensortruth_tpu_torch.app.title_generation import generate_smart_title

    llm = _make_llm(services, params or {}) if services is not None else None
    return generate_smart_title(prompt, llm=llm)


def _make_llm(services, params):
    try:
        if services.rag_service._llm_factory is not None:
            return services.rag_service._llm_factory(params)
        from tensortruth_tpu_torch.core.providers import create_llm

        return create_llm(params)
    except Exception:
        return None


def _current_reranker(services):
    """Engine reranker, else load the default for web reranking on the
    server's device (reference web_search.py get_reranker_for_web via
    ModelManager). A failed load raises: the web path is not served
    unreranked behind a model or kernel that did not load."""
    engine = services.rag_service.engine
    if engine is not None and engine.reranker is not None:
        return engine.reranker
    from tensortruth_tpu_torch.models.manager import ModelManager, ModelSpec

    return ModelManager.get_instance().get_reranker(
        ModelSpec(services.config.rag.default_reranker), device=services.device
    )


def setup(app: web.Application) -> None:
    app.router.add_post("/api/sessions/{session_id}/chat", rest_chat)
    app.router.add_get("/ws/chat/{session_id}", ws_chat)
