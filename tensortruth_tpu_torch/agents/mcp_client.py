"""MCP clients: stdio, HTTP+SSE, and streamable-HTTP transports.

Mirrors reference agents/server_registry.py:18-234 (JSON-configured MCP
servers, env-var resolution, connect + aggregate tools into the agent tool
set; the reference connects stdio AND url/SSE servers via its MCP SDK,
server_registry.py:135-152). Implements the MCP JSON-RPC framings directly
(no ``mcp`` SDK in this environment):

* **stdio** — newline-delimited JSON over a subprocess pipe, matching
  mcp_servers/web_tools_server.py.
* **sse** (legacy HTTP+SSE, protocol 2024-11-05) — GET an event stream; the
  first ``endpoint`` event names the POST URL; responses arrive as
  ``message`` events on the stream.
* **http** / **streamable-http** (protocol 2025-03-26) — POST each JSON-RPC
  request to the MCP endpoint; the response is either ``application/json``
  or a per-request ``text/event-stream``; the ``Mcp-Session-Id`` header from
  ``initialize`` is echoed on subsequent requests.

Unknown transports surface as per-server errors in the load status (shown by
``GET /api/mcp-servers``) instead of being silently skipped.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from urllib.parse import urljoin

from tensortruth_tpu_torch.services.tool_service import ToolSpec

logger = logging.getLogger(__name__)

REQUEST_TIMEOUT = 30
PROTOCOL_VERSION = "2024-11-05"
CLIENT_INFO = {"name": "tensortruth-tpu", "version": "0.1.0"}

STDIO_TRANSPORTS = ("stdio",)
SSE_TRANSPORTS = ("sse",)
HTTP_TRANSPORTS = ("http", "streamable-http", "streamable_http")
SUPPORTED_TRANSPORTS = STDIO_TRANSPORTS + SSE_TRANSPORTS + HTTP_TRANSPORTS


def resolve_env(value: str) -> str:
    """${VAR} resolution in server configs (reference server_registry.py:18-47)."""
    import re

    return re.sub(
        r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}",
        lambda m: os.environ.get(m.group(1), m.group(0)),
        value,
    )


def validate_server_config(cfg: dict) -> str | None:
    """Config-level error for a server entry, or None if connectable.

    Pure validation (no I/O) so the /api/mcp-servers listing can flag a bad
    transport or missing url/command without attempting a connection."""
    transport = cfg.get("transport", "stdio")
    if transport not in SUPPORTED_TRANSPORTS:
        return (
            f"unsupported transport '{transport}' "
            f"(supported: {', '.join(SUPPORTED_TRANSPORTS)})"
        )
    if transport in STDIO_TRANSPORTS and not cfg.get("command"):
        return "stdio server has no command configured"
    if transport not in STDIO_TRANSPORTS and not cfg.get("url"):
        return f"{transport} server has no url configured"
    return None


class _MCPClientBase:
    """Transport-independent MCP surface: handshake, tools/list, tools/call."""

    name: str

    async def _request(self, method: str, params: dict | None = None) -> dict:
        raise NotImplementedError

    async def _notify(self, method: str, params: dict | None = None) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        raise NotImplementedError

    async def _handshake(self) -> None:
        await self._request("initialize", {
            "protocolVersion": PROTOCOL_VERSION,
            "clientInfo": dict(CLIENT_INFO),
            "capabilities": {},
        })
        # the MCP lifecycle REQUIRES this notification before normal
        # operations — SDK-built servers reject tools/list without it
        await self._notify("notifications/initialized")

    @staticmethod
    def _unwrap(resp: dict, label: str) -> dict:
        if "error" in resp:
            raise RuntimeError(f"MCP {label}: {resp['error']}")
        return resp.get("result", {})

    async def list_tools(self) -> list[dict]:
        return (await self._request("tools/list")).get("tools", [])

    async def call_tool(self, name: str, arguments: dict):
        result = await self._request(
            "tools/call", {"name": name, "arguments": arguments}
        )
        parts = result.get("content", [])
        text = "\n".join(p.get("text", "") for p in parts if p.get("type") == "text")
        if result.get("isError"):
            raise RuntimeError(text or "MCP tool error")
        return text


class MCPStdioClient(_MCPClientBase):
    """One connected stdio MCP server."""

    def __init__(self, name: str, command: str, args: list[str] | None = None,
                 env: dict | None = None):
        self.name = name
        self.command = resolve_env(command)
        self.args = [resolve_env(a) for a in (args or [])]
        self.env = {k: resolve_env(v) for k, v in (env or {}).items()}
        self._proc: asyncio.subprocess.Process | None = None
        self._id = 0
        self._lock = asyncio.Lock()

    async def connect(self) -> None:
        self._proc = await asyncio.create_subprocess_exec(
            self.command,
            *self.args,
            stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL,
            env={**os.environ, **self.env},
        )
        await self._handshake()

    async def _notify(self, method: str, params: dict | None = None) -> None:
        assert self._proc is not None and self._proc.stdin
        async with self._lock:
            msg = {"jsonrpc": "2.0", "method": method, "params": params or {}}
            self._proc.stdin.write((json.dumps(msg) + "\n").encode())
            await self._proc.stdin.drain()

    async def _request(self, method: str, params: dict | None = None) -> dict:
        assert self._proc is not None and self._proc.stdin and self._proc.stdout
        async with self._lock:
            self._id += 1
            req = {"jsonrpc": "2.0", "id": self._id, "method": method,
                   "params": params or {}}
            self._proc.stdin.write((json.dumps(req) + "\n").encode())
            await self._proc.stdin.drain()
            # read until OUR response id: servers may interleave
            # notifications (logging/progress) and, after an earlier
            # timeout, a stale response — both must be skipped or every
            # later call pairs with the wrong reply
            deadline = asyncio.get_running_loop().time() + REQUEST_TIMEOUT
            while True:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    raise TimeoutError(f"MCP {self.name}.{method} timed out")
                line = await asyncio.wait_for(
                    self._proc.stdout.readline(), remaining
                )
                if not line.strip():
                    continue
                try:
                    resp = json.loads(line)
                except json.JSONDecodeError:
                    continue  # non-protocol noise on stdout
                if resp.get("id") == self._id:
                    break
                # notification or stale response from a timed-out call
                logger.debug(
                    "MCP %s: skipping message id=%s (%s)",
                    self.name, resp.get("id"), resp.get("method", "response"),
                )
        return self._unwrap(resp, f"{self.name}.{method}")

    async def close(self) -> None:
        if self._proc is not None:
            if self._proc.stdin:
                self._proc.stdin.close()
            try:
                await asyncio.wait_for(self._proc.wait(), 5)
            except asyncio.TimeoutError:
                self._proc.kill()
            self._proc = None


async def _iter_sse_events(content):
    """Parse an SSE byte stream into (event_type, data) pairs."""
    event, data_lines = None, []
    async for raw in content:
        line = raw.decode("utf-8", "replace").rstrip("\r\n")
        if not line:
            if data_lines:
                yield (event or "message", "\n".join(data_lines))
            event, data_lines = None, []
        elif line.startswith(":"):
            continue  # SSE comment / keep-alive
        elif line.startswith("event:"):
            event = line[6:].strip()
        elif line.startswith("data:"):
            data_lines.append(line[5:].lstrip())


class MCPSSEClient(_MCPClientBase):
    """MCP over legacy HTTP+SSE: persistent GET stream + POSTed requests."""

    def __init__(self, name: str, url: str, headers: dict | None = None):
        self.name = name
        self.url = resolve_env(url)
        self.headers = {k: resolve_env(v) for k, v in (headers or {}).items()}
        self._session = None
        self._stream = None
        self._pump_task: asyncio.Task | None = None
        self._post_url: str | None = None
        self._endpoint_fut: asyncio.Future | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._id = 0

    async def connect(self) -> None:
        import aiohttp

        loop = asyncio.get_running_loop()
        self._endpoint_fut = loop.create_future()
        self._session = aiohttp.ClientSession()
        try:
            self._stream = await self._session.get(
                self.url,
                headers={"Accept": "text/event-stream", **self.headers},
                timeout=aiohttp.ClientTimeout(
                    total=None, sock_connect=REQUEST_TIMEOUT
                ),
            )
            self._stream.raise_for_status()
            self._pump_task = asyncio.create_task(self._pump())
            endpoint = await asyncio.wait_for(self._endpoint_fut, REQUEST_TIMEOUT)
            # endpoint may be absolute or server-relative
            self._post_url = urljoin(self.url, endpoint)
            await self._handshake()
        except BaseException:
            await self.close()
            raise

    async def _pump(self) -> None:
        why = "stream ended"
        try:
            async for event, data in _iter_sse_events(self._stream.content):
                if event == "endpoint":
                    if self._endpoint_fut and not self._endpoint_fut.done():
                        self._endpoint_fut.set_result(data)
                    continue
                try:
                    msg = json.loads(data)
                except json.JSONDecodeError:
                    continue
                fut = self._pending.pop(msg.get("id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(msg)
                # else: server notification (progress/log) — ignored
        except asyncio.CancelledError:
            raise  # close() cancelling us must not fail futures it will drop
        except Exception as e:
            why = str(e) or type(e).__name__
        finally:
            # Whether the stream died OR ended cleanly (server shutdown),
            # everything still waiting must fail NOW — otherwise each
            # in-flight request (and connect()'s endpoint wait) blocks the
            # full REQUEST_TIMEOUT before surfacing an unrelated timeout.
            err = RuntimeError(f"MCP {self.name} SSE stream closed: {why}")
            if self._endpoint_fut and not self._endpoint_fut.done():
                self._endpoint_fut.set_exception(err)
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()

    async def _post(self, payload: dict) -> None:
        import aiohttp

        assert self._session is not None and self._post_url
        async with self._session.post(
            self._post_url, json=payload,
            timeout=aiohttp.ClientTimeout(total=REQUEST_TIMEOUT),
        ) as r:
            if r.status >= 400:
                raise RuntimeError(
                    f"MCP {self.name}: POST {r.status} {await r.text()}"
                )

    async def _notify(self, method: str, params: dict | None = None) -> None:
        await self._post({"jsonrpc": "2.0", "method": method, "params": params or {}})

    async def _request(self, method: str, params: dict | None = None) -> dict:
        self._id += 1
        rid = self._id
        fut = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            await self._post({"jsonrpc": "2.0", "id": rid, "method": method,
                              "params": params or {}})
            resp = await asyncio.wait_for(fut, REQUEST_TIMEOUT)
        except asyncio.TimeoutError:
            raise TimeoutError(f"MCP {self.name}.{method} timed out")
        finally:
            self._pending.pop(rid, None)
        return self._unwrap(resp, f"{self.name}.{method}")

    async def close(self) -> None:
        if self._pump_task is not None:
            self._pump_task.cancel()
            try:
                await self._pump_task
            except (asyncio.CancelledError, Exception):
                pass
            self._pump_task = None
        if self._stream is not None:
            self._stream.close()
            self._stream = None
        if self._session is not None:
            await self._session.close()
            self._session = None


class MCPStreamableHTTPClient(_MCPClientBase):
    """MCP streamable-HTTP: one POST per request, json or SSE response."""

    def __init__(self, name: str, url: str, headers: dict | None = None):
        self.name = name
        self.url = resolve_env(url)
        self.headers = {k: resolve_env(v) for k, v in (headers or {}).items()}
        self._session = None
        self._session_id: str | None = None
        self._id = 0

    async def connect(self) -> None:
        import aiohttp

        self._session = aiohttp.ClientSession()
        try:
            await self._handshake()
        except BaseException:
            await self.close()
            raise

    def _headers(self) -> dict:
        h = {
            "Accept": "application/json, text/event-stream",
            "Content-Type": "application/json",
            **self.headers,
        }
        if self._session_id:
            h["Mcp-Session-Id"] = self._session_id
        return h

    async def _notify(self, method: str, params: dict | None = None) -> None:
        import aiohttp

        assert self._session is not None
        async with self._session.post(
            self.url,
            json={"jsonrpc": "2.0", "method": method, "params": params or {}},
            headers=self._headers(),
            timeout=aiohttp.ClientTimeout(total=REQUEST_TIMEOUT),
        ) as r:
            if r.status >= 400:
                raise RuntimeError(
                    f"MCP {self.name}: POST {r.status} {await r.text()}"
                )

    async def _request(self, method: str, params: dict | None = None) -> dict:
        import aiohttp

        assert self._session is not None
        self._id += 1
        rid = self._id
        async with self._session.post(
            self.url,
            json={"jsonrpc": "2.0", "id": rid, "method": method,
                  "params": params or {}},
            headers=self._headers(),
            timeout=aiohttp.ClientTimeout(total=REQUEST_TIMEOUT),
        ) as r:
            if r.status >= 400:
                raise RuntimeError(
                    f"MCP {self.name}.{method}: HTTP {r.status} {await r.text()}"
                )
            sid = r.headers.get("Mcp-Session-Id")
            if sid:
                self._session_id = sid
            if r.content_type == "text/event-stream":
                resp = None
                async for _, data in _iter_sse_events(r.content):
                    try:
                        msg = json.loads(data)
                    except json.JSONDecodeError:
                        continue
                    if msg.get("id") == rid:
                        resp = msg
                        break
                if resp is None:
                    raise RuntimeError(
                        f"MCP {self.name}.{method}: SSE response stream "
                        "ended without a reply"
                    )
            else:
                resp = await r.json(content_type=None)
        return self._unwrap(resp, f"{self.name}.{method}")

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None


def _make_client(cfg: dict) -> _MCPClientBase:
    """Client for a validated server config (see validate_server_config)."""
    transport = cfg.get("transport", "stdio")
    if transport in STDIO_TRANSPORTS:
        return MCPStdioClient(
            cfg["name"], cfg.get("command", ""), cfg.get("args"), cfg.get("env")
        )
    if transport in SSE_TRANSPORTS:
        return MCPSSEClient(cfg["name"], cfg["url"], cfg.get("headers"))
    return MCPStreamableHTTPClient(cfg["name"], cfg["url"], cfg.get("headers"))


async def load_mcp_tools(
    mcp_service,
) -> tuple[dict, list[_MCPClientBase], dict]:
    """Connect every enabled server; returns (name→ToolSpec, clients, status).

    Tool names are prefixed ``{server}__{tool}`` to avoid collisions
    (reference server_registry aggregation). Failures isolate per server and
    are RECORDED in the status map — an unsupported transport or a dead
    endpoint shows up in /api/mcp-servers instead of silently loading zero
    tools."""
    specs: dict[str, ToolSpec] = {}
    clients: list[_MCPClientBase] = []
    status: dict[str, dict] = {}
    for cfg in mcp_service.list_servers():
        name = cfg["name"]
        transport = cfg.get("transport", "stdio")
        if not cfg.get("enabled", True):
            status[name] = {"status": "disabled", "transport": transport}
            continue
        err = validate_server_config(cfg)
        if err:
            logger.warning("MCP server %s not connectable: %s", name, err)
            status[name] = {"status": "error", "transport": transport,
                            "error": err}
            continue
        client = _make_client(cfg)
        try:
            await client.connect()
            tools = await client.list_tools()
        except Exception as e:
            logger.warning("MCP server %s failed to connect: %s", name, e)
            status[name] = {"status": "error", "transport": transport,
                            "error": str(e)}
            await client.close()
            continue
        clients.append(client)
        status[name] = {"status": "connected", "transport": transport,
                        "n_tools": len(tools)}
        for tool in tools:
            qualified = f"{name}__{tool['name']}"

            def make_fn(c=client, n=tool["name"]):
                async def fn(**kwargs):
                    return await c.call_tool(n, kwargs)

                return fn

            specs[qualified] = ToolSpec(
                name=qualified,
                description=f"[MCP:{name}] {tool.get('description', '')}",
                parameters=tool.get("inputSchema", {"type": "object", "properties": {}}),
                fn=make_fn(),
                source="mcp",
            )
    return specs, clients, status
