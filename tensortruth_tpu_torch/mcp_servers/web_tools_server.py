"""Standalone MCP stdio server exposing the built-in web tools.

Mirrors reference mcp_servers/web_tools_server.py:22+ (dogfooding: the same
search_web/fetch_page tools served over MCP). Implements the MCP JSON-RPC
stdio framing directly — the ``mcp`` SDK is not available in this
environment.
"""

from __future__ import annotations

import asyncio
import json
import sys

TOOLS = [
    {
        "name": "search_web",
        "description": "Search the web; returns titles, URLs, snippets.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "queries": {"type": "array", "items": {"type": "string"}},
                "max_results": {"type": "integer", "default": 10},
            },
            "required": ["queries"],
        },
    },
    {
        "name": "fetch_page",
        "description": "Download one web page as markdown.",
        "inputSchema": {
            "type": "object",
            "properties": {"url": {"type": "string"}},
            "required": ["url"],
        },
    },
]


async def _call_tool(name: str, args: dict):
    from tensortruth_tpu_torch.web.search import fetch_page_tool, search_web_tool

    if name == "search_web":
        return await search_web_tool(**args)
    if name == "fetch_page":
        return await fetch_page_tool(**args)
    raise ValueError(f"unknown tool {name}")


def _handle(req: dict) -> dict | None:
    method = req.get("method", "")
    rid = req.get("id")
    if method == "initialize":
        result = {
            "protocolVersion": "2024-11-05",
            "serverInfo": {"name": "tensortruth-tpu-web-tools", "version": "0.1.0"},
            "capabilities": {"tools": {}},
        }
    elif method == "tools/list":
        result = {"tools": TOOLS}
    elif method == "tools/call":
        params = req.get("params", {})
        try:
            out = asyncio.run(_call_tool(params.get("name", ""), params.get("arguments", {})))
            result = {"content": [{"type": "text", "text": json.dumps(out)}]}
        except Exception as e:
            result = {"content": [{"type": "text", "text": f"ERROR: {e}"}], "isError": True}
    elif method.startswith("notifications/"):
        return None
    else:
        return {"jsonrpc": "2.0", "id": rid,
                "error": {"code": -32601, "message": f"unknown method {method}"}}
    return {"jsonrpc": "2.0", "id": rid, "result": result}


def main() -> None:
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError:
            continue
        resp = _handle(req)
        if resp is not None:
            sys.stdout.write(json.dumps(resp) + "\n")
            sys.stdout.flush()


if __name__ == "__main__":
    main()
