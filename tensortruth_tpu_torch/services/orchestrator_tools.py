"""Service-backed orchestrator tools: MCP management + project ingestion.

Mirrors reference orchestrator_tool_wrappers.py:990-1620:

* ``list_mcp_servers`` / ``get_mcp_presets`` — read-only MCP registry views;
* ``manage_mcp_server`` — add/toggle/remove MCP servers, gated behind an
  inline user confirmation (ToolConfirmationService + the WS
  ``confirmation_request`` message);
* ``add_arxiv_paper`` — fetch an arXiv paper and index it into the current
  session/project scope.
"""

from __future__ import annotations

import asyncio
import json

from tensortruth_tpu_torch.services.tool_service import ToolSpec


def create_service_tools(services, session_id: str | None = None, emit=None) -> dict:
    """name → ToolSpec for tools that need the service container.

    ``emit`` is an async callable used to surface ``confirmation_request``
    events to the client mid-tool-call.
    """

    async def list_mcp_servers():
        return services.mcp_service.list_servers()

    async def get_mcp_presets():
        return services.mcp_service.get_presets()

    async def manage_mcp_server(action: str, name: str, config: dict | None = None):
        if action not in ("add", "remove", "toggle"):
            return f"ERROR: unknown action {action}"
        conf = services.confirmation_service.create(
            "manage_mcp_server",
            f"{action} MCP server '{name}'",
            {"action": action, "name": name, "config": config or {}},
        )
        if emit is not None:
            # action_type/details feed the client's ConfirmationCard
            # (reference orchestrator_tool_wrappers.py:990-1445 confirmation
            # payload + frontend ConfirmationCard.tsx MCP detail block)
            await emit(
                {
                    "type": "confirmation_request",
                    "confirmation_id": conf.id,
                    "tool": "manage_mcp_server",
                    "description": conf.description,
                    "action_type": {
                        "add": "mcp_add", "remove": "mcp_remove",
                        "toggle": "mcp_update",
                    }[action],
                    "title": name,
                    "details": {"action": action, "name": name,
                                "config": config or {}},
                }
            )
        decision = await services.confirmation_service.wait(conf.id)
        if decision != "approved":
            return "User rejected the MCP server change."
        if action == "add":
            services.mcp_service.add_server(name, config or {})
        elif action == "remove":
            services.mcp_service.delete_server(name)
        else:
            services.mcp_service.toggle_server(name)
        return f"MCP server '{name}' {action} done."

    async def add_arxiv_paper(arxiv_id: str):
        if session_id is None:
            return "ERROR: no session scope for ingestion"
        from tensortruth_tpu_torch.app.paths import get_session_dir

        scope = get_session_dir(session_id)

        def ingest():
            from tensortruth_tpu_torch.web.fetch import ArxivHandler

            title, md = ArxivHandler().fetch(f"https://arxiv.org/abs/{arxiv_id}")
            return services.document_service.add_text(
                scope, f"{arxiv_id}.md", md, {"arxiv_id": arxiv_id, "title": title}
            )

        result = await asyncio.to_thread(ingest)
        return json.dumps(result)

    specs = {
        "list_mcp_servers": ToolSpec(
            "list_mcp_servers", "List configured MCP servers.",
            {"type": "object", "properties": {}}, list_mcp_servers,
        ),
        "get_mcp_presets": ToolSpec(
            "get_mcp_presets", "List installable MCP server presets.",
            {"type": "object", "properties": {}}, get_mcp_presets,
        ),
        "manage_mcp_server": ToolSpec(
            "manage_mcp_server",
            "Add/remove/toggle an MCP server (requires user confirmation).",
            {
                "type": "object",
                "properties": {
                    "action": {"type": "string", "enum": ["add", "remove", "toggle"]},
                    "name": {"type": "string"},
                    "config": {"type": "object"},
                },
                "required": ["action", "name"],
            },
            manage_mcp_server,
        ),
        "add_arxiv_paper": ToolSpec(
            "add_arxiv_paper",
            "Download an arXiv paper and index it into this session's documents.",
            {
                "type": "object",
                "properties": {"arxiv_id": {"type": "string"}},
                "required": ["arxiv_id"],
            },
            add_arxiv_paper,
        ),
    }
    return specs
