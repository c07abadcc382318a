"""Built-in tool registry for the orchestrator and /tool commands.

Mirrors reference services/tool_service.py:40-317 + builtin_tools.py: a
registry of named async tools with JSON-schema params. Network-dependent
tools (web search, page fetch, arXiv) are registered always and fail with a
clear error when offline.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Awaitable, Callable

logger = logging.getLogger(__name__)


@dataclass
class ToolSpec:
    name: str
    description: str
    parameters: dict  # JSON schema
    fn: Callable[..., Awaitable[object]]
    source: str = "builtin"  # builtin | mcp | extension
    # An exception from ``fn`` leaves the agent instead of becoming an
    # "ERROR: ..." tool result.
    propagate_errors: bool = False

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "parameters": self.parameters,
            "source": self.source,
        }


class ToolService:
    def __init__(self, config=None):
        self.config = config
        self._tools: dict[str, ToolSpec] = {}
        self.load_tools()

    @property
    def tools(self) -> dict[str, ToolSpec]:
        return self._tools

    def register(self, spec: ToolSpec) -> None:
        self._tools[spec.name] = spec

    def unregister(self, name: str) -> None:
        self._tools.pop(name, None)

    def load_tools(self) -> None:
        """Built-ins (reference tool_service.py:40-219)."""
        from tensortruth_tpu_torch.web.search import (
            fetch_page_tool,
            fetch_pages_batch_tool,
            get_arxiv_paper_tool,
            search_arxiv_tool,
            search_web_tool,
        )

        self._tools.clear()
        self.register(
            ToolSpec(
                name="search_web",
                description=(
                    "Search the web (multi-query supported); returns titles, "
                    "URLs and snippets."
                ),
                parameters={
                    "type": "object",
                    "properties": {
                        "queries": {"type": "array", "items": {"type": "string"}},
                        "max_results": {"type": "integer", "default": 10},
                    },
                    "required": ["queries"],
                },
                fn=search_web_tool,
            )
        )
        self.register(
            ToolSpec(
                name="fetch_page",
                description="Download one web page and return it as markdown.",
                parameters={
                    "type": "object",
                    "properties": {"url": {"type": "string"}},
                    "required": ["url"],
                },
                fn=fetch_page_tool,
            )
        )
        self.register(
            ToolSpec(
                name="fetch_pages_batch",
                description=(
                    "Download several pages at once; returns markdown excerpts "
                    "plus links discovered in each page for follow-up fetches."
                ),
                parameters={
                    "type": "object",
                    "properties": {
                        "urls": {"type": "array", "items": {"type": "string"}},
                        "max_chars_per_page": {"type": "integer", "default": 4000},
                    },
                    "required": ["urls"],
                },
                fn=fetch_pages_batch_tool,
            )
        )
        self.register(
            ToolSpec(
                name="search_arxiv",
                description="Search arXiv for papers by free-text query.",
                parameters={
                    "type": "object",
                    "properties": {
                        "query": {"type": "string"},
                        "max_results": {"type": "integer", "default": 5},
                    },
                    "required": ["query"],
                },
                fn=search_arxiv_tool,
            )
        )
        self.register(
            ToolSpec(
                name="get_arxiv_paper",
                description="Fetch one arXiv paper's title/authors/abstract by id.",
                parameters={
                    "type": "object",
                    "properties": {"arxiv_id": {"type": "string"}},
                    "required": ["arxiv_id"],
                },
                fn=get_arxiv_paper_tool,
            )
        )

    async def execute_tool(self, name: str, **kwargs):
        tool = self._tools.get(name)
        if tool is None:
            raise KeyError(f"unknown tool: {name}")
        return await tool.fn(**kwargs)

    def list_tools(self) -> list[dict]:
        return [t.to_dict() for t in self._tools.values()]
