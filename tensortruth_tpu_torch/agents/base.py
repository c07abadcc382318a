"""Agent framework core (reference agents/base.py:9-39, agents/config.py).

An ``Agent`` consumes a task string + context and yields WS-style event
dicts (status/tool_progress/token/thinking/done). ``AgentResult`` carries
the final text + sources for persistence.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import AsyncIterator


@dataclass
class AgentResult:
    text: str = ""
    sources: list = field(default_factory=list)
    tool_steps: list = field(default_factory=list)
    error: str | None = None


class Agent:
    """ABC for agent implementations."""

    name: str = ""
    description: str = ""

    async def run(self, task: str, context: dict) -> AsyncIterator[dict]:
        raise NotImplementedError
        yield  # pragma: no cover
