"""Pending tool-confirmation store with blocking wait.

Mirrors reference services/tool_confirmation_service.py:1-150: a tool
(e.g. manage_mcp_server) parks on a confirmation id; the UI approves/rejects
via REST; the waiting coroutine resumes with the decision.
"""

from __future__ import annotations

import asyncio
import uuid
from dataclasses import dataclass, field
from datetime import datetime, timezone


@dataclass
class PendingConfirmation:
    id: str
    tool_name: str
    description: str
    payload: dict = field(default_factory=dict)
    created_at: str = field(
        default_factory=lambda: datetime.now(timezone.utc).isoformat()
    )
    decision: str | None = None  # approved | rejected
    event: asyncio.Event = field(default_factory=asyncio.Event)

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "tool_name": self.tool_name,
            "description": self.description,
            "payload": self.payload,
            "created_at": self.created_at,
            "decision": self.decision,
        }


class ToolConfirmationService:
    def __init__(self):
        self._pending: dict[str, PendingConfirmation] = {}

    def create(self, tool_name: str, description: str, payload: dict | None = None) -> PendingConfirmation:
        conf = PendingConfirmation(
            id=uuid.uuid4().hex[:12],
            tool_name=tool_name,
            description=description,
            payload=payload or {},
        )
        self._pending[conf.id] = conf
        return conf

    def get(self, confirmation_id: str) -> PendingConfirmation | None:
        return self._pending.get(confirmation_id)

    async def wait(self, confirmation_id: str, timeout: float = 300.0) -> str:
        conf = self._pending[confirmation_id]
        try:
            await asyncio.wait_for(conf.event.wait(), timeout)
        except asyncio.TimeoutError:
            conf.decision = "rejected"
        return conf.decision or "rejected"

    def _decide(self, confirmation_id: str, decision: str) -> bool:
        conf = self._pending.get(confirmation_id)
        if conf is None or conf.decision is not None:
            return False
        conf.decision = decision
        conf.event.set()
        return True

    def approve(self, confirmation_id: str) -> bool:
        return self._decide(confirmation_id, "approved")

    def reject(self, confirmation_id: str) -> bool:
        return self._decide(confirmation_id, "rejected")
