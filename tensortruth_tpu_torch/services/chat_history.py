"""Immutable chat history + the history-building service.

Behavioral mirror of reference services/chat_history.py:24-200+:
tuple-backed immutable ``ChatHistory``; ``build_history`` with turn-based
limiting (a turn = user query + assistant response), hard cap 50 turns,
complete-turn invariant (never orphan an assistant message), validation-skip
of malformed messages, optional regex cleaning.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

from tensortruth_tpu_torch.app.history_cleaner import clean_history_content


@dataclass(frozen=True)
class ChatHistoryMessage:
    role: Literal["user", "assistant", "system"]
    content: str


@dataclass(frozen=True)
class ChatHistory:
    messages: tuple[ChatHistoryMessage, ...]

    @property
    def is_empty(self) -> bool:
        return len(self.messages) == 0

    def truncated(self, max_messages: int) -> "ChatHistory":
        if len(self.messages) <= max_messages:
            return ChatHistory(messages=self.messages)
        return ChatHistory(messages=self.messages[-max_messages:])

    def to_prompt_string(self) -> str:
        return "\n".join(f"{m.role}: {m.content}" for m in self.messages)

    def to_chat_messages(self) -> list[dict]:
        """Provider-API message dicts [{"role": ..., "content": ...}]."""
        return [{"role": m.role, "content": m.content} for m in self.messages]


class ChatHistoryService:
    MAX_HISTORY_TURNS = 50  # hard cap: 100 messages
    VALID_ROLES = {"user", "assistant", "system"}

    def __init__(self, config=None):
        self.config = config

    def build_history(
        self,
        session_messages: list[dict] | None,
        max_turns: int | None = None,
        apply_cleaning: bool | None = None,
    ) -> ChatHistory:
        if not session_messages or max_turns == 0:
            return ChatHistory(messages=())

        if max_turns is None:
            max_turns = (
                self.config.conversation.max_history_turns if self.config else 3
            )
        if max_turns <= 0:
            # config-resolved 0 means history OFF too — `valid[-0:]` below
            # would otherwise return the ENTIRE history
            return ChatHistory(messages=())
        max_turns = min(max_turns, self.MAX_HISTORY_TURNS)
        if apply_cleaning is None:
            apply_cleaning = bool(
                self.config and self.config.history_cleaning.enabled
            )
        cleaning_cfg = self.config.history_cleaning if self.config else None

        valid: list[ChatHistoryMessage] = []
        for msg in session_messages:
            if not isinstance(msg, dict):
                continue
            role, content = msg.get("role"), msg.get("content")
            if role not in self.VALID_ROLES or not isinstance(content, str):
                continue
            if apply_cleaning:
                content = clean_history_content(content, cleaning_cfg)
            if not content:
                continue
            valid.append(ChatHistoryMessage(role=role, content=content))

        # Turn-based limit with the complete-turn invariant: walk backwards,
        # counting completed (user, assistant) pairs; never start the window
        # on an assistant message.
        limit = max_turns * 2
        window = valid[-limit:] if len(valid) > limit else valid
        while window and window[0].role == "assistant":
            window = window[1:]
        return ChatHistory(messages=tuple(window))


_service: ChatHistoryService | None = None


def get_chat_history_service(config=None) -> ChatHistoryService:
    global _service
    if _service is None or config is not None:
        _service = ChatHistoryService(config)
    return _service
