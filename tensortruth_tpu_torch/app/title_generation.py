"""Smart session-title generation (reference app_utils/title_generation.py:1-327).

LLM-based title from the first exchange, with a deterministic heuristic
fallback whenever no provider is reachable (this environment, tests).
"""

from __future__ import annotations

import logging
import re

logger = logging.getLogger(__name__)

TITLE_PROMPT = (
    "Write a 3-6 word title for a chat that starts with this message. "
    "Output only the title, no quotes or punctuation at the end.\n\n"
    "Message: {message}"
)

MAX_TITLE_LEN = 48


def heuristic_title(prompt: str, max_len: int = MAX_TITLE_LEN) -> str:
    title = re.sub(r"\s+", " ", prompt).strip()
    title = re.sub(r"^/\w+\s*", "", title)  # strip slash command
    if len(title) > max_len:
        title = title[: max_len - 1] + "…"
    return title or "New Session"


def generate_smart_title(prompt: str, llm=None, max_len: int = MAX_TITLE_LEN) -> str:
    if llm is not None:
        try:
            raw = llm.complete(TITLE_PROMPT.format(message=prompt[:500])).strip()
            raw = raw.splitlines()[0].strip().strip("\"'") if raw else ""
            if 0 < len(raw) <= max_len * 2:
                return raw[:max_len]
        except Exception as e:
            logger.debug("LLM title failed (%s); heuristic fallback", e)
    return heuristic_title(prompt, max_len)
