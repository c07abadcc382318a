"""Regex-based history cleaning to cut prompt tokens without losing meaning.

Behavioral mirror of reference app_utils/history_cleaner.py:43-177: emoji
strip, configurable filler-phrase removal, inline-whitespace normalization
that preserves indentation, 3+-newline collapse; LRU-cached per
(content, config).
"""

from __future__ import annotations

import re
from functools import lru_cache

# Supplementary-plane + common symbol blocks where emoji live.
EMOJI_PATTERN = re.compile(
    "["
    "\U0001f000-\U0001faff"  # symbols, emoticons, transport, supplemental
    "☀-➿"  # misc symbols + dingbats
    "️"  # variation selector
    "]+",
    flags=re.UNICODE,
)


def _config_key(cfg) -> tuple:
    if cfg is None:
        from tensortruth_tpu_torch.app.config import DEFAULT_FILLER_PHRASES

        return (True, True, True, True, True, tuple(DEFAULT_FILLER_PHRASES))
    return (
        cfg.enabled,
        cfg.remove_emojis,
        cfg.remove_filler_phrases,
        cfg.normalize_whitespace,
        cfg.collapse_newlines,
        tuple(cfg.filler_phrases or ()),
    )


@lru_cache(maxsize=256)
def _clean_cached(content: str, key: tuple) -> str:
    enabled, emojis, fillers, whitespace, newlines, phrases = key
    if not enabled:
        return content
    out = content
    if emojis:
        out = EMOJI_PATTERN.sub("", out)
    if fillers:
        for pattern in phrases:
            try:
                out = re.sub(pattern, "", out, flags=re.MULTILINE)
            except re.error:
                pass  # user-supplied pattern may be invalid — skip it
    if whitespace:
        # collapse runs of inline spaces but keep leading indentation
        out = re.sub(r"(?<=\S) {2,}", " ", out)
    if newlines:
        out = re.sub(r"\n{3,}", "\n\n", out)
    return out.strip()


def clean_history_content(content: str, cfg=None) -> str:
    return _clean_cached(content, _config_key(cfg))
