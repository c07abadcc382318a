"""Markdown link discovery for agent follow-up fetches.

Behavioral mirror of reference utils/web_search.py:1727-1830: after a page
is fetched, surface up to 15 promising outbound links (absolute, http(s),
non-boilerplate, deduplicated) and optionally fetch just the <head> of the
top candidates for title/description, so the orchestrator can decide what
to fetch next without reading whole pages.
"""

from __future__ import annotations

import asyncio
import logging
import re
from urllib.parse import urljoin, urlparse

logger = logging.getLogger(__name__)

_MD_LINK_RE = re.compile(r"\[([^\]]+)\]\(([^)\s]+)\)")
_BOILERPLATE_PATHS = re.compile(
    r"/(login|signin|signup|register|privacy|terms|cookie|about|contact|"
    r"careers|pricing|subscribe|newsletter|share|cart)\b",
    re.I,
)
_TITLE_RE = re.compile(r"<title[^>]*>(.*?)</title>", re.I | re.S)
_DESC_RE = re.compile(
    r'<meta[^>]+name=["\']description["\'][^>]+content=["\']([^"\']*)["\']',
    re.I,
)

MAX_LINKS = 15
HEAD_BYTES = 8192


def extract_links_from_markdown(
    markdown: str,
    base_url: str,
    exclude_urls: set[str] | None = None,
) -> list[tuple[str, str]]:
    """(anchor_text, absolute_url) candidates from fetched markdown."""
    exclude = exclude_urls or set()
    seen: set[str] = set()
    out: list[tuple[str, str]] = []
    for anchor, raw in _MD_LINK_RE.findall(markdown):
        if raw.startswith("#"):
            continue
        absolute = urljoin(base_url, raw.split("#")[0])
        parsed = urlparse(absolute)
        if parsed.scheme not in ("http", "https"):
            continue
        if absolute in exclude or absolute in seen:
            continue
        if _BOILERPLATE_PATHS.search(parsed.path):
            continue
        anchor = anchor.strip()
        if not anchor or len(anchor) > 200:
            continue
        seen.add(absolute)
        out.append((anchor, absolute))
        if len(out) >= MAX_LINKS:
            break
    return out


def _parse_head(html: str) -> tuple[str, str]:
    title = _TITLE_RE.search(html)
    desc = _DESC_RE.search(html)
    return (
        re.sub(r"\s+", " ", title.group(1)).strip() if title else "",
        re.sub(r"\s+", " ", desc.group(1)).strip() if desc else "",
    )


async def fetch_link_metadata(
    links: list[tuple[str, str]],
    max_links: int = 8,
    timeout: float = 5.0,
) -> list[dict]:
    """Fetch only the HTML <head> of candidate links, in parallel.

    Returns [{url, anchor_text, title, description, fetchable}].
    """
    import aiohttp

    candidates = links[:max_links]

    async def one(session, anchor: str, url: str) -> dict:
        meta = {
            "url": url, "anchor_text": anchor,
            "title": "", "description": "", "fetchable": False,
        }
        try:
            async with session.get(
                url, timeout=aiohttp.ClientTimeout(total=timeout)
            ) as resp:
                if resp.status != 200:
                    return meta
                buf = b""
                async for chunk in resp.content.iter_chunked(1024):
                    buf += chunk
                    if len(buf) >= HEAD_BYTES or b"</head>" in buf.lower():
                        break
                title, desc = _parse_head(buf.decode("utf-8", "ignore"))
                meta.update(title=title, description=desc, fetchable=True)
        except Exception as e:  # timeout/conn errors: just mark unfetchable
            logger.debug("link head fetch failed for %s: %s", url, e)
        return meta

    async with aiohttp.ClientSession(
        headers={"User-Agent": "Mozilla/5.0 (research-assistant)"}
    ) as session:
        return list(
            await asyncio.gather(*(one(session, a, u) for a, u in candidates))
        )


def format_link_suggestions(metas: list[dict]) -> str:
    """Human/agent-readable block appended to fetch results."""
    lines = []
    for m in metas:
        if not m.get("fetchable"):
            continue
        desc = f" — {m['description']}" if m.get("description") else ""
        lines.append(f"- [{m.get('title') or m['anchor_text']}]({m['url']}){desc}")
    if not lines:
        return ""
    return "\n\nDiscovered links (fetch with fetch_page if useful):\n" + "\n".join(lines)
