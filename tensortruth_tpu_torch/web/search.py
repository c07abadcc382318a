"""Web search: DDG query with backoff + async tool entry points.

Mirrors reference utils/web_search.py:546-614 (3-attempt exponential
backoff, cross-query dedup) and services/builtin_tools.py:27-511 (the async
implementations behind search_web / fetch_page / search_arxiv). The
``duckduckgo_search`` wheel is unavailable here, so the DDG HTML endpoint is
parsed directly with bs4.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass

logger = logging.getLogger(__name__)

DDG_HTML_URL = "https://html.duckduckgo.com/html/"


@dataclass
class SearchResult:
    title: str
    url: str
    snippet: str = ""
    score: float | None = None

    def to_dict(self) -> dict:
        return {
            "title": self.title,
            "url": self.url,
            "snippet": self.snippet,
            "score": self.score,
        }


def search_duckduckgo(
    query: str, max_results: int = 10, attempts: int = 3
) -> list[SearchResult]:
    """3-attempt exponential backoff (reference web_search.py:566-607)."""
    import requests
    from bs4 import BeautifulSoup

    last_err: Exception | None = None
    for attempt in range(attempts):
        try:
            r = requests.post(
                DDG_HTML_URL,
                data={"q": query},
                headers={"User-Agent": "Mozilla/5.0"},
                timeout=15,
            )
            r.raise_for_status()
            soup = BeautifulSoup(r.text, "html.parser")
            out = []
            for res in soup.select(".result")[:max_results]:
                a = res.select_one(".result__a")
                if a is None:
                    continue
                snippet_el = res.select_one(".result__snippet")
                out.append(
                    SearchResult(
                        title=a.get_text().strip(),
                        url=a.get("href", ""),
                        snippet=snippet_el.get_text().strip() if snippet_el else "",
                    )
                )
            return out
        except Exception as e:
            last_err = e
            wait = 2**attempt
            logger.warning("DDG attempt %d failed (%s); retry in %ds", attempt + 1, e, wait)
            time.sleep(wait)
    raise RuntimeError(f"web search unavailable: {last_err}")


def search_multi(queries: list[str], max_results: int = 10) -> list[SearchResult]:
    """Multi-query with URL dedup (reference builtin_tools.py search_web)."""
    seen: set[str] = set()
    merged: list[SearchResult] = []
    for q in queries:
        for res in search_duckduckgo(q, max_results):
            if res.url not in seen:
                seen.add(res.url)
                merged.append(res)
    return merged[: max_results * max(1, len(queries))]


def search_arxiv(query: str, max_results: int = 5) -> list[dict]:
    """arXiv API free-text search (reference builtin_tools.py search_arxiv)."""
    import xml.etree.ElementTree as ET

    import requests

    r = requests.get(
        "https://export.arxiv.org/api/query",
        params={
            "search_query": f"all:{query}",
            "max_results": max_results,
            "sortBy": "relevance",
        },
        timeout=20,
    )
    r.raise_for_status()
    ns = {"a": "http://www.w3.org/2005/Atom"}
    out = []
    for entry in ET.fromstring(r.text).findall("a:entry", ns):
        arxiv_id = (entry.findtext("a:id", "", ns) or "").rsplit("/", 1)[-1]
        out.append(
            {
                "arxiv_id": arxiv_id,
                "title": (entry.findtext("a:title", "", ns) or "").strip(),
                "summary": (entry.findtext("a:summary", "", ns) or "").strip()[:500],
                "authors": [
                    a.findtext("a:name", "", ns) for a in entry.findall("a:author", ns)
                ],
            }
        )
    return out


def fetch_arxiv_metadata(arxiv_id: str) -> dict:
    """Metadata for one paper by id via the arXiv API
    (reference utils/interactive.py wizard auto-fetch): {arxiv_id, title,
    authors, year, summary}; {} when unreachable/not found."""
    import xml.etree.ElementTree as ET

    import requests

    try:
        r = requests.get(
            "https://export.arxiv.org/api/query",
            params={"id_list": arxiv_id, "max_results": 1},
            timeout=20,
        )
        r.raise_for_status()
        ns = {"a": "http://www.w3.org/2005/Atom"}
        entry = ET.fromstring(r.text).find("a:entry", ns)
        if entry is None:
            return {}
        title = (entry.findtext("a:title", "", ns) or "").strip()
        if not title or title.lower() == "error":
            return {}
        published = entry.findtext("a:published", "", ns) or ""
        return {
            "arxiv_id": arxiv_id,
            "title": " ".join(title.split()),
            "authors": [
                a.findtext("a:name", "", ns) for a in entry.findall("a:author", ns)
            ],
            "year": published[:4],
            "summary": (entry.findtext("a:summary", "", ns) or "").strip()[:500],
        }
    except Exception as e:
        logger.debug("arXiv metadata fetch failed for %s: %s", arxiv_id, e)
        return {}


# -- async tool entry points (ToolService contract) -----------------------------


async def search_web_tool(queries: list[str], max_results: int = 10):
    results = await asyncio.to_thread(search_multi, list(queries), max_results)
    return [r.to_dict() for r in results]


async def fetch_page_tool(url: str):
    from tensortruth_tpu_torch.web.fetch import fetch_url_as_markdown

    title, markdown = await asyncio.to_thread(fetch_url_as_markdown, url)
    return {"title": title, "url": url, "markdown": markdown}


async def search_arxiv_tool(query: str, max_results: int = 5):
    return await asyncio.to_thread(search_arxiv, query, max_results)


_DISCOVER_LINKS_CACHE: tuple[float, bool] | None = None
_DISCOVER_LINKS_TTL = 30.0  # seconds; config edits pick up within one TTL


def _discover_links_default() -> bool:
    """Config default for link discovery, TTL-cached: load_config() is a
    disk read + full YAML parse, far too heavy per tool call in agent loops."""
    global _DISCOVER_LINKS_CACHE
    now = time.monotonic()
    if _DISCOVER_LINKS_CACHE is not None and now - _DISCOVER_LINKS_CACHE[0] < _DISCOVER_LINKS_TTL:
        return _DISCOVER_LINKS_CACHE[1]
    try:
        from tensortruth_tpu_torch.app.config import load_config

        value = load_config().web_search.discover_links
    except Exception:
        value = True
    _DISCOVER_LINKS_CACHE = (now, value)
    return value


async def fetch_pages_batch_tool(
    urls: list[str],
    max_chars_per_page: int = 4000,
    discover_links: bool | None = None,
):
    """Parallel page fetch with per-page link discovery
    (reference orchestrator_tool_wrappers.py:651-929).

    ``discover_links`` None = follow config web_search.discover_links;
    when on, each successful page carries its outbound links PLUS
    head-fetched metadata suggestions (web/links.py fetch_link_metadata)
    so the agent can decide which links to follow next.
    """
    from tensortruth_tpu_torch.web.fetch import fetch_url_as_markdown
    from tensortruth_tpu_torch.web.links import (
        extract_links_from_markdown,
        fetch_link_metadata,
        format_link_suggestions,
    )

    if discover_links is None:
        discover_links = _discover_links_default()

    fetched_set = set(urls)

    async def one(url: str):
        try:
            title, md = await asyncio.to_thread(fetch_url_as_markdown, url)
            out = {
                "url": url,
                "title": title,
                "markdown": md[:max_chars_per_page],
                "links": [],
                "status": "success",
            }
            if discover_links:
                links = extract_links_from_markdown(md, url, exclude_urls=fetched_set)
                out["links"] = [{"title": a, "url": u} for a, u in links]
            return out
        except Exception as e:
            return {"url": url, "status": "failed", "error": str(e)}

    results = await asyncio.gather(*(one(u) for u in urls))
    if discover_links:
        # ONE capped head-metadata pass over the union of discovered links
        # (not per page — per-page probing multiplied every batch fetch by
        # up to 8 extra GETs per URL): ≤ max_links extra requests per batch,
        # deduped, attached to the first successful page.
        seen: set[str] = set()
        union: list[tuple[str, str]] = []
        for r in results:
            for l in r.get("links", []):
                if l["url"] not in seen:
                    seen.add(l["url"])
                    union.append((l["title"], l["url"]))
        if union:
            metas = await fetch_link_metadata(union)
            suggestions = format_link_suggestions(metas)
            if suggestions:
                for r in results:
                    if r.get("status") == "success":
                        r["link_suggestions"] = suggestions
                        break
    return results


async def get_arxiv_paper_tool(arxiv_id: str):
    from tensortruth_tpu_torch.web.fetch import ArxivHandler

    handler = ArxivHandler()
    title, md = await asyncio.to_thread(
        handler.fetch, f"https://arxiv.org/abs/{arxiv_id}"
    )
    return {"arxiv_id": arxiv_id, "title": title, "markdown": md}
