"""Page fetching with domain handlers.

Mirrors the reference's fetch path (reference utils/web_search.py:785-903 +
utils/domain_handlers.py registry + arXiv/GitHub/Wikipedia handlers): a URL
is routed to the first matching ``ContentHandler``, falling back to generic
HTML→markdown. All network I/O raises cleanly offline.
"""

from __future__ import annotations

import logging
import re
from urllib.parse import urlparse

from tensortruth_tpu_torch.web.html2md import extract_title, html_to_markdown

logger = logging.getLogger(__name__)

BROWSER_HEADERS = {
    "User-Agent": (
        "Mozilla/5.0 (X11; Linux x86_64) AppleWebKit/537.36 (KHTML, like Gecko) "
        "Chrome/120.0 Safari/537.36"
    )
}
DEFAULT_TIMEOUT = 20


class ContentHandler:
    """Domain-specific fetcher (reference domain_handlers.py:17-129)."""

    def matches(self, url: str) -> bool:
        raise NotImplementedError

    def fetch(self, url: str) -> tuple[str, str]:
        """Returns (title, markdown)."""
        raise NotImplementedError


_HANDLERS: list[ContentHandler] = []


def register_handler(handler: ContentHandler) -> None:
    _HANDLERS.append(handler)


class ArxivHandler(ContentHandler):
    """abs/pdf links → abstract page text (reference utils/arxiv_handler.py)."""

    _RE = re.compile(r"arxiv\.org/(abs|pdf)/(?P<id>\d{4}\.\d{4,5})(v\d+)?")

    def matches(self, url: str) -> bool:
        return bool(self._RE.search(url))

    def fetch(self, url: str) -> tuple[str, str]:
        import requests

        arxiv_id = self._RE.search(url).group("id")
        r = requests.get(
            "https://export.arxiv.org/api/query",
            params={"id_list": arxiv_id},
            headers=BROWSER_HEADERS,
            timeout=DEFAULT_TIMEOUT,
        )
        r.raise_for_status()
        import xml.etree.ElementTree as ET

        ns = {"a": "http://www.w3.org/2005/Atom"}
        entry = ET.fromstring(r.text).find("a:entry", ns)
        if entry is None:
            return arxiv_id, ""
        title = (entry.findtext("a:title", "", ns) or "").strip()
        summary = (entry.findtext("a:summary", "", ns) or "").strip()
        authors = ", ".join(
            (a.findtext("a:name", "", ns) or "") for a in entry.findall("a:author", ns)
        )
        md = f"# {title}\n\n**Authors:** {authors}\n\n## Abstract\n\n{summary}\n"
        return title, md


class WikipediaHandler(ContentHandler):
    """REST summary+extract API (reference utils/wikipedia_handler.py)."""

    def matches(self, url: str) -> bool:
        return "wikipedia.org/wiki/" in url

    def fetch(self, url: str) -> tuple[str, str]:
        import requests

        parsed = urlparse(url)
        title = parsed.path.split("/wiki/")[-1]
        lang = parsed.netloc.split(".")[0]
        r = requests.get(
            f"https://{lang}.wikipedia.org/api/rest_v1/page/summary/{title}",
            headers=BROWSER_HEADERS,
            timeout=DEFAULT_TIMEOUT,
        )
        r.raise_for_status()
        data = r.json()
        return data.get("title", title), f"# {data.get('title', title)}\n\n{data.get('extract', '')}"


class GitHubHandler(ContentHandler):
    """repo → README via raw.githubusercontent (reference utils/github_handler.py)."""

    _RE = re.compile(r"github\.com/(?P<owner>[\w.-]+)/(?P<repo>[\w.-]+)/?$")

    def matches(self, url: str) -> bool:
        return bool(self._RE.search(url))

    def fetch(self, url: str) -> tuple[str, str]:
        import requests

        m = self._RE.search(url)
        owner, repo = m.group("owner"), m.group("repo")
        for branch in ("main", "master"):
            r = requests.get(
                f"https://raw.githubusercontent.com/{owner}/{repo}/{branch}/README.md",
                headers=BROWSER_HEADERS,
                timeout=DEFAULT_TIMEOUT,
            )
            if r.ok:
                return f"{owner}/{repo}", r.text
        return f"{owner}/{repo}", ""


class YouTubeHandler(ContentHandler):
    """Video transcript via the timedtext API (reference
    utils/youtube_handler.py; the youtube-transcript-api wheel is not
    available here, so the caption endpoint is called directly)."""

    _RE = re.compile(r"(?:youtube\.com/watch\?v=|youtu\.be/)([\w-]{11})")

    def matches(self, url: str) -> bool:
        return bool(self._RE.search(url))

    def fetch(self, url: str) -> tuple[str, str]:
        import requests
        import xml.etree.ElementTree as ET

        video_id = self._RE.search(url).group(1)
        r = requests.get(
            "https://www.youtube.com/api/timedtext",
            params={"v": video_id, "lang": "en"},
            headers=BROWSER_HEADERS,
            timeout=DEFAULT_TIMEOUT,
        )
        r.raise_for_status()
        if not r.text.strip():
            return video_id, ""
        lines = [
            (el.text or "").replace("&#39;", "'")
            for el in ET.fromstring(r.text).findall("text")
        ]
        return f"YouTube {video_id}", "\n".join(l for l in lines if l)


register_handler(ArxivHandler())
register_handler(WikipediaHandler())
register_handler(GitHubHandler())
register_handler(YouTubeHandler())


def fetch_generic_html(url: str) -> tuple[str, str]:
    import requests

    r = requests.get(url, headers=BROWSER_HEADERS, timeout=DEFAULT_TIMEOUT)
    r.raise_for_status()
    base = f"{urlparse(url).scheme}://{urlparse(url).netloc}"
    return extract_title(r.text), html_to_markdown(r.text, base_url=base)


def fetch_url_as_markdown(url: str) -> tuple[str, str]:
    """(title, markdown) via domain handler or generic conversion
    (reference scrapers/url_fetcher.py:19, web_search.py:874-903)."""
    for handler in _HANDLERS:
        if handler.matches(url):
            try:
                return handler.fetch(url)
            except Exception as e:
                logger.warning("handler %s failed for %s: %s", type(handler).__name__, url, e)
                break
    return fetch_generic_html(url)
