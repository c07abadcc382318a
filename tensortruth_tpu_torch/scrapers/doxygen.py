"""Doxygen HTML scraping (reference scrapers/doxygen.py:12-176)."""

from __future__ import annotations

import logging
import posixpath
import re

logger = logging.getLogger(__name__)

# Doxygen page families worth indexing (reference doxygen.py inventory).
PAGE_PATTERNS = re.compile(
    r"^(class|struct|namespace|group__|dir_|[a-z0-9_]+_8h)", re.IGNORECASE
)


def fetch_doxygen_urls(config: dict) -> list[str]:
    """Collect class/struct/namespace/group page URLs from the annotated
    index pages."""
    import requests
    from bs4 import BeautifulSoup

    doc_root = config["doc_root"].rstrip("/") + "/"
    urls: set[str] = set()
    for index_page in ("annotated.html", "namespaces.html", "modules.html", "files.html"):
        try:
            r = requests.get(doc_root + index_page, timeout=30)
            if not r.ok:
                continue
            soup = BeautifulSoup(r.text, "html.parser")
            for a in soup.find_all("a", href=True):
                href = a["href"].split("#")[0]
                if href.endswith(".html") and PAGE_PATTERNS.match(href):
                    urls.add(posixpath.join(doc_root, href))
        except Exception as e:
            logger.warning("doxygen index %s failed: %s", index_page, e)
    logger.info("found %d doxygen pages", len(urls))
    return sorted(urls)


def clean_doxygen_html(html: str) -> str:
    """Aggressive Doxygen noise strip (reference doxygen.py:78-176): nav
    trees, breadcrumbs, member tables duplicated in detail sections."""
    from bs4 import BeautifulSoup

    soup = BeautifulSoup(html, "html.parser")
    for selector in (
        "#top", "#nav-path", "#side-nav", ".navpath", ".tabs", ".tabs2",
        ".tabs3", ".header .summary", ".footer", "#MSearchBox",
    ):
        for node in soup.select(selector):
            node.decompose()
    contents = soup.select_one(".contents") or soup.body or soup
    return str(contents)
