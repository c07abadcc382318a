"""Shared page processing for library scrapers
(reference scrapers/common.py:34-139)."""

from __future__ import annotations

import logging
import re
from pathlib import Path
from urllib.parse import urlparse

logger = logging.getLogger(__name__)


def url_to_filename(url: str) -> str:
    """Stable flat filename from a doc URL (reference common.py)."""
    path = urlparse(url).path.strip("/")
    name = re.sub(r"[^A-Za-z0-9_.-]+", "_", path) or "index"
    if not name.endswith(".md"):
        name = re.sub(r"\.html?$", "", name) + ".md"
    return name[:200]


def process_url(url: str, output_dir: str | Path, min_size: int = 0,
                selector: str | None = None, html_cleaner=None) -> str:
    """Download one page → markdown file. Returns 'success'/'skipped'/'failed'.

    ``html_cleaner``: optional html→html pre-pass (e.g. the Doxygen noise
    strip) applied before selector/markdown conversion."""
    import requests

    from tensortruth_tpu_torch.web.html2md import html_to_markdown

    try:
        r = requests.get(url, timeout=30, headers={"User-Agent": "Mozilla/5.0"})
        r.raise_for_status()
        html = r.text
        if html_cleaner is not None:
            html = html_cleaner(html)
        if selector:
            from bs4 import BeautifulSoup

            node = BeautifulSoup(html, "html.parser").select_one(selector)
            if node is not None:
                html = str(node)
        base = f"{urlparse(url).scheme}://{urlparse(url).netloc}"
        md = html_to_markdown(html, base_url=base)
        if min_size and len(md) < min_size:
            return "skipped"
        out = Path(output_dir) / url_to_filename(url)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(md, encoding="utf-8")
        return "success"
    except Exception as e:
        logger.warning("failed %s: %s", url, e)
        return "failed"
