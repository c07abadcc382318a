"""Library documentation scraping: parallel page download → markdown.

Mirrors reference scrapers/library.py:23-130 (default 20 workers, CSS
selector extraction, min-size filter, per-page status counts).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path
from typing import Callable

from tensortruth_tpu_torch.scrapers.common import process_url

logger = logging.getLogger(__name__)

DEFAULT_MAX_WORKERS = 20


def scrape_library(
    library_name: str,
    config: dict,
    output_base_dir: str | Path,
    max_workers: int = DEFAULT_MAX_WORKERS,
    min_size: int = 0,
    progress_callback: Callable[[int, int, int], None] | None = None,
) -> bool:
    doc_type = config.get("doc_type", config.get("type", "sphinx"))
    html_cleaner = None
    if doc_type == "doxygen":
        from tensortruth_tpu_torch.scrapers.doxygen import (
            clean_doxygen_html,
            fetch_doxygen_urls,
        )

        urls = fetch_doxygen_urls(config)
        # strip nav trees/breadcrumbs/tabs before markdown conversion —
        # otherwise every indexed page carries the chrome into the corpus
        html_cleaner = clean_doxygen_html
    else:
        from tensortruth_tpu_torch.scrapers.sphinx import fetch_inventory

        urls = fetch_inventory(config)
    if not urls:
        logger.error("no URLs found for %s", library_name)
        return False

    output_dir = Path(output_base_dir) / f"library_{library_name}"
    output_dir.mkdir(parents=True, exist_ok=True)
    selector = config.get("selector")

    counts = {"success": 0, "skipped": 0, "failed": 0}
    with ThreadPoolExecutor(max_workers=max_workers) as executor:
        futures = [
            executor.submit(
                process_url, url, output_dir, min_size, selector, html_cleaner
            )
            for url in urls
        ]
        for f in as_completed(futures):
            counts[f.result()] += 1
    logger.info(
        "%s: %d ok, %d skipped, %d failed",
        library_name, counts["success"], counts["skipped"], counts["failed"],
    )
    if progress_callback:
        progress_callback(counts["success"], counts["skipped"], counts["failed"])
    return counts["success"] > 0
