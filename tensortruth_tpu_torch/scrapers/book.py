"""PDF book fetching with chapter/page splitting
(reference scrapers/book.py:21-449)."""

from __future__ import annotations

import logging
import re
from pathlib import Path

logger = logging.getLogger(__name__)

DEFAULT_PAGES_PER_CHUNK = 15


def _safe(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", name).strip("_")[:80]


def fetch_book(
    book_name: str,
    config: dict,
    output_base_dir: str | Path,
    pages_per_chunk: int = DEFAULT_PAGES_PER_CHUNK,
    converter: str | None = None,
) -> bool:
    """Download a book PDF and split to markdown chapters.

    Split strategy (reference scrapers/book.py:109-298): the embedded TOC's
    top-level chapters when the PDF has an outline (pure-python parse,
    utils/pdf.py extract_pdf_toc), with over-long chapters re-chunked at
    ``max_pages_per_chapter``; otherwise fixed page chunks (reference
    book.py:299, default 15 pages).
    """
    import requests

    output_dir = Path(output_base_dir) / f"book_{book_name}"
    output_dir.mkdir(parents=True, exist_ok=True)
    url = config.get("url") or config.get("pdf_url", "")
    try:
        r = requests.get(url, timeout=120, headers={"User-Agent": "Mozilla/5.0"})
        r.raise_for_status()
    except Exception as e:
        logger.error("book download failed %s: %s", url, e)
        return False
    return split_book_pdf(
        book_name, r.content, output_dir, config, pages_per_chunk,
        converter=converter,
    )


def split_book_pdf(
    book_name: str,
    data: bytes,
    output_dir: Path,
    config: dict | None = None,
    pages_per_chunk: int = DEFAULT_PAGES_PER_CHUNK,
    converter: str | None = None,
) -> bool:
    """Split PDF bytes into per-chapter markdown files (TOC-aware).

    ``converter`` picks the PDF→markdown quality tier (utils/pdf.py
    CONVERTERS; reference fetch_sources.py converter flag). Precedence:
    explicit arg > per-book ``config["converter"]`` > "auto"."""
    from tensortruth_tpu_torch.utils.pdf import (
        extract_pdf_pages,
        extract_pdf_toc,
        post_process_markdown,
        split_pages_by_toc,
        split_pages_into_chunks,
    )

    config = config or {}
    converter = converter or config.get("converter") or "auto"
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    pages = extract_pdf_pages(data, converter=converter)
    if not pages:
        logger.error("no extractable text in book %s", book_name)
        return False

    chapters: list[tuple[str, str]] = []
    if config.get("use_toc", True):
        toc = extract_pdf_toc(data)
        chapters = split_pages_by_toc(
            pages, toc, max_pages_per_chapter=config.get("max_pages_per_chapter")
        )
        if chapters:
            logger.info("book %s: TOC split into %d chapters", book_name, len(chapters))
    if not chapters:
        chunks = split_pages_into_chunks(
            pages, config.get("pages_per_chunk", pages_per_chunk)
        )
        chapters = [(f"chapter {i}", c) for i, c in enumerate(chunks, 1)]
    for i, (title, text) in enumerate(chapters, 1):
        out = output_dir / f"{i:02d}_{_safe(title)}_{_safe(book_name)}.md"
        out.write_text(
            f"# {title}\n\n" + post_process_markdown(text), encoding="utf-8"
        )
    logger.info("book %s: %d chapter files", book_name, len(chapters))
    return True


def fetch_book_category(
    books: dict, output_base_dir: str | Path, converter: str | None = None
) -> bool:
    ok = 0
    for name, config in books.items():
        if fetch_book(name, config, output_base_dir, converter=converter):
            ok += 1
    return ok > 0
