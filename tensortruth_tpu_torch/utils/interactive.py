"""Interactive wizard for adding documentation sources.

Mirrors reference utils/interactive.py:1-661: guided add of
library/paper/book sources with prompts, arXiv id validation + API metadata
auto-fetch, and book PDF metadata extraction with confirm/override.
Network-dependent lookups degrade gracefully (the wizard still saves a
valid source entry offline).
"""

from __future__ import annotations

import json
import logging
import re

from tensortruth_tpu_torch.app.sources import load_user_sources, save_user_sources
from tensortruth_tpu_torch.utils.validation import validate_library_config

logger = logging.getLogger(__name__)

# new-style 2101.00001(vN) and old-style math.GT/0309136 identifiers
_ARXIV_NEW = re.compile(r"(\d{4}\.\d{4,5})(v\d+)?$")
_ARXIV_OLD = re.compile(r"([a-z-]+(?:\.[A-Z]{2})?/\d{7})(v\d+)?$", re.I)


def validate_arxiv_id(raw: str) -> str | None:
    """Normalize an arXiv id (strips URL prefixes and version); None if bad
    (reference utils/validation.py validate_arxiv_id contract)."""
    s = raw.strip()
    s = re.sub(r"^https?://arxiv\.org/(abs|pdf)/", "", s)
    s = re.sub(r"\.pdf$", "", s)
    for pat in (_ARXIV_NEW, _ARXIV_OLD):
        m = pat.match(s)
        if m:
            return m.group(1)
    return None


def sanitize_config_key(name: str) -> str:
    """sources.json keys double as directory names — keep them path-safe
    (reference utils/validation.py sanitize_config_key)."""
    key = re.sub(r"[^A-Za-z0-9._-]+", "_", name.strip()).strip("_.")
    return re.sub(r"_+", "_", key)[:80]


def _ask(prompt: str, default: str = "", input_fn=input) -> str:
    suffix = f" [{default}]" if default else ""
    value = input_fn(f"{prompt}{suffix}: ").strip()
    return value or default


def add_library_interactive(input_fn=input) -> tuple[str, dict]:
    name = sanitize_config_key(_ask("Library name (e.g. numpy_2.1)", input_fn=input_fn))
    doc_type = _ask("Doc type (sphinx/doxygen)", "sphinx", input_fn)
    config: dict = {"doc_type": doc_type}
    if doc_type == "sphinx":
        config["inventory_url"] = _ask("objects.inv URL", input_fn=input_fn)
        config["doc_root"] = _ask("Doc root URL (blank = derive)", input_fn=input_fn)
        if not config["doc_root"]:
            config.pop("doc_root")
    else:
        config["doc_root"] = _ask("Doxygen HTML root URL", input_fn=input_fn)
    selector = _ask("CSS content selector (blank = auto)", input_fn=input_fn)
    if selector:
        config["selector"] = selector
    err = validate_library_config(config)
    if err:
        raise ValueError(err)
    return name, config


def add_papers_interactive(input_fn=input, print_fn=print) -> tuple[str, dict]:
    """Paper category with per-id validation + arXiv API metadata
    (reference utils/interactive.py:407-530): ids may be pasted as a
    comma/space-separated batch or one per prompt; bad ids are rejected with
    a message instead of being saved."""
    category = sanitize_config_key(
        _ask("Paper category name (e.g. attention)", input_fn=input_fn)
    )
    papers: dict = {}
    while True:
        raw = _ask("arXiv id(s), comma/space separated (blank to finish)", input_fn=input_fn)
        if not raw:
            break
        for token in re.split(r"[\s,]+", raw):
            if not token:
                continue
            arxiv_id = validate_arxiv_id(token)
            if arxiv_id is None:
                print_fn(f"  ✗ not a valid arXiv id: {token}")
                continue
            meta: dict = {}
            try:  # auto-fetch title/authors/year (reference wizard behavior)
                from tensortruth_tpu_torch.web.search import fetch_arxiv_metadata

                fetched = fetch_arxiv_metadata(arxiv_id)
                if fetched:
                    meta = {
                        "title": fetched["title"],
                        "authors": fetched["authors"],
                        "year": fetched["year"],
                    }
                    print_fn(f"  ✓ {arxiv_id}: {fetched['title']} "
                             f"({fetched['year']}, {len(fetched['authors'])} authors)")
                else:
                    print_fn(f"  · {arxiv_id}: metadata unavailable (saved bare)")
            except Exception as e:
                logger.debug("arXiv lookup failed: %s", e)
                print_fn(f"  · {arxiv_id}: metadata unavailable (saved bare)")
            papers[arxiv_id] = meta
    return category, {"papers": papers}


def add_book_interactive(input_fn=input, print_fn=print) -> tuple[str, dict]:
    """Book add with PDF metadata extraction and confirm/override
    (reference utils/interactive.py:184-300): download, read the Info
    dictionary for title/authors, let the user override, derive the key
    from the confirmed title."""
    url = _ask("PDF URL", input_fn=input_fn)
    title, authors = "", []
    try:
        import requests

        from tensortruth_tpu_torch.utils.pdf import extract_pdf_metadata

        print_fn("downloading PDF to extract metadata…")
        r = requests.get(url, timeout=60, headers={"User-Agent": "Mozilla/5.0"})
        r.raise_for_status()
        md = extract_pdf_metadata(r.content)
        title, authors = md.get("title", ""), md.get("authors", [])
        if title:
            print_fn(f"  detected title: {title}")
        if authors:
            print_fn(f"  detected authors: {', '.join(authors)}")
    except Exception as e:
        logger.debug("book metadata extraction failed: %s", e)
        print_fn("  could not extract PDF metadata (offline or bad PDF)")

    title = _ask("Title", title or "", input_fn)
    authors_str = _ask("Authors (comma separated)", ", ".join(authors), input_fn)
    from tensortruth_tpu_torch.utils.pdf import generate_book_name

    name = sanitize_config_key(
        _ask("Book key", generate_book_name(title), input_fn)
    )
    config: dict = {"url": url}
    if title:
        config["title"] = title
    if authors_str.strip():
        config["authors"] = [a.strip() for a in authors_str.split(",") if a.strip()]
    pages = _ask("Pages per chunk (TOC chapters used when available)", "15", input_fn)
    config["pages_per_chunk"] = int(pages)
    return name, config


def interactive_add(input_fn=input, print_fn=print, sources_path=None) -> None:
    """Top-level wizard loop (reference fetch_sources interactive mode).

    ``sources_path`` overrides the sources.json location for both read and
    write (the CLI's --sources-config must reach the wizard too)."""
    section = _ask("Add what? (libraries/papers/books)", "libraries", input_fn)
    adders = {
        "libraries": lambda f: add_library_interactive(f),
        "papers": lambda f: add_papers_interactive(f, print_fn),
        "books": lambda f: add_book_interactive(f, print_fn),
    }
    if section not in adders:
        raise ValueError(f"unknown section {section}")
    name, config = adders[section](input_fn)
    sources = load_user_sources(sources_path)
    sources.setdefault(section, {})[name] = config
    save_user_sources(sources, sources_path)
    print_fn(f"saved {section}/{name}: {json.dumps(config)}")
