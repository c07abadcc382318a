"""`tensor-truth-tpu-docs` CLI — fetch documentation sources.

Mirrors reference fetch_sources.py:26-550: list/validate sources, add new
ones non-interactively, fetch libraries (sphinx/doxygen), paper categories
(arXiv) and books (PDF) into ``library_docs/``, updating ``sources.json``.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from tensortruth_tpu_torch.app.paths import get_library_docs_dir
from tensortruth_tpu_torch.app.sources import (
    list_all_modules,
    load_user_sources,
    save_user_sources,
)
from tensortruth_tpu_torch.utils.validation import validate_library_config, validate_sources

logger = logging.getLogger(__name__)


def cmd_list(sources: dict) -> int:
    for section in ("libraries", "papers", "books"):
        entries = sources.get(section, {})
        print(f"{section} ({len(entries)}):")
        for name in sorted(entries):
            print(f"  - {name}")
    return 0


def cmd_validate(sources: dict) -> int:
    """Reference exit-code semantics (utils/validation.py:253-263): schema
    errors fail; modules missing docs are incomplete, not an error."""
    report = validate_sources(sources, get_library_docs_dir())
    for e in report["errors"]:
        print(f"[ERR] {e}")
    for w in report["warnings"]:
        print(f"[WRN] {w}")
    for module, status in report["modules"].items():
        mark = "OK " if status["ok"] else "---"
        print(f"[{mark}] {module}" + (f" — {status['error']}" if status["error"] else ""))
    for d in report["orphaned_dirs"]:
        print(f"[???] orphaned docs dir: {d}")
    print(report["summary"])
    return 0 if report["ok"] else 1


def cmd_add(sources: dict, args) -> int:
    if not args.section or not args.name:
        # No positional args → guided wizard (reference fetch_sources.py
        # --add interactive flow, utils/interactive.py)
        from tensortruth_tpu_torch.utils.interactive import interactive_add

        interactive_add(sources_path=getattr(args, "sources_config", None))
        return 0
    section = args.section
    config = json.loads(args.config) if args.config else {}
    # Structured flags compose with/override --config JSON (reference
    # --type/--url/--arxiv-ids non-interactive add)
    if getattr(args, "url", None):
        key = "inventory_url" if section == "libraries" else "url"
        config.setdefault(key, args.url)
    if getattr(args, "type", None) and section == "libraries":
        config.setdefault("doc_type", args.type)
    if getattr(args, "arxiv_ids", None) and section == "papers":
        config.setdefault("papers", {})
        for pid in args.arxiv_ids:
            config["papers"].setdefault(pid, {})
    if section == "libraries":
        err = validate_library_config(config)
        if err:
            logger.error(err)
            return 1
    sources.setdefault(section, {})[args.name] = config
    save_user_sources(sources, getattr(args, "sources_config", None))
    print(f"added {section}/{args.name}")
    return 0


def cmd_fetch(sources: dict, args) -> int:
    docs_dir = (
        args.library_docs_dir if getattr(args, "library_docs_dir", None)
        else get_library_docs_dir()
    )
    targets = args.modules or list_all_modules(sources)
    ok = True
    for module in targets:
        if module in sources.get("libraries", {}):
            from tensortruth_tpu_torch.scrapers.library import scrape_library

            kwargs = {}
            if getattr(args, "workers", None):
                kwargs["max_workers"] = args.workers
            if getattr(args, "min_size", None):
                kwargs["min_size"] = args.min_size
            ok &= scrape_library(
                module, sources["libraries"][module], docs_dir, **kwargs
            )
        elif module in sources.get("papers", {}):
            from tensortruth_tpu_torch.scrapers.arxiv import fetch_paper_category

            ok &= fetch_paper_category(
                module, sources["papers"][module], docs_dir,
                converter=getattr(args, "converter", None),
            )
        elif module in sources.get("books", {}):
            from tensortruth_tpu_torch.scrapers.book import fetch_book

            kwargs = {}
            if getattr(args, "pages_per_chunk", None):
                kwargs["pages_per_chunk"] = args.pages_per_chunk
            cfg = dict(sources["books"][module])
            if getattr(args, "max_pages_per_chapter", None):
                cfg["max_pages_per_chapter"] = args.max_pages_per_chapter
            ok &= fetch_book(
                module, cfg, docs_dir,
                converter=getattr(args, "converter", None), **kwargs,
            )
        else:
            logger.error("unknown module: %s", module)
            ok = False
    return 0 if ok else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Fetch documentation sources")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("list")
    sub.add_parser("validate")
    p_add = sub.add_parser("add")
    p_add.add_argument(
        "section", nargs="?", choices=["libraries", "papers", "books"],
        help="omit section+name for the interactive wizard",
    )
    p_add.add_argument("name", nargs="?")
    p_add.add_argument("--config", help="JSON config for the source")
    p_add.add_argument("--url", help="library inventory url / book pdf url")
    p_add.add_argument(
        "--type", choices=["sphinx", "doxygen"], help="library doc type"
    )
    p_add.add_argument(
        "--arxiv-ids", nargs="+", help="paper ids for a papers category"
    )
    p_fetch = sub.add_parser("fetch")
    p_fetch.add_argument("--modules", nargs="*", help="default: all configured")
    p_fetch.add_argument(
        "--converter",
        choices=["auto", "marker", "pymupdf4llm", "pymupdf", "fallback"],
        default=None,
        help="PDF conversion quality tier for books/papers (reference "
        "fetch_sources converter flag): marker/pymupdf4llm when installed, "
        "pure-python fallback always available. Default: per-source config "
        "or auto-detect.",
    )
    p_fetch.add_argument("--workers", type=int, default=None,
                         help="parallel page downloads (libraries)")
    p_fetch.add_argument("--min-size", type=int, default=None,
                         help="skip pages smaller than this many chars")
    p_fetch.add_argument("--pages-per-chunk", type=int, default=None,
                         help="book fixed page-chunk size (no-TOC fallback)")
    p_fetch.add_argument("--max-pages-per-chapter", type=int, default=None,
                         help="re-chunk oversized TOC chapters")
    p_fetch.add_argument("--library-docs-dir", default=None)
    # On every subparser (not the main parser): argparse would reset a
    # main-parser value back to the subparser default when the flag
    # precedes the subcommand, and a main-only flag can't follow it.
    for p in (sub.choices["list"], sub.choices["validate"], p_add, p_fetch):
        p.add_argument("--sources-config", default=None)
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    sources = load_user_sources(getattr(args, "sources_config", None))
    if args.command == "list":
        return cmd_list(sources)
    if args.command == "validate":
        return cmd_validate(sources)
    if args.command == "add":
        return cmd_add(sources, args)
    return cmd_fetch(sources, args)


if __name__ == "__main__":
    sys.exit(main())
