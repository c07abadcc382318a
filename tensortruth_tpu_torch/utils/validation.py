"""sources.json schema + filesystem consistency checks
(reference utils/validation.py:1-394).

Three layers, each with actionable messages:

1. **Per-entry schema** (`validate_entry`): every section has a typed shape
   — libraries need a scraper-resolvable doc root, papers need well-formed
   arXiv ids, books need a PDF URL and sane split options. Errors block a
   build; warnings flag drift (deprecated fields, missing version pins).
2. **Whole-config sweep** (`validate_sources_schema`): runs layer 1 over
   every entry and cross-checks section-level invariants (duplicate module
   names across sections shadow each other in ``list_all_modules``).
3. **Config ↔ filesystem** (`validate_sources`): which configured modules
   actually have docs on disk, which doc dirs are orphaned, and whether the
   whole tree is buildable — the report the CLI prints before a build.
"""

from __future__ import annotations

import re
from pathlib import Path

from tensortruth_tpu_torch.app.sources import (
    get_document_type_for_module,
    list_all_modules,
    module_docs_dirname,
)

# http(s)://host[:port][/path] — format-only; reachability is a separate,
# network-gated concern (validate_url(check_reachable=True)).
_URL_RE = re.compile(
    r"^https?://"
    r"(?:[A-Za-z0-9](?:[A-Za-z0-9-]{0,61}[A-Za-z0-9])?"
    r"(?:\.[A-Za-z0-9](?:[A-Za-z0-9-]{0,61}[A-Za-z0-9])?)*"
    r"|localhost"
    r"|\d{1,3}(?:\.\d{1,3}){3})"
    r"(?::\d+)?"
    r"(?:[/?#]\S*)?$"
)

_LIBRARY_DOC_TYPES = ("sphinx", "doxygen")
_BOOK_SPLIT_METHODS = ("toc", "pages")


def validate_url_format(url: str) -> bool:
    """Format-only URL check (reference validate_url's regex layer)."""
    return bool(isinstance(url, str) and _URL_RE.match(url.strip()))


def validate_url(url: str, check_reachable: bool = False, timeout: int = 10) -> bool:
    """Format check, optionally followed by a HEAD-then-GET reachability
    probe (reference utils/validation.py:266-303). Reachability is opt-in:
    validation must work offline and never block a build on a flaky net."""
    if not validate_url_format(url):
        return False
    if not check_reachable:
        return True
    try:
        import requests

        try:
            r = requests.head(url, timeout=timeout, allow_redirects=True)
            if r.status_code < 400:
                return True
            # HEAD-rejecting servers (405/403 on S3 presigns, some CDNs)
            # still answer GET — fall through, honoring the HEAD-then-GET
            # contract for non-2xx just like for raised errors
        except Exception:
            pass
        r = requests.get(url, timeout=timeout, allow_redirects=True)
        return r.status_code < 400
    except Exception:
        return False


def _check_url_field(cfg: dict, field: str, where: str, errors: list[str]) -> None:
    val = cfg.get(field)
    if val is not None and not validate_url_format(str(val)):
        errors.append(
            f"{where}: '{field}' is not a valid http(s) URL: {val!r}"
        )


def validate_entry(section: str, name: str, cfg) -> tuple[list[str], list[str]]:
    """Per-type shape check for one sources.json entry.

    Returns ``(errors, warnings)`` with ``section.name:``-prefixed messages
    that say what to fix (reference validate_sources' schema pass,
    utils/validation.py:85-152, adapted to THIS repo's entry shapes — the
    fields the scrapers actually read: scrapers/{sphinx,doxygen,library,
    arxiv,book}.py)."""
    from tensortruth_tpu_torch.utils.interactive import validate_arxiv_id

    where = f"{section}.{name}"
    errors: list[str] = []
    warnings: list[str] = []
    if not isinstance(cfg, dict):
        return [f"{where}: entry must be an object, got {type(cfg).__name__}"], []

    if section == "libraries":
        if "type" in cfg and "doc_type" not in cfg:
            warnings.append(
                f"{where}: 'type' is deprecated — rename it to 'doc_type'"
            )
        doc_type = cfg.get("doc_type", cfg.get("type", "sphinx"))
        if doc_type not in _LIBRARY_DOC_TYPES:
            errors.append(
                f"{where}: unknown doc_type {doc_type!r} "
                f"(expected one of {', '.join(_LIBRARY_DOC_TYPES)})"
            )
        elif doc_type == "sphinx":
            if not cfg.get("inventory_url"):
                errors.append(
                    f"{where}: sphinx library needs 'inventory_url' "
                    "(the objects.inv URL)"
                )
        elif not cfg.get("doc_root"):
            errors.append(f"{where}: doxygen library needs 'doc_root'")
        for field in ("inventory_url", "doc_root", "url"):
            _check_url_field(cfg, field, where, errors)
        if not cfg.get("version"):
            warnings.append(
                f"{where}: no 'version' pin — rebuilt indexes may silently "
                "track a different docs release"
            )

    elif section == "papers":
        papers = cfg.get("papers", cfg)
        if isinstance(papers, dict):
            ids = [k for k in papers.keys() if k not in ("converter", "papers")]
        elif isinstance(papers, (list, tuple)):
            ids = [str(x) for x in papers]
        else:
            return [f"{where}: 'papers' must be a list or map of arXiv ids"], []
        if not ids:
            warnings.append(f"{where}: empty category (no papers)")
        for pid in ids:
            if validate_arxiv_id(str(pid)) is None:
                errors.append(
                    f"{where}: {pid!r} is not a valid arXiv id "
                    "(expected NNNN.NNNNN or archive/NNNNNNN)"
                )
        _validate_converter(cfg, where, errors)

    elif section == "books":
        url = cfg.get("url") or cfg.get("pdf_url")
        if not url:
            errors.append(f"{where}: book needs 'url' (the PDF to download)")
        for field in ("url", "pdf_url"):
            _check_url_field(cfg, field, where, errors)
        if "use_toc" in cfg and not isinstance(cfg["use_toc"], bool):
            errors.append(f"{where}: 'use_toc' must be true/false")
        for field in ("pages_per_chunk", "max_pages_per_chapter"):
            v = cfg.get(field)
            if v is not None and (not isinstance(v, int) or v <= 0):
                errors.append(f"{where}: '{field}' must be a positive integer")
        if cfg.get("split_method") not in (None, *_BOOK_SPLIT_METHODS):
            errors.append(
                f"{where}: unknown split_method {cfg['split_method']!r} "
                f"(expected {', '.join(_BOOK_SPLIT_METHODS)})"
            )
        _validate_converter(cfg, where, errors)

    return errors, warnings


def _validate_converter(cfg: dict, where: str, errors: list[str]) -> None:
    conv = cfg.get("converter")
    if conv is None:
        return
    from tensortruth_tpu_torch.utils.pdf import CONVERTERS

    if conv not in CONVERTERS:
        errors.append(
            f"{where}: unknown converter {conv!r} "
            f"(expected one of {', '.join(CONVERTERS)})"
        )


def validate_sources_schema(sources: dict) -> dict:
    """Whole-config schema sweep: per-entry checks + cross-section
    invariants. Returns {"errors": [...], "warnings": [...]}."""
    errors: list[str] = []
    warnings: list[str] = []
    seen: dict[str, str] = {}
    for section in ("libraries", "papers", "books"):
        entries = sources.get(section, {})
        if not isinstance(entries, dict):
            errors.append(f"{section}: section must be an object")
            continue
        for name, cfg in entries.items():
            e, w = validate_entry(section, name, cfg)
            errors.extend(e)
            warnings.extend(w)
            if name in seen:
                errors.append(
                    f"{section}.{name}: duplicate module name (also in "
                    f"{seen[name]}) — section lookups shadow each other"
                )
            else:
                seen[name] = section
    return {"errors": errors, "warnings": warnings}


def validate_module_for_build(module: str, sources: dict, docs_dir: str | Path) -> str | None:
    """Error string or None (pre-build validation)."""
    if module not in list_all_modules(sources):
        return f"module '{module}' not found in sources.json"
    doc_type = get_document_type_for_module(sources, module)
    mod_dir = Path(docs_dir) / module_docs_dirname(doc_type, module)
    if not mod_dir.exists():
        return f"docs directory missing: {mod_dir} (run tensor-truth-tpu-docs first)"
    if not any(mod_dir.rglob("*.md")) and not any(mod_dir.rglob("*.txt")):
        return f"docs directory empty: {mod_dir}"
    return None


def validate_sources(sources: dict, docs_dir: str | Path) -> dict:
    """Full report: schema errors/warnings, per-module build status, and
    orphaned doc dirs (reference validate_sources, utils/validation.py:52-263).

    ``ok`` follows the reference's exit-code semantics: schema ERRORS fail
    validation; missing docs are "incomplete", not an error (the fix is to
    fetch, not to edit config)."""
    docs_dir = Path(docs_dir)
    schema = validate_sources_schema(sources)
    report = {
        "modules": {},
        "orphaned_dirs": [],
        "errors": schema["errors"],
        "warnings": list(schema["warnings"]),
    }
    for module in list_all_modules(sources):
        err = validate_module_for_build(module, sources, docs_dir)
        report["modules"][module] = {"ok": err is None, "error": err}
    known = {
        module_docs_dirname(get_document_type_for_module(sources, m), m)
        for m in list_all_modules(sources)
    }
    if docs_dir.exists():
        for d in docs_dir.iterdir():
            if d.is_dir() and d.name not in known and not d.name.startswith("."):
                report["orphaned_dirs"].append(d.name)
    else:
        report["warnings"].append(f"docs directory does not exist: {docs_dir}")
    n_found = sum(1 for m in report["modules"].values() if m["ok"])
    report["ok"] = not report["errors"]
    report["summary"] = (
        f"{len(report['errors'])} error(s), {len(report['warnings'])} "
        f"warning(s); {n_found}/{len(report['modules'])} sources have docs "
        "on disk"
    )
    return report


def validate_library_config(config: dict) -> str | None:
    """First blocking error for one library entry, or None — the compact
    pre-add check the wizard and CLI use (full taxonomy: validate_entry)."""
    errors, _ = validate_entry("libraries", config.get("name", "<new>"), config)
    return errors[0] if errors else None
