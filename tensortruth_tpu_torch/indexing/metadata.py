"""Index metadata, model-id resolution, and doc-type metadata extraction.

Covers the contracts of reference indexing/metadata.py (sanitize/resolve
model ids, enumerate models/modules, validity checks — the read/write of
``index_metadata.json`` itself lives in index/store.py) and the per-doc-type
extractors of reference utils/metadata.py (YAML headers, book chapters from
TOC filenames, arXiv entries from sources.json, library module URLs).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from tensortruth_tpu_torch.core.types import DocumentType
from tensortruth_tpu_torch.index.store import METADATA_FILE, VectorIndex, sanitize_model_id

__all__ = [
    "sanitize_model_id",
    "resolve_model_id",
    "list_available_models",
    "list_modules_for_model",
    "extract_metadata",
    "format_authors",
]


def resolve_model_id(sanitized: str, known_models: list[str]) -> str | None:
    """'bge-m3' → 'BAAI/bge-m3' given known ids (reference metadata.py:55-100)."""
    for model in known_models:
        if sanitize_model_id(model) == sanitized:
            return model
    return None


def list_available_models(base_indexes_dir: str | Path) -> list[str]:
    """Sanitized model ids that have at least one valid module index."""
    base = Path(base_indexes_dir)
    if not base.exists():
        return []
    return sorted(
        d.name
        for d in base.iterdir()
        if d.is_dir() and any((m / METADATA_FILE).exists() for m in d.iterdir() if m.is_dir())
    )


def list_modules_for_model(base_indexes_dir: str | Path, model_id: str) -> list[str]:
    """Valid module index dirs under indexes/{model}/ (reference :241-317)."""
    model_dir = Path(base_indexes_dir) / sanitize_model_id(model_id)
    if not model_dir.exists():
        return []
    return sorted(d.name for d in model_dir.iterdir() if VectorIndex.is_valid(d))


def read_index_metadata(index_dir: str | Path) -> dict | None:
    p = Path(index_dir) / METADATA_FILE
    if not p.exists():
        return None
    return json.loads(p.read_text())


# -- per-doc-type metadata extraction (reference utils/metadata.py) -----------

_YAML_HEADER_RE = re.compile(r"\A---\s*\n(.*?)\n---\s*\n", re.DOTALL)
# "chapter_3"/"ch3" anywhere, OR the leading index our own book scraper
# writes ("03_Linear_Algebra_book.md", scrapers/book.py split filenames).
# The leading-number form is bounded to 1-3 digits: scraper indices are
# small and zero-padded, while user files like "2024_annual_report.md"
# carry a year, not a chapter.
_CHAPTER_RE = re.compile(
    r"(?:^(\d{1,3})[_\-\s])|(?:(?:chapter|ch)[_\-\s]*(\d+))", re.IGNORECASE
)


def parse_yaml_header(text: str) -> dict:
    """Leading `--- ... ---` YAML block → dict (reference metadata.py YAML path)."""
    m = _YAML_HEADER_RE.match(text)
    if not m:
        return {}
    try:
        import yaml

        data = yaml.safe_load(m.group(1))
        return data if isinstance(data, dict) else {}
    except Exception:
        return {}


def format_authors(authors) -> str:
    """['A', 'B', 'C', 'D'] → 'A et al.' (reference metadata.py:366)."""
    if isinstance(authors, str):
        return authors
    if not authors:
        return ""
    if len(authors) <= 3:
        return ", ".join(authors)
    return f"{authors[0]} et al."


def extract_book_chapter_metadata(filename: str, module: str) -> dict:
    """Chapter number/title from TOC-split filenames
    (reference metadata.py:478)."""
    stem = Path(filename).stem
    meta = {"doc_type": DocumentType.BOOK.value, "book": module}
    m = _CHAPTER_RE.search(stem)
    if m:
        meta["chapter"] = int(m.group(1) or m.group(2))
    title = re.sub(r"^\d+[_\-\s]*", "", stem).replace("_", " ").replace("-", " ").strip()
    if title:
        meta["title"] = title
    return meta


def extract_arxiv_metadata_from_config(
    filename: str, module: str, sources: dict
) -> dict:
    """Title/authors/year from the papers section of sources.json
    (reference metadata.py:529)."""
    meta = {"doc_type": DocumentType.PAPERS.value, "category": module}
    papers = sources.get("papers", {}).get(module, {})
    entries = papers.get("papers", papers) if isinstance(papers, dict) else papers
    if isinstance(entries, list):  # bare id list is a valid sources.json shape
        entries = {str(i): None for i in entries}
    elif isinstance(entries, str):  # single bare id
        entries = {entries: None}
    elif not isinstance(entries, dict):  # any other scalar: no metadata
        entries = {}
    stem = Path(filename).stem
    for arxiv_id, info in (entries or {}).items():
        if str(arxiv_id).replace(".", "_") in stem or str(arxiv_id) in stem:
            if isinstance(info, dict):
                meta.update(
                    {
                        k: v
                        for k, v in {
                            "arxiv_id": arxiv_id,
                            "title": info.get("title"),
                            "authors": format_authors(info.get("authors")),
                            "year": info.get("year"),
                        }.items()
                        if v
                    }
                )
            else:
                meta["arxiv_id"] = str(arxiv_id)
            break
    return meta


def extract_library_module_metadata(filename: str, module: str, sources: dict) -> dict:
    """Per-module URL + doc format (reference metadata.py:604)."""
    lib = sources.get("libraries", {}).get(module, {})
    meta = {"doc_type": DocumentType.LIBRARY.value, "library": module}
    if isinstance(lib, dict):
        if lib.get("url"):
            meta["source_url"] = lib["url"]
        if lib.get("doc_type"):
            meta["doc_format"] = lib["doc_type"]
    return meta


LLM_METADATA_PROMPT = (
    "Extract the document's title and author names from the excerpt below.\n\n"
    "Rules:\n"
    "1. The title is the main article/chapter/paper title; join multi-line "
    "titles into one string and skip any journal name printed above it.\n"
    "2. Authors are PEOPLE only — never journals, publishers, conferences, "
    "institutions, or honorifics like 'Member, IEEE'. List every author.\n"
    "3. Use null when a field cannot be determined.\n"
    "4. Reply with ONLY this JSON, nothing else:\n"
    '{"title": "string or null", "authors": "string or null"}\n\n'
    "Excerpt:\n---\n{excerpt}\n---"
)


def extract_metadata_with_llm(text: str, llm, max_chars: int = 3000) -> dict:
    """LLM title/author extraction for uploads (reference utils/metadata.py:158).

    ``llm`` needs ``complete(prompt) -> str``; any failure returns {} so
    ingestion never blocks on a provider.
    """
    import json as _json
    import re as _re

    prompt = LLM_METADATA_PROMPT.replace("{excerpt}", text[:max_chars])
    try:
        raw = llm.complete(prompt)
        m = _re.search(r"\{.*\}", raw, _re.DOTALL)
        if not m:
            return {}
        data = _json.loads(m.group(0))
        out = {}
        if data.get("title"):
            out["title"] = str(data["title"])
        if data.get("authors"):
            out["authors"] = format_authors(
                [a.strip() for a in str(data["authors"]).split(",")]
            )
        return out
    except Exception:
        return {}


def extract_metadata(
    text: str, filename: str, module: str, document_type: DocumentType, sources: dict
) -> dict:
    """Dispatch per document type, YAML header wins on conflicts
    (reference builder.py:155, utils/metadata.py)."""
    if document_type is DocumentType.BOOK:
        meta = extract_book_chapter_metadata(filename, module)
    elif document_type is DocumentType.PAPERS:
        meta = extract_arxiv_metadata_from_config(filename, module, sources)
    else:
        meta = extract_library_module_metadata(filename, module, sources)
    meta["filename"] = Path(filename).name
    meta.update(parse_yaml_header(text))
    return meta
