"""sources.json management (reference utils/sources_config.py:1-154).

Shape: {"libraries": {name: {...}}, "papers": {name: {...}},
"books": {name: {...}}}. Library entries carry url/doc_type/selector;
paper entries carry arXiv id lists; book entries carry pdf url + TOC opts.
"""

from __future__ import annotations

import json
from pathlib import Path

from tensortruth_tpu_torch.core.types import DocumentType, SourcesSection


def load_user_sources(path: str | Path | None = None) -> dict:
    from tensortruth_tpu_torch.app.paths import get_sources_config_path

    path = Path(path) if path else get_sources_config_path()
    if not path.exists():
        return {s.value: {} for s in SourcesSection}
    data = json.loads(path.read_text())
    for s in SourcesSection:
        data.setdefault(s.value, {})
    return data


def save_user_sources(sources: dict, path: str | Path | None = None) -> None:
    from tensortruth_tpu_torch.app.paths import get_sources_config_path

    path = Path(path) if path else get_sources_config_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(sources, indent=2, ensure_ascii=False))
    tmp.replace(path)


def get_document_type_for_module(sources: dict, module: str) -> DocumentType:
    """Section membership → semantic type (reference utils/metadata.py:412)."""
    if module in sources.get(SourcesSection.BOOKS.value, {}):
        return DocumentType.BOOK
    if module in sources.get(SourcesSection.PAPERS.value, {}):
        return DocumentType.PAPERS
    return DocumentType.LIBRARY


def module_docs_dirname(doc_type: DocumentType, module: str) -> str:
    """library_docs/{doc_type}_{module} directory name."""
    return f"{doc_type.value}_{module}"


def list_all_modules(sources: dict) -> list[str]:
    out: list[str] = []
    for s in SourcesSection:
        out.extend(sources.get(s.value, {}).keys())
    return out
