"""Core enums shared across the engine (reference core/types.py:10-43)."""

from __future__ import annotations

from enum import Enum


class SourcesSection(str, Enum):
    """Section names in sources.json."""

    LIBRARIES = "libraries"
    PAPERS = "papers"
    BOOKS = "books"


class DocType(str, Enum):
    """Documentation generator/format — determines the scraping strategy."""

    SPHINX = "sphinx"
    DOXYGEN = "doxygen"
    ARXIV = "arxiv"
    PDF_BOOK = "pdf_book"


class DocumentType(str, Enum):
    """Semantic content type — drives metadata extraction + index dir naming."""

    BOOK = "book"
    LIBRARY = "library"
    PAPERS = "papers"
