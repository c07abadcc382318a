"""Unified source model shared by RAG retrieval and the web pipeline.

Mirrors the reference's ``SourceNode`` contract (reference core/source.py:12-127)
so downstream stages (ranking, synthesis, API schemas) are pipeline-agnostic.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from enum import Enum


class SourceStatus(str, Enum):
    SUCCESS = "success"
    FAILED = "failed"
    SKIPPED = "skipped"
    FILTERED = "filtered"


class SourceType(str, Enum):
    WEB = "web"
    PAPER = "paper"
    LIBRARY_DOC = "library_doc"
    UPLOADED_PDF = "uploaded_pdf"
    BOOK = "book"


@dataclass
class SourceNode:
    """One retrievable source unit flowing through ranking → synthesis."""

    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    title: str = ""
    type: SourceType = SourceType.LIBRARY_DOC
    status: SourceStatus = SourceStatus.SUCCESS
    url: str | None = None
    content: str = ""
    snippet: str = ""
    score: float | None = None
    error: str | None = None
    metadata: dict = field(default_factory=dict)

    def get_display_text(self) -> str:
        return self.content or self.snippet or self.title

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "title": self.title,
            "type": self.type.value,
            "status": self.status.value,
            "url": self.url,
            "content": self.content,
            "snippet": self.snippet,
            "score": None if self.score is None else float(self.score),
            "error": self.error,
            "metadata": self.metadata,
        }

    @classmethod
    def from_retrieved(cls, rn) -> "SourceNode":
        """Build from a retrieval-engine RetrievedNode."""
        md = dict(rn.node.metadata)
        md.setdefault("module", rn.module)
        md.setdefault("_source_index", rn.source_index)
        return cls(
            id=rn.node.node_id,
            title=md.get("title", md.get("filename", rn.module)),
            type=SourceType(md.get("source_type", SourceType.LIBRARY_DOC.value)),
            content=rn.node.text,
            score=float(rn.score),
            url=md.get("source_url"),
            metadata=md,
        )
