"""Unified ranking stage over SourceNodes + confidence gating.

Copy of ``tensortruth_tpu/retrieval/ranking.py``: that package's ``__init__``
imports jax, so the port keeps its own copy; tests/unit/test_torch_retrieval.py
holds the two to the same outputs.

Behavioral mirror of the reference's reranker-agnostic ``RankingStage``
(reference core/ranking.py:16-171) plus the confidence-gating policy from the
query path (reference rag_service.py:393-419, rag_engine.py:718-726,
config_schema.py:99-100):

* soft cutoff (default 0.35) — best reranked score below it ⇒ LOW_CONFIDENCE
  prompt selection;
* hard cutoff (default 0.05) — nodes below it are dropped post-rerank;
* no sources at all ⇒ NO_SOURCES ("general knowledge fallback").

The device work (cross-encoder forward over pair batches) lives in
models/reranker.py; this stage is the host-side policy around it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

from tensortruth_tpu_torch.core.source import SourceNode, SourceStatus

DEFAULT_CONFIDENCE_CUTOFF = 0.35
DEFAULT_CONFIDENCE_CUTOFF_HARD = 0.05


class ConfidenceLevel(str, Enum):
    NORMAL = "normal"
    LOW = "low"
    NO_SOURCES = "no_sources"


@dataclass
class RankingResult:
    passed: list[SourceNode] = field(default_factory=list)
    filtered: list[SourceNode] = field(default_factory=list)
    scores: dict[str, float] = field(default_factory=dict)

    @property
    def all_sources(self) -> list[SourceNode]:
        return sorted(
            self.passed + self.filtered,
            key=lambda s: s.score if s.score is not None else 0.0,
            reverse=True,
        )


class RankingStage:
    """Rank SourceNodes with any reranker exposing
    ``rerank(query, docs, top_n) -> (order, scores)`` (models/reranker.py)."""

    def __init__(
        self,
        reranker=None,
        threshold: float = 0.0,
        text_extractor: Callable[[SourceNode], str] | None = None,
    ):
        self.reranker = reranker
        self.threshold = threshold
        self.text_extractor = text_extractor or (lambda s: s.get_display_text())

    def rank(
        self,
        items: list[SourceNode],
        query: str,
        custom_instructions: str | None = None,
        top_n: int | None = None,
    ) -> RankingResult:
        if not items:
            return RankingResult()
        if self.reranker is None:
            return self._passthrough(items)

        effective_query = query
        if custom_instructions:
            effective_query = f"{query}\n\nAdditional context: {custom_instructions}"

        texts = [self.text_extractor(i) for i in items]
        if all(not t for t in texts):
            return self._passthrough(items)

        limit = top_n if top_n is not None else len(items)
        order, scores_arr = self.reranker.rerank(effective_query, texts, limit)
        in_top = set(int(i) for i in order)

        scores: dict[str, float] = {}
        passed, filtered = [], []
        for i, src in enumerate(items):
            if i in in_top:
                score = float(scores_arr[i])
                src.score = score
                scores[src.id] = score
                if score >= self.threshold:
                    passed.append(src)
                else:
                    src.status = SourceStatus.FILTERED
                    filtered.append(src)
            else:
                src.status = SourceStatus.FILTERED
                src.score = 0.0
                scores[src.id] = 0.0
                filtered.append(src)

        key = lambda s: s.score if s.score is not None else 0.0
        passed.sort(key=key, reverse=True)
        filtered.sort(key=key, reverse=True)
        return RankingResult(passed=passed, filtered=filtered, scores=scores)

    def _passthrough(self, items: list[SourceNode]) -> RankingResult:
        scores = {i.id: i.score or 0.0 for i in items}
        passed, filtered = [], []
        for i in items:
            if (i.score if i.score is not None else 0.0) >= self.threshold:
                passed.append(i)
            else:
                i.status = SourceStatus.FILTERED
                filtered.append(i)
        return RankingResult(passed=passed, filtered=filtered, scores=scores)


def apply_confidence_gate(
    sources: list[SourceNode],
    cutoff: float = DEFAULT_CONFIDENCE_CUTOFF,
    cutoff_hard: float = DEFAULT_CONFIDENCE_CUTOFF_HARD,
) -> tuple[list[SourceNode], ConfidenceLevel]:
    """Post-rerank gating: drop below hard cutoff, classify confidence."""
    kept = [s for s in sources if (s.score or 0.0) >= cutoff_hard]
    if not kept:
        return [], ConfidenceLevel.NO_SOURCES
    best = max(s.score or 0.0 for s in kept)
    level = ConfidenceLevel.NORMAL if best >= cutoff else ConfidenceLevel.LOW
    return kept, level
