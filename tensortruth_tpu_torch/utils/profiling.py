"""Per-stage timing for the query pipeline.

SURVEY.md §5.1: the reference's observability is per-query RetrievalMetrics;
the engine adds stage-level wall timings (condense / embed / top-k / rerank)
attached to every query's metrics. The device trace that sits beside this in
the JAX package belongs to the server surface, which is not ported yet.
"""

from __future__ import annotations

import contextlib
import time


class StageTimer:
    """Collects stage → milliseconds for one query."""

    def __init__(self):
        self.timings_ms: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings_ms[name] = round(
                self.timings_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3, 2
            )

    def to_dict(self) -> dict:
        total = round(sum(self.timings_ms.values()), 2)
        return {**self.timings_ms, "total_ms": total}
