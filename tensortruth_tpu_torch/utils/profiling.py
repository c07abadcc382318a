"""Per-stage timing + device tracing for the query pipeline.

SURVEY.md §5.1: the reference's observability is per-query RetrievalMetrics;
the engine adds stage-level wall timings (condense / embed / top-k / rerank)
attached to every query's metrics, and optional ``torch.profiler`` traces
(host ops and the card's kernels, written as Chrome traces) for deep dives.
"""

from __future__ import annotations

import contextlib
import os
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


# The process's one running trace (torch.profiler allows one at a time):
# {"profile": the profiler, "log_dir": where stop_trace writes it}.
_active: dict = {}


def start_trace(log_dir: str, cuda: bool) -> None:
    """Start a torch.profiler trace of every thread's host ops and, with
    ``cuda``, the card's kernels. Raises if one is running."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    if _active:
        raise RuntimeError("a trace is already running")
    # Every thread's host ops: the server runs its queries on executor threads.
    prof = profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    _active.update(profile=prof, log_dir=log_dir)


def stop_trace() -> str:
    """Stop the running trace and write it into its log dir as a Chrome
    trace; returns the file's path. Raises if none is running."""
    if not _active:
        raise RuntimeError("no trace is running")
    prof, log_dir = _active.pop("profile"), _active.pop("log_dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def device_trace(log_dir: str | None, cuda: bool = True):
    """torch.profiler trace (the card's kernels too unless ``cuda`` is
    False) when a log dir is configured, no-op otherwise."""
    if not log_dir:
        yield
        return
    start_trace(log_dir, cuda)
    try:
        yield
    finally:
        stop_trace()
