"""Server-side query micro-batching.

SURVEY.md §7 step 6: the throughput target comes from batching — one TPU
dispatch amortizes over every concurrent query. ``QueryBatcher`` coalesces
retrieval requests arriving within ``max_wait_ms`` (or until ``max_batch``)
and runs them as ONE fused embed→top-k dispatch (pipeline.py) followed by
ONE cross-query rerank pass (models/reranker.py ``score_pairs``). Callers
block on a future, so per-request code is unchanged.

Thread-based (not asyncio) because the RAG query path runs in executor
threads (server/routes/chat.py pump); a single worker thread owns the
device, mirroring the reference's serial TaskRunner discipline for builds.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


@dataclass
class _Request:
    text: str
    key: object = None  # engine pin: only same-key requests batch together
    future: Future = field(default_factory=Future)


class QueryBatcher:
    """Coalesces ``retrieve(text)`` calls into batched device dispatches."""

    def __init__(self, run_batch, max_batch: int = 32, max_wait_ms: float = 8.0):
        """``run_batch(texts: list[str], key) -> list[result]`` does the
        device work. ``key`` is whatever object the callers pinned (e.g. the
        engine); requests with different keys never share a dispatch.

        Two-phase protocol (double-buffering): ``run_batch`` may instead
        return a CALLABLE ``finish() -> list[result]`` after having
        dispatched its device work asynchronously. The worker then resolves
        that batch's futures only after the NEXT batch has been dispatched
        (or immediately when the queue is idle), so under load the device
        never drains between batches and batch B's device→host conversion
        RTT overlaps batch B+1's compute. Idle latency is unchanged: with
        nothing queued the finisher runs right away."""
        self.run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: queue.Queue[_Request] = queue.Queue()
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()
        self._start_lock = threading.Lock()
        self.batches_run = 0  # introspection/tests
        self.requests_served = 0

    def start(self) -> None:
        # locked check-then-act: concurrent first submits must not spawn
        # two workers — a single worker thread owns the device
        with self._start_lock:
            if self._worker is None or not self._worker.is_alive():
                self._stop.clear()
                self._worker = threading.Thread(
                    target=self._loop, name="query-batcher", daemon=True
                )
                self._worker.start()

    def stop(self) -> None:
        self._stop.set()
        worker = self._worker
        if worker is not None:
            worker.join(timeout=5.0)
        # fail queued requests immediately instead of stranding their
        # callers until the 120s result timeout
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(RuntimeError("batcher stopped"))

    def submit(self, text: str, key: object = None) -> Future:
        self.start()
        req = _Request(text, key=key)
        self._queue.put(req)
        return req.future

    def retrieve(self, text: str, timeout: float = 120.0, key: object = None):
        """Blocking convenience wrapper."""
        return self.submit(text, key=key).result(timeout)

    # -- worker ----------------------------------------------------------------

    def _collect(self) -> list[_Request]:
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = self.max_wait_ms / 1e3
        import time

        t0 = time.perf_counter()
        while len(batch) < self.max_batch:
            remaining = deadline - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _resolve(self, pending) -> None:
        """Run a two-phase batch's finisher and settle its futures."""
        reqs, finish = pending
        try:
            results = finish()
            if len(results) != len(reqs):
                raise RuntimeError(
                    f"finish returned {len(results)} results for "
                    f"{len(reqs)} requests"
                )
            for req, res in zip(reqs, results):
                req.future.set_result(res)
        except Exception as e:
            logger.exception("batched finish failed")
            for req in reqs:
                if not req.future.done():
                    req.future.set_exception(e)
        else:
            self.batches_run += 1
            self.requests_served += len(reqs)

    def _loop(self) -> None:
        pending = None  # previous two-phase batch awaiting its finisher
        while not self._stop.is_set():
            if pending is not None and self._queue.empty():
                # idle: nothing to overlap with — settle callers now
                self._resolve(pending)
                pending = None
            batch = self._collect()
            if not batch:
                continue
            # Group by pinned key (engine identity): a reload arriving
            # mid-window must not mix queries from two engines in one dispatch.
            groups: dict[int, list[_Request]] = {}
            for r in batch:
                groups.setdefault(id(r.key), []).append(r)
            for reqs in groups.values():
                try:
                    out = self.run_batch([r.text for r in reqs], reqs[0].key)
                except Exception as e:
                    logger.exception("batched dispatch failed")
                    for req in reqs:
                        if not req.future.done():
                            req.future.set_exception(e)
                    out = None
                # Settle the previous two-phase batch after ANY dispatch,
                # not only a two-phase one: a synchronous (non-callable)
                # run_batch completes its device work inline, so the pending
                # batch's compute is long done — without this, sustained
                # direct traffic (e.g. a rerankerless engine sharing the
                # batcher) starves the pending callers until a queue gap or
                # their future timeout.
                if pending is not None:
                    self._resolve(pending)
                    pending = None
                if out is None:
                    continue
                if callable(out):
                    # two-phase: this group's device work is dispatched;
                    # its futures settle once the next dispatch lands
                    pending = (reqs, out)
                    continue
                try:
                    results = out
                    if len(results) != len(reqs):
                        raise RuntimeError(
                            f"run_batch returned {len(results)} results for "
                            f"{len(reqs)} requests"
                        )
                    for req, res in zip(reqs, results):
                        req.future.set_result(res)
                except Exception as e:
                    logger.exception("batched dispatch failed")
                    for req in reqs:
                        if not req.future.done():
                            req.future.set_exception(e)
                else:
                    self.batches_run += 1
                    self.requests_served += len(reqs)
        if pending is not None:  # drain on stop: never strand callers
            self._resolve(pending)
