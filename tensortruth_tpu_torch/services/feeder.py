"""Worker-pool host feeding for the rerank path (r4 verdict item 5).

At v5e-8 the DP cross-encoder consumes 8× the single-chip pair volume per
batch, and the ~500-QPS projection requires the HOST term — hydrate leaf
text → build (query, doc) pairs → tokenize/pad — to finish inside the
device budget. That term is embarrassingly parallel over pairs, but until
this module it ran single-threaded inside ``Reranker.score_pairs_async``.

Structure (what actually buys the overlap):

* pairs shard CONTIGUOUSLY across workers — rerank batches lay out each
  query's candidates consecutively (services/rag_service.py pair loop), so
  contiguous shards preserve the per-query tokenize memoization inside
  ``encode_batch`` (tokenizer.py:186-191) instead of splitting a query's
  repeats across workers;
* every worker runs its WHOLE slice end-to-end (hydrate → pairs →
  tokenize) rather than stage-by-stage — one handoff per shard, and one
  worker's Python-level hydrate overlaps another's GIL-releasing tokenize
  (HF ``tokenizers`` releases the GIL in Rust; the native hostkit C path
  releases it in C; numpy slice-copies release it during memcpy);
* token arrays are written straight into ONE preallocated (N, max_length)
  id/mask buffer pair at the shard's row offset — the device pad/bucket
  stage reads them in place, no per-shard concatenation.

The scaling is measured, not assumed: scripts/measure_host_8x.py sweeps
worker counts through THIS code and records host-total vs workers in
BASELINE.md (this VM exposes one core, so the local sweep proves the
structure — shard math, buffer layout, overlap — while the multi-core
speedup lands where the cores are).

Reference contract being scaled: rag_engine.py:420-461's per-query fan-out,
which the reference runs once per query on the host too.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def default_workers() -> int:
    """Env override > cpu count (the serving host's core budget). A
    malformed override falls back with a warning instead of detonating the
    first reranked query (the feeder is built lazily on the serving path)."""
    env = os.environ.get("TENSOR_TRUTH_TPU_FEED_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            logger.warning(
                "ignoring non-integer TENSOR_TRUTH_TPU_FEED_WORKERS=%r", env
            )
    return max(1, os.cpu_count() or 1)


class HostFeeder:
    """Parallel hydrate → pair-build → tokenize front-end for a Reranker.

    One instance per process is fine: the pool is stateless between calls
    and the tokenizer paths it drives are thread-safe (HFTokenizer wraps
    the Rust ``tokenizers``; SimpleTokenizer/hostkit are pure functions of
    their input plus an internal per-call cache)."""

    def __init__(self, n_workers: int | None = None):
        self.n_workers = n_workers or default_workers()
        self._pool = (
            ThreadPoolExecutor(self.n_workers, thread_name_prefix="feed")
            if self.n_workers > 1
            else None
        )

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    # -- sharding ------------------------------------------------------------

    def _shards(self, n: int) -> list[tuple[int, int]]:
        """Contiguous, near-equal [start, end) shards, never more than n."""
        k = min(self.n_workers, n)
        bounds = np.linspace(0, n, k + 1).astype(int)
        return [
            (int(bounds[i]), int(bounds[i + 1]))
            for i in range(k)
            if bounds[i + 1] > bounds[i]
        ]

    # -- tokenize-only (pairs already hydrated: the serving path) ------------

    def tokenize_pairs(
        self,
        tokenizer,
        pairs: Sequence[tuple[str, str]],
        max_length: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Sharded ``encode_batch`` into one preallocated buffer pair."""
        n = len(pairs)
        ids = np.empty((n, max_length), dtype=np.int32)
        mask = np.empty((n, max_length), dtype=np.int32)

        def run(lo: int, hi: int) -> None:
            chunk = pairs[lo:hi]
            i, m = tokenizer.encode_batch(
                [q for q, _ in chunk], max_length, pair=[d for _, d in chunk]
            )
            ids[lo:hi] = i  # memcpy, GIL released
            mask[lo:hi] = m

        self._run_shards(run, n)
        return ids, mask

    # -- full pipeline (build-side / measurement: rows live in a store) ------

    def hydrate_and_tokenize(
        self,
        tokenizer,
        query_of: Callable[[int], str],
        hydrate: Callable[[int], str],
        n_pairs: int,
        max_length: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Each worker hydrates, pair-builds, and tokenizes its own slice —
        ``query_of(i)``/``hydrate(i)`` map a pair index to its query string
        and (store-backed) document text."""
        ids = np.empty((n_pairs, max_length), dtype=np.int32)
        mask = np.empty((n_pairs, max_length), dtype=np.int32)

        def run(lo: int, hi: int) -> None:
            texts = [hydrate(i) for i in range(lo, hi)]
            queries = [query_of(i) for i in range(lo, hi)]
            i, m = tokenizer.encode_batch(queries, max_length, pair=texts)
            ids[lo:hi] = i
            mask[lo:hi] = m

        self._run_shards(run, n_pairs)
        return ids, mask

    def _run_shards(self, run, n: int) -> None:
        if n == 0:
            return
        shards = self._shards(n)
        if self._pool is None or len(shards) == 1:
            for lo, hi in shards:
                run(lo, hi)
            return
        futures = [self._pool.submit(run, lo, hi) for lo, hi in shards]
        for f in futures:
            f.result()  # re-raise worker exceptions with their traceback
