"""The benchmark's own arithmetic: percentiles, the search's operation and
byte counts, rooflines and shares of the peak. Counted from logical shapes,
so a number reads the same whatever implements the work. A model's forward
operations are its family's count (``families/<name>.py``).
"""

from __future__ import annotations

import math

from .common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def percentile(values: list[float], p: float) -> float:
    """Nearest-rank percentile over all values (no interpolation)."""
    s = sorted(values)
    return s[max(0, math.ceil(p / 100.0 * len(s)) - 1)]


def mfu_pct(flops: float, seconds: float) -> float | None:
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (seconds * PEAK_BF16_FLOPS)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations at
    the bf16 peak and the bytes at the memory bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def flat_topk_work(b: int, n: int, d: int, k: int, elem: int = 2) -> tuple[float, float]:
    """Dense top-k of ``b`` queries over ``n`` rows of ``d``: the rows and
    queries read once, (score, id) pairs written once."""
    return 2.0 * b * n * d, float(n * d * elem + b * d * elem + b * k * 8)


def ivf_work(b: int, n_clusters: int, d: int, probed_rows: int, pair_rows: int, k: int,
             elem: int = 2) -> tuple[float, float]:
    """IVF search: the routing product over every centroid, then each
    (query, probed cluster) pair's rows; bytes: centroids and queries read
    once, each distinct probed cluster's valid rows read once, results
    written once."""
    flops = 2.0 * b * n_clusters * d + 2.0 * pair_rows * d
    nbytes = n_clusters * d * elem + b * d * elem + probed_rows * d * elem + b * k * 8
    return flops, float(nbytes)
