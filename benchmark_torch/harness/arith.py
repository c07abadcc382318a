"""The benchmark's own arithmetic: percentiles, operation and byte counts,
rooflines and shares of the peak. Counted from logical shapes, so a number
reads the same whatever implements the work.
"""

from __future__ import annotations

import math

from .common import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def percentile(values: list[float], p: float) -> float:
    """Nearest-rank percentile over all values (no interpolation)."""
    s = sorted(values)
    return s[max(0, math.ceil(p / 100.0 * len(s)) - 1)]


def encoder_flops(m: dict, seq_lens) -> float:
    """Forward operations of an XLM-R encoder over sequences of the given
    real (unpadded) lengths: per layer and token the four projections
    (8 H^2) and the two FFN products (4 H I), per layer and sequence the
    scores and context products (4 S^2 H); a classification head adds
    2 H^2 + 2 H labels per sequence."""
    h, i, layers = m["hidden_size"], m["intermediate_size"], m["num_hidden_layers"]
    per_token = layers * (8 * h * h + 4 * h * i)
    total = 0.0
    for s in seq_lens:
        total += s * per_token + layers * 4 * s * s * h
    if m.get("num_labels"):
        total += len(seq_lens) * (2 * h * h + 2 * h * m["num_labels"])
    return total


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
