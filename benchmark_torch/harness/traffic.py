"""Chat traffic from a mix's parameters (``traffic/<mix>.json``) and a seed.

Every seed gets the same set of sizes and arrival gaps, in another order:
the multiset of query lengths and of gaps comes from the mix's own
``shape_seed``; ``--seed`` permutes both and draws the words. So seeds
change which message is long and when, never how much work a window holds.

* ``open_loop``: ``rate_per_s`` x seconds messages, Poisson gaps scaled so
  the last is due inside the window.
* ``closed_loop``: ``sessions`` clients, each sending its next message when
  the previous one's ``done`` frame arrives.

Query lengths in words: geometric on 1, 2, ... with the mix's
``query_words.mean``, the maximum-entropy law on the positive whole numbers
for a given mean (the source a mix cites publishes only the mean). The
first word, ``q<n>``, makes every query distinct.
"""

from __future__ import annotations

import numpy as np


def lengths(spec: dict, n: int, seed: int) -> list[int]:
    base = np.random.default_rng(spec["shape_seed"])
    w = base.geometric(1.0 / spec["query_words"]["mean"], size=n)
    return [int(x) for x in np.random.default_rng([seed, 1]).permutation(w)]


def arrivals(spec: dict, seconds: float, seed: int) -> list[float]:
    """Due offsets in [0, seconds) of an open loop's messages."""
    n = max(1, int(round(spec["rate_per_s"] * seconds)))
    gaps = np.random.default_rng([spec["shape_seed"], 2]).exponential(1.0, size=n)
    gaps = np.random.default_rng([seed, 2]).permutation(gaps * (seconds / gaps.sum()))
    return [float(x) for x in np.concatenate([[0.0], np.cumsum(gaps[:-1])])]


def queries(pool: list[str], words: list[int], seed: int, tag: str = "q") -> list[str]:
    rng = np.random.default_rng([seed, 3])
    out = []
    for i, n in enumerate(words):
        idx = rng.integers(0, len(pool), size=n - 1)
        out.append(" ".join([f"{tag}{i}"] + [pool[j] for j in idx]))
    return out


# Burst sizes of the set-up's warm-up: batch sizes up to the batcher's
# largest, so each rerank and query shape the window uses is met before it.
WARMUP_BURSTS = (1, 2, 3, 4, 6, 8, 12, 16, 20, 24, 28, 32, 32)
