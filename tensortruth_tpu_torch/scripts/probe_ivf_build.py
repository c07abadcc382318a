"""Stage-level timing of ``build_ivf`` at the config-5 shape (2M x 1024, 512
clusters), beside the build's own per-stage seconds.

    python -m tensortruth_tpu_torch.scripts.probe_ivf_build [n_rows]   # from the repository root; needs one CUDA card

Port of the JAX package's ``scripts/probe_ivf_build.py``: the corpus drawn
on the host (f32, ``default_rng(5)``), then each step of the build alone
under the reference's stage names (the sample gather, the k-means fit on
the card, the top-2 assignment on the card, the host's row placement), then
the whole ``build_ivf``, whose ``build_seconds`` (sample, kmeans, assign,
place, scatter: its blocks are staged on the card by the assignment pass and
scattered there once) are reported beside them.

:func:`run` takes the corpus from its caller (``make_corpus``, a
zero-argument callable, timed as the corpus stage) and returns the full
build's index with the numbers, so a caller builds an index once and times
it here. ``tiny=True`` (8,192 rows of D = 64, 32 clusters) is the only size
that runs on the CPU.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from tensortruth_tpu_torch.ops import ivf as ivf_mod
from tensortruth_tpu_torch.scripts import backend, card_line, driver_device

N, D, NC, SAMPLE, ITERS = 2_000_000, 1024, 512, 100_000, 8
TINY = {"n": 8192, "d": 64, "nc": 32, "sample": 4096}
STAGES = ("corpus_gen_host", "sample_gather", "kmeans_fit_device", "assign_top2_device", "place_rows_host",
          "full_build")


def draw_corpus(n: int, d: int) -> np.ndarray:
    """(n, d) f32 unit rows from ``default_rng(5)``, drawn in f32 (no float64
    intermediate): the probe's input, not a build stage."""
    x = np.random.default_rng(5).standard_normal((n, d), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def sample_gather(emb: np.ndarray, sample: int) -> np.ndarray:
    """The k-means sample: ``sample`` sorted rows drawn by ``default_rng(0)``."""
    n, d = emb.shape
    rows = np.sort(np.random.default_rng(0).choice(n, sample, replace=False))
    return ivf_mod._sample_rows(lambda: iter([emb]), n, d, rows)


def rows_per_cluster(assign: np.ndarray, n: int, nc: int) -> int:
    """``build_ivf``'s block height: 1.5x the mean cluster, at least the 95th
    percentile, at most 4x the mean, rounded up to 128."""
    counts = np.bincount(assign, minlength=nc)
    rpc = max(int(np.ceil(n / nc * 1.5)), int(np.percentile(counts, 95)))
    return -(-min(rpc, int(np.ceil(n / nc * 4.0))) // 128) * 128


def run(device="cuda", tiny: bool = False, n: int | None = None, make_corpus=None) -> dict:
    """Seconds per stage (``stages_s``), ``build_ivf``'s own ``build_seconds``
    and the full build's ``index``."""
    device = driver_device(device, tiny)
    d, nc, sample_size = (TINY["d"], TINY["nc"], TINY["sample"]) if tiny else (D, NC, SAMPLE)
    n = n or (TINY["n"] if tiny else N)
    stages_s = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        stages_s[name] = time.perf_counter() - t0
        print(f"  {name}: {stages_s[name]:.2f}s", file=sys.stderr, flush=True)
        return out

    emb = stage("corpus_gen_host", make_corpus or (lambda: draw_corpus(n, d)))
    n, d = emb.shape
    sample = stage("sample_gather", lambda: sample_gather(emb, min(sample_size, n)))

    def fit():
        with torch.inference_mode():
            return ivf_mod._kmeans_fit(torch.from_numpy(sample).to(device), 0, nc, ITERS).cpu().numpy()

    centroids = stage("kmeans_fit_device", fit)
    assign, second = stage("assign_top2_device", lambda: ivf_mod._assign_top2(lambda: iter([emb]), n, centroids, device))
    stage("place_rows_host", lambda: ivf_mod._place_rows(assign, second, nc, rows_per_cluster(assign, n, nc)))
    del sample, assign, second
    index = stage("full_build", lambda: ivf_mod.build_ivf(
        emb, n_clusters=nc, sample_size=sample_size, kmeans_iters=ITERS, seed=0, device=device))
    return {
        "n_rows": n, "n_clusters": nc, "backend": backend(device), "stages_s": stages_s,
        "build_seconds": dict(index.build_seconds), "rows_per_cluster": index.rows_per_cluster,
        "padding_waste": float(index.padding_waste), "card": card_line() if device.type == "cuda" else None,
        "index": index,
    }


def main() -> None:
    out = run(n=int(sys.argv[1]) if len(sys.argv) > 1 else None)
    out.pop("index")
    out["stages_s"] = {k: round(v, 2) for k, v in out["stages_s"].items()}
    out["build_seconds"] = {k: round(v, 2) for k, v in out["build_seconds"].items()}
    out["padding_waste"] = round(out["padding_waste"], 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
