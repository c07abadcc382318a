"""Recall of kernel B1 (the fused top-k) against the exact top-k at the 1M tier.

    python -m tensortruth_tpu_torch.scripts.measure_recall   # from the repository root; needs one CUDA card

Port of the JAX package's ``scripts/measure_recall.py``: a (1,000,000, 1024)
bf16 corpus and 32 bf16 queries, both N(0, 1) from seeded generators on the
device (seeds 0 and 7), ``fused_topk(m=16, tile_n=2048, c_out=8192)``
against ``exact_topk`` for k = 10 and 100. B1 keeps one candidate per
(bucket, slot), so two of a query's true top-k that share a bucket cost one
of them: the expected loss is k(k-1) / (2 c_out) items, and the predicted
recall 1 - k(k-1) / (2 c_out) / k. The corpus is laid out padded to whole
tiles (as the engine places it), about 2 GiB on the card.

Prints one JSON line: n, c_out, recall@k and predicted@k for each k, and the
card's name and power limit. ``chip_smoke.py`` calls :func:`run`.
"""

from __future__ import annotations

import json

import torch

from tensortruth_tpu_torch.scripts import card_line

N, D, B = 1_000_000, 1024, 32
KS = (10, 100)
M, TILE_N, C_OUT = 16, 2048, 8192
CORPUS_SEED, QUERY_SEED = 0, 7


def predicted_recall(k: int, c_out: int = C_OUT) -> float:
    return 1 - k * (k - 1) / (2 * c_out) / k


def recall_of(exact_idx, fused_idx) -> float:
    """Mean over queries of the share of the exact top-k that the fused
    top-k holds."""
    k = exact_idx.shape[1]
    return sum(len(set(e.tolist()) & set(f.tolist())) / k for e, f in zip(exact_idx, fused_idx)) / len(exact_idx)


def make_inputs(device: str, n: int, d: int, b: int):
    """(queries (b, d), corpus (tiles x TILE_N, d), both bf16 N(0, 1)); the
    corpus rows past ``n`` are zero padding. Drawn 65,536 rows at a time."""
    corpus = torch.zeros((-(-n // TILE_N) * TILE_N, d), dtype=torch.bfloat16, device=device)
    gen = torch.Generator(device=device).manual_seed(CORPUS_SEED)
    for lo in range(0, n, 65_536):
        hi = min(n, lo + 65_536)
        corpus[lo:hi] = torch.randn((hi - lo, d), generator=gen, device=device).to(torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(QUERY_SEED)
    q = torch.randn((b, d), generator=gen, device=device).to(torch.bfloat16)
    return q, corpus


def run(device: str = "cuda", n: int = N, d: int = D, b: int = B) -> dict:
    """recall@k and predicted@k of B1 (its plain version on the CPU) over
    ``make_inputs(device, n, d, b)``, for each k of KS."""
    from tensortruth_tpu_torch.ops.topk import exact_topk, fused_topk

    q, corpus = make_inputs(device, n, d, b)
    out = {"n": n, "d": d, "b": b, "c_out": C_OUT}
    for k in KS:
        _, exact_idx = exact_topk(q, corpus, k, n_valid=n)
        _, fused_idx = fused_topk(q, corpus, k, m=M, tile_n=TILE_N, c_out=C_OUT, n_actual=n)
        out[f"recall@{k}"] = recall_of(exact_idx.cpu(), fused_idx.cpu())
        out[f"predicted@{k}"] = predicted_recall(k)
    return {**out, "card": card_line()}


def main() -> None:
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
