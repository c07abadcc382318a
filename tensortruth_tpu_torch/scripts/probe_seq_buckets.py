"""Probe: do finer rerank seq buckets (160/224/288) beat the 64-stride set?

    python -m tensortruth_tpu_torch.scripts.probe_seq_buckets   # from the repository root; needs one CUDA card

Port of the JAX package's ``scripts/probe_seq_buckets.py``. The serving
headline is cross-encoder-bound, and the pair-length mix of ``bench.py``
lands on buckets that waste padding: ~275-token pairs pad to 320, ~147-token
pairs to 192. Buckets every 32 tokens between 128 and 320 cut the padded
token-rows by about 12% on that mix, if the forward's cost at a length
that is no multiple of 64 (e.g. 288) scales with S.

Two measurements, at bge-reranker-v2-m3's width with random weights:

1. one forward at B = 64 for S in 160 ... 320 (every S below 512, so
   attention is plain PyTorch, never kernel B3): ms and us per token-row;
2. ``Reranker.score_pairs`` over the bench's 320 pairs with the current
   bucket set and with the finer one: ms, and the padded and real
   token-rows.

:func:`run` returns both; :func:`main` prints the reference's table.
``tiny=True`` (a 1-layer, H = 32 cross-encoder, B = 4 forwards, the first 40
pairs) is the only size that runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from tensortruth_tpu_torch.models.embedder import bucket
from tensortruth_tpu_torch.models.reranker import Reranker
from tensortruth_tpu_torch.models.xlmr import BGE_RERANKER_V2_M3_CONFIG, XLMRConfig, XLMRModel, rerank_logits
from tensortruth_tpu_torch.scripts import backend, card_line, driver_device, time_calls
from tensortruth_tpu_torch.scripts.bench import BATCH, RERANK_TOP, make_pool, make_queries
from tensortruth_tpu_torch.tokenization.tokenizer import SimpleTokenizer

N_PAIRS = BATCH * RERANK_TOP
SEQS = (160, 192, 224, 256, 288, 320)
FORWARD_B = 64

CURRENT = (64, 128, 192, 256, 320, 512, 1024, 2048)
FINER = (64, 128, 160, 192, 224, 256, 288, 320, 512, 1024, 2048)

# A one-layer, one-head cross-encoder: the CPU's time goes to the (S, S) attention.
TINY_CONFIG = XLMRConfig(vocab_size=512, hidden_size=32, num_layers=1, num_heads=1, intermediate_size=64,
                         max_position=2052, num_labels=1)
TINY = {"forward_b": 4, "pairs": 40}


def build_pairs() -> list[tuple[str, str]]:
    """The bench's 320 pairs: each query's 10 candidates drawn from its
    pool by ``default_rng(0)``."""
    pool = make_pool()
    queries = make_queries()
    picks = np.random.default_rng(0).integers(0, len(pool), size=N_PAIRS)
    return [(queries[i // RERANK_TOP], pool[picks[i]]) for i in range(N_PAIRS)]


def token_rows(rr: Reranker, pairs) -> tuple[int, np.ndarray]:
    """(padded token-rows under ``rr``'s seq buckets, each pair's length)."""
    _, mask = rr.tokenizer.encode_batch([q for q, _ in pairs], rr.max_length, pair=[d for _, d in pairs])
    lengths = mask.sum(axis=1)
    return int(sum(bucket(int(n), rr.seq_buckets) for n in lengths)), lengths


def run(device="cuda", tiny: bool = False) -> dict:
    device = driver_device(device, tiny)
    cfg = TINY_CONFIG if tiny else BGE_RERANKER_V2_M3_CONFIG
    b = TINY["forward_b"] if tiny else FORWARD_B
    tok = SimpleTokenizer(vocab_size=cfg.vocab_size)
    model = XLMRModel.random_init(cfg, device, seed=0)
    forward = []
    with torch.inference_mode():
        for s in SEQS:
            ids = torch.ones((b, s), dtype=torch.int32, device=device)
            t = time_calls(lambda: rerank_logits(model, ids, ids), device)[0]
            forward.append({"S": s, "B": b, "ms": t * 1e3, "us_per_token_row": t * 1e6 / (b * s)})
    pairs = build_pairs()[: TINY["pairs"] if tiny else N_PAIRS]
    buckets = {}
    for name, seq_buckets in (("current", CURRENT), ("finer", FINER)):
        rr = Reranker(model, tok, seq_buckets=seq_buckets)
        rows, lengths = token_rows(rr, pairs)
        t = time_calls(lambda: rr.score_pairs(pairs), device)[0]
        buckets[name] = {"ms": t * 1e3, "pairs": len(pairs), "padded_token_rows": rows,
                         "real_token_rows": int(lengths.sum()), "seq_buckets": list(rr.seq_buckets)}
    return {"backend": backend(device), "forward": forward, "buckets": buckets,
            "card": card_line() if device.type == "cuda" else None}


def main() -> None:
    out = run()
    print("backend:", out["backend"], out["card"])
    print(f"\nforward cost at B={FORWARD_B} (3-iter mean):")
    print(f"{'S':>5} {'ms':>8} {'us/token-row':>14}")
    for f in out["forward"]:
        print(f"{f['S']:>5} {f['ms']:>8.2f} {f['us_per_token_row']:>14.3f}")
    for name, b in out["buckets"].items():
        print(f"\n{name:8} buckets: {b['ms']:8.1f} ms / {b['pairs']} pairs"
              f"  (padded token-rows {b['padded_token_rows']}, real {b['real_token_rows']})")


if __name__ == "__main__":
    main()
