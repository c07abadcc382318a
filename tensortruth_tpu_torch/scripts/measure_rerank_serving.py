"""Serving-path rerank throughput: ``Reranker.score_pairs`` on the bench
workload (320 pairs x 256 tokens, bge-reranker-v2-m3 width, random
weights), against a variant that reads each batch back before the next.

    python -m tensortruth_tpu_torch.scripts.measure_rerank_serving   # from the repository root; needs one CUDA card

Port of the JAX package's ``scripts/measure_rerank_serving.py``. The
production path launches every bucketed batch, uploads token ids without a
stream synchronise and copies the scores back once behind an event; the
blocking variant (:func:`blocking_score_pairs`) reads each batch's scores
with ``.cpu()`` before it launches the next, the discipline the port
removed from the rerank (ROADMAP C-1). Both run the same forwards,
so their scores are bit-equal.

:func:`run` returns both times, their ratio and whether the scores agree;
:func:`main` prints the reference's lines. ``tiny=True`` (the 1-layer,
H = 32 cross-encoder of ``probe_seq_buckets``) is the only size that runs
on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from tensortruth_tpu_torch.models.embedder import bucket, pad_batch
from tensortruth_tpu_torch.models.reranker import Reranker
from tensortruth_tpu_torch.models.xlmr import BGE_RERANKER_V2_M3_CONFIG
from tensortruth_tpu_torch.scripts import backend, card_line, driver_device, time_calls
from tensortruth_tpu_torch.scripts.probe_seq_buckets import TINY_CONFIG
from tensortruth_tpu_torch.tokenization.tokenizer import SimpleTokenizer

N_PAIRS = 320
PAIR_TOKENS = 256  # bench.py SEQ_PAIR


def make_pairs() -> list[tuple[str, str]]:
    """32 unique queries x 10 unique docs (the engine's adaptive top-k),
    ~128-token texts: full 256-token pairs."""
    queries = [f"query {i} " + "retrieval " * 124 for i in range(N_PAIRS // 10)]
    return [(queries[i // 10], f"doc {i} " + "corpus chunk " * 62) for i in range(N_PAIRS)]


def blocking_score_pairs(rr: Reranker, pairs) -> np.ndarray:
    """The discipline before C-1: every batch of up to the largest batch
    bucket read back to the host before the next is launched."""
    ids, mask = rr.tokenizer.encode_batch([q for q, _ in pairs], rr.max_length, pair=[d for _, d in pairs])
    lengths = mask.sum(axis=1)
    order = np.argsort(-lengths, kind="stable")
    max_batch = rr.batch_buckets[-1]
    out = np.empty((len(pairs),), dtype=np.float32)
    with torch.inference_mode():
        for start in range(0, len(pairs), max_batch):
            sel = order[start : start + max_batch]
            seq = bucket(int(lengths[sel].max()), rr.seq_buckets)
            bsz = bucket(len(sel), rr.batch_buckets)
            logits = rr._fwd(*pad_batch(ids, mask, sel, bsz, seq, rr.tokenizer.pad_id))
            out[sel] = torch.sigmoid(logits[: len(sel)]).cpu().numpy()
    return out


def run(device="cuda", tiny: bool = False) -> dict:
    device = driver_device(device, tiny)
    cfg = TINY_CONFIG if tiny else BGE_RERANKER_V2_M3_CONFIG
    rr = Reranker.random_init(cfg, SimpleTokenizer(vocab_size=cfg.vocab_size), device)
    pairs = make_pairs()
    t_async = time_calls(lambda: rr.score_pairs(pairs), device)[0]
    t_block = time_calls(lambda: blocking_score_pairs(rr, pairs), device)[0]
    return {
        "async_ms": t_async * 1e3, "blocking_ms": t_block * 1e3, "speedup": t_block / t_async,
        "n_pairs": N_PAIRS, "pair_tokens": PAIR_TOKENS,
        "bit_equal": bool(np.array_equal(rr.score_pairs(pairs), blocking_score_pairs(rr, pairs))),
        "batch_buckets": list(rr.batch_buckets), "seq_buckets": list(rr.seq_buckets),
        "backend": backend(device), "card": card_line() if device.type == "cuda" else None,
    }


def main() -> None:
    out = run()
    print("backend:", out["backend"], out["card"])
    print(f"score_pairs async   : {out['async_ms']:8.1f} ms / {N_PAIRS} pairs")
    print(f"score_pairs blocking: {out['blocking_ms']:8.1f} ms / {N_PAIRS} pairs")
    print(f"speedup: {out['speedup']:.2f}x")
    print(f"batch buckets: {tuple(out['batch_buckets'])}, seq buckets: {tuple(out['seq_buckets'])}")


if __name__ == "__main__":
    main()
