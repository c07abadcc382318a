"""rerank_pad_pct.poisson: share of the cross-encoder's token slots that
hold padding: 100 x (1 - real tokens / slots) over the program's
``tt.rerank.launch`` counts in the traced window, where slots are each
forward's batch bucket times its sequence bucket (``models/reranker.py``)."""
from benchmark_torch.harness import program


def read(ctx):
    recs = program.records(ctx, "tt.rerank.launch")
    slots = sum(r.counts.get("slots", 0) for r in recs)
    if not slots:
        return None
    return 100.0 * (1.0 - sum(r.counts.get("tokens", 0) for r in recs) / slots)
