"""What the metric readers (``metrics/<name>.py``) share: the reduced
trace's spans, the probe's records inside the traced window, and the counts
they are divided by."""

from __future__ import annotations

from .arith import mfu_pct
from .check import load_reference
from .families import family


def mean_batch(ctx):
    """Requests per batcher dispatch over the window, from the deltas of
    ``requests_served`` and ``batches_run`` at ``/api/system/rag/status``."""
    before, after = ctx.batcher["before"], ctx.batcher["after"]
    batches = after.get("batches_run", 0) - before.get("batches_run", 0)
    served = after.get("requests_served", 0) - before.get("requests_served", 0)
    return served / batches if batches > 0 else None


def spans(ctx, name: str) -> list[float]:
    """Device seconds of each instance of span ``name`` in the trace."""
    return (ctx.trace or {}).get("spans", {}).get(name, [])


def in_window(ctx, records: list) -> list:
    """Records (host time first) made while the trace ran."""
    if ctx.trace_t0 is None:
        return []
    return [r for r in records if ctx.trace_t0 <= r[0] <= ctx.trace_t1]


def per_batch_ms(ctx, name: str):
    """Device milliseconds of span ``name`` per batcher dispatch traced."""
    n, times = len(spans(ctx, "bench.batch")), spans(ctx, name)
    if not n or sum(times) <= 0:
        return None
    return 1e3 * sum(times) / n


def idle_pct(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def serve_flops(ctx) -> float:
    """Forward operations of the query embeds and rerank pairs dispatched
    while the trace ran, over their unpadded token counts, each role by its
    family's count and token template."""
    n_tokens = load_reference(ctx.config).n_tokens
    emb, rr = ctx.config["embedder"], ctx.config["reranker"]
    f_emb, f_rr = family(emb), family(rr)
    q_lens = [f_emb.seq_len(n_tokens(q), None, emb["max_length"])
              for _, qs in in_window(ctx, ctx.probe.queries) for q in qs]
    p_lens = [f_rr.seq_len(n_tokens(a), n_tokens(b), rr["max_length"])
              for _, pairs in in_window(ctx, ctx.probe.reranks) for a, b in pairs]
    return f_emb.flops(emb, q_lens) + f_rr.flops(rr, p_lens)


def mfu(ctx):
    if not ctx.trace or not ctx.trace.get("busy_s"):
        return None
    return mfu_pct(serve_flops(ctx), ctx.trace["window_s"])


def search_roofline(ctx, kind: str, work):
    """Share of the bound (operations at the bf16 peak or bytes at the
    memory bandwidth, the larger) of the searches traced, over their spans'
    device time; the n-th search recorded in the window is the n-th span."""
    from .arith import bound_s

    recs = [s for s in ctx.probe.searches if s["kind"] == kind and ctx.trace_t0 is not None
            and ctx.trace_t0 <= s["t"] <= ctx.trace_t1]
    times = spans(ctx, "bench.search")
    n = min(len(recs), len(times))
    device = sum(times[:n])
    if not n or device <= 0:
        return None
    return 100.0 * sum(bound_s(*work(s)) for s in recs[:n]) / device
