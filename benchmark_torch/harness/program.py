"""The program's own spans (``tensortruth_tpu_torch/utils/profiling.py``)
made while the trace ran: the records its span recorder kept that started
and ended between ``ctx.trace_t0`` and ``ctx.trace_t1``, the host clock and
window that ``readers.in_window`` uses (a span open when the profiler stops
also holds the stop, seconds of trace export, and is left out). The metric
readers run in the server's
process after the window, so they read the recorder's ring directly. A
program without the recorder gives no records, and its metrics are left
out of the line."""

from __future__ import annotations


def records(ctx, name: str) -> list:
    """Records of span ``name`` (``tt.<layer>.<what>``) in the traced window."""
    if ctx.trace_t0 is None:
        return []
    try:
        from tensortruth_tpu_torch.utils.profiling import recorded
    except ImportError:
        return []
    return recorded(ctx.trace_t0, ctx.trace_t1, name)


def mean_ms(recs: list):
    """Mean host milliseconds of the records, or None without any."""
    return 1e3 * sum(r.t1 - r.t0 for r in recs) / len(recs) if recs else None


def per_message_ms(ctx, *names: str):
    """Host milliseconds of the spans ``names``, summed over the window, per
    message whose ``tt.ws.message`` started in it; None without either."""
    messages = len(records(ctx, "tt.ws.message"))
    recs = [r for name in names for r in records(ctx, name)]
    if not messages or not recs:
        return None
    return 1e3 * sum(r.t1 - r.t0 for r in recs) / messages
