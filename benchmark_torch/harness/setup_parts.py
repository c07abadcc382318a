"""The program's set-up account (``tensortruth_tpu_torch/utils/profiling.py``:
``SetupAccount``), as the ``metrics/setup_*.py`` readers take it: the
``setup`` entry of ``/api/system/rag/status``, read once the warm-up and the
session fill are done, just before the window starts
(``ctx.status["before"]``), so its totals are the set-up's own."""

from __future__ import annotations


def account(ctx) -> dict | None:
    """The account's totals before the window, or None for a program
    without one."""
    before = (getattr(ctx, "status", None) or {}).get("before") or {}
    return before.get("setup")


def total(ctx, key: str):
    """One of the account's totals before the window (``engine_s``,
    ``index_read_s``, ``models_s``, ...), or None."""
    setup = account(ctx)
    return None if setup is None else setup[key]


def parts(ctx) -> dict | None:
    """``setup_s`` in three parts that sum to it: ``engine``, the engine's
    cold loads (index read, models, placement); ``served``, the app's served
    time (WebSocket handshakes, session creates, chat messages: the warm-up
    bursts and the session fill) less the part of the cold loads inside it,
    which the first message waits for; ``other``, the rest (imports, the
    corpus check, ``create_app``, server start, the load process and, in a
    traced run, the profiler's preparation). None for a program without the
    account."""
    setup = account(ctx)
    if setup is None:
        return None
    engine = setup["engine_s"]
    served = setup["busy_s"] - setup["engine_busy_s"]
    return {"engine": engine, "served": served, "other": ctx.setup_s - engine - served}
