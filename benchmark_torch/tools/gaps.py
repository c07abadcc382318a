#!/usr/bin/env python3
"""Name the card's idle time in a Chrome trace of the served path by the
program's ``tt.*`` spans (``tensortruth_tpu_torch/utils/profiling.py``).

    python3 benchmark_torch/tools/gaps.py <trace.json> [--top 10] [--json out.json]

The trace is a ``torch.profiler`` trace of every thread and the card: a
``--trace 1`` window kept before the harness deletes it, or one taken
through ``/api/system/profile/start|stop``. The card is busy while a
kernel, copy or set runs (as ``harness/trace.py`` counts it) and idle for
the rest of the time from the first device operation to the last (host
events past those ends belong to the profiler's start and stop). Threads are told apart by the spans they
run: the event loop runs ``tt.ws.message``, the batcher's worker
``tt.batcher.dispatch``, the pump threads ``tt.rag.retrieve`` or
``tt.llm.stream``.

Printed: each of the ``--top`` longest idle gaps with the innermost ``tt.*``
span open at its midpoint on each thread; then the idle time split into
"no message in flight" (no ``tt.*`` span open on any thread: the offered
load) and the time held by the host, by the span holding it. A span holds
the idle time in this order: the worker's innermost span; else the event
loop's innermost ``tt.route.*`` span (synchronous work on the loop); else a
pump's ``tt.llm.stream``, then ``tt.rag.retrieve`` (waiting in the batcher's
queue or window); else ``tt.ws.message`` (the message between stages, its
frames on the loop) or any other ``tt.*`` span.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ROLES = (("event loop", {"tt.ws.message"}), ("batcher worker", {"tt.batcher.dispatch"}),
         ("pump", {"tt.rag.retrieve", "tt.llm.stream"}))


def base(name: str) -> str:
    """``tt.batcher.dispatch@3,4`` -> ``tt.batcher.dispatch``."""
    return name.split("@", 1)[0]


def load(path: str) -> tuple[list, list, tuple[float, float]]:
    """(device intervals, tt spans as (start, end, name, thread), the first
    device operation's start and the last one's end), in microseconds."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    device, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        name = str(e.get("name", ""))
        if e.get("cat") in DEVICE_CATS:
            device.append((ts, ts + dur))
        elif e.get("cat") == "user_annotation" and name.startswith("tt."):
            spans.append((ts, ts + dur, base(name), (e.get("pid"), e.get("tid"))))
    extent = (min(s for s, _ in device), max(e for _, e in device)) if device else (0.0, 0.0)
    return device, spans, extent


def idle_intervals(device: list, extent: tuple[float, float]) -> list[tuple[float, float]]:
    """The extent less the union of the device intervals."""
    out, cur = [], extent[0]
    for s, e in sorted(device):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if extent[1] > cur:
        out.append((cur, extent[1]))
    return out


def roles(spans: list) -> dict:
    """Thread -> its role, from the spans it runs (``other`` for none)."""
    names = defaultdict(set)
    for _, _, name, thread in spans:
        names[thread].add(name)
    return {t: next((role for role, markers in ROLES if markers & n), "other") for t, n in names.items()}


def innermost(open_spans: list) -> dict:
    """Thread -> the name of its latest-started open span (of two that start
    together, the shorter: the one nested in the other)."""
    out = {}
    for _, _, name, thread in sorted(open_spans, key=lambda s: (s[0], -s[1])):
        out[thread] = name
    return out


def holder(open_spans: list, role_of: dict) -> str:
    """Which span holds idle time while ``open_spans`` are open (the order in
    the module's docstring); ``no message in flight`` with none."""
    if not open_spans:
        return "no message in flight"
    by_role: dict[str, list[str]] = {}
    for thread, name in innermost(open_spans).items():
        by_role.setdefault(role_of.get(thread, "other"), []).append(name)
    worker, loop, pump = (by_role.get(r, []) for r in ("batcher worker", "event loop", "pump"))
    if worker:
        return "batcher worker: " + worker[0]
    route = [n for n in loop if n.startswith("tt.route.")]
    if route:
        return "event loop: " + route[0]
    for name in ("tt.llm.stream", "tt.rag.retrieve"):
        if name in pump:
            return "pump: " + name
    if loop:
        return "event loop: " + loop[0]
    role, names = next(iter(by_role.items()))
    return f"{role}: {names[0]}"


def open_at(spans: list, t: float) -> list:
    return [s for s in spans if s[0] <= t < s[1]]


def attribute(device: list, spans: list, extent: tuple[float, float], top: int = 10) -> dict:
    """The longest idle gaps, each with each thread's innermost span at its
    midpoint, and the idle time split by holder (microseconds in, ms out)."""
    role_of = roles(spans)
    idle = idle_intervals(device, extent)
    gaps = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:top]:
        inner = innermost(open_at(spans, (a + b) / 2))
        gaps.append({"ms": (b - a) * 1e-3, "at_ms": (a - extent[0]) * 1e-3,
                     "threads": {f"{role_of.get(t, 'other')} {t[1]}": n for t, n in sorted(inner.items(), key=str)}})
    # Between consecutive span boundaries the open spans, and so the holder,
    # do not change; the idle time inside each such piece is read off the
    # idle intervals' running sum.
    starts = [a for a, _ in idle]
    before = [0.0]
    for a, b in idle:
        before.append(before[-1] + b - a)

    def idle_until(x: float) -> float:
        k = bisect.bisect_right(starts, x) - 1
        return before[k] + min(x, idle[k][1]) - idle[k][0] if k >= 0 else 0.0

    cuts = sorted({extent[0], extent[1]} | {x for s in spans for x in s[:2]})
    split: dict[str, float] = defaultdict(float)
    for a, b in zip(cuts, cuts[1:]):
        held = idle_until(b) - idle_until(a)
        if held > 0:
            split[holder(open_at(spans, (a + b) / 2), role_of)] += held * 1e-3
    total = sum(b - a for a, b in idle) * 1e-3
    return {"window_ms": (extent[1] - extent[0]) * 1e-3, "idle_ms": total, "gaps": gaps,
            "split_ms": dict(sorted(split.items(), key=lambda kv: -kv[1]))}


def render(out: dict) -> str:
    lines = [f"window {out['window_ms']:.1f} ms, card idle {out['idle_ms']:.1f} ms "
             f"({100 * out['idle_ms'] / out['window_ms']:.1f}%)", "",
             "| gap ms | at ms | innermost tt.* span by thread |", "| --- | --- | --- |"]
    for g in out["gaps"]:
        inner = "; ".join(f"{t}: {n}" for t, n in g["threads"].items()) or "no span open"
        lines.append(f"| {g['ms']:.1f} | {g['at_ms']:.1f} | {inner} |")
    lines += ["", "| idle held by | ms | share of idle |", "| --- | --- | --- |"]
    for who, ms in out["split_ms"].items():
        lines.append(f"| {who} | {ms:.1f} | {100 * ms / out['idle_ms']:.1f}% |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--json", help="also write the attribution here")
    args = ap.parse_args(argv)
    device, spans, extent = load(args.trace)
    if not device:
        print("the trace holds no device operation", file=sys.stderr)
        return 1
    out = attribute(device, spans, extent, args.top)
    print(render(out))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
