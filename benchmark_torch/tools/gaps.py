#!/usr/bin/env python3
"""Name the card's idle time in a Chrome trace of the served path by the
program's ``tt.*`` spans (``tensortruth_tpu_torch/utils/profiling.py``).

    python3 benchmark_torch/tools/gaps.py <trace.json> [--top 10] [--json out.json]

The trace is a ``torch.profiler`` trace of every thread and the card: a
``--trace 1`` window kept before the harness deletes it, or one taken
through ``/api/system/profile/start|stop``. The trace is read, and the
card's idle time and each span's hold on it found, by ``harness/trace.py``
(the reduction a traced run's breakdown comes from).

Printed: each of the ``--top`` longest idle gaps with the innermost ``tt.*``
span open at its midpoint on each thread; then the idle time split into
"no message in flight" (no ``tt.*`` span open on any thread: the offered
load) and the time held by the host, by the span holding it
(``trace.holder``).
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark_torch.harness.trace import (  # noqa: E402
    device_extent, holder, idle_intervals, innermost, load, open_at, roles)


def attribute(t: dict, top: int = 10) -> dict:
    """Of a trace as ``trace.load`` reads it: the longest idle gaps, each with
    each thread's innermost span at its midpoint, and the idle time split by
    holder (microseconds in, ms out)."""
    spans, extent = t["spans"], device_extent(t["device"])
    role_of = roles(spans)
    idle = idle_intervals(t["device"])
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
    t = load(args.trace)
    if not t["device"]:
        print("the trace holds no device operation", file=sys.stderr)
        return 1
    out = attribute(t, args.top)
    print(render(out))
    if args.json:
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
