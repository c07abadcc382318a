#!/usr/bin/env python3
"""Spreads of a cell's runs, the numbers its bounds are set from:

    python3 benchmark_torch/tools/spread.py SET1.jsonl SET2.jsonl

Each file holds the last stdout lines of one set of runs (one JSON result
per line). For each metric: each set's median and spread (the distance
between the first and third quartile as ``statistics.quantiles(values,
n=4)`` gives them, over the median), the wider of the two, five times it
(the bound it suggests, never under 1%), and the second set's median
against the first's, and the tightness reading: each set's spread with
its run farthest from its median left out, averaged over the sets.
"""

from __future__ import annotations

import json
import statistics
import sys


def spread(values: list[float]) -> tuple[float, float]:
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return med, (q3 - q1) / abs(med)


def without_farthest(values: list[float]) -> list[float]:
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main(paths: list[str]) -> None:
    sets = []
    for p in paths:
        rows = [json.loads(line) for line in open(p, encoding="utf-8") if line.strip().startswith("{")]
        sets.append(rows)
    names = sorted({m for rows in sets for r in rows for m in r["metrics"]})
    for name in names:
        per = []
        for rows in sets:
            vals = [r["metrics"][name]["value"] for r in rows if name in r["metrics"]]
            per.append((spread(vals), vals) if len(vals) >= 2 else (None, vals))
        widest = max((s[0][1] for s in per if s[0]), default=None)
        out = {"metric": name, "sets": [{"median": s[0][0], "spread": s[0][1], "values": s[1]} if s[0] else
                                        {"values": s[1]} for s in per]}
        if widest is not None:
            out["widest_spread"] = widest
            out["bound_5x"] = max(0.01, 5 * widest)
        if len(per) == 2 and per[0][0] and per[1][0]:
            out["second_over_first"] = per[1][0][0] / per[0][0][0]
        tight = [spread(without_farthest(s[1]))[1] for s in per if len(s[1]) >= 3]
        if tight:
            out["tightness_spread"] = sum(tight) / len(tight)
        print(json.dumps(out))
    for i, rows in enumerate(sets):
        print(json.dumps({"set": i + 1, "runs": len(rows), "correct": sum(r["correct"] for r in rows),
                          "checks": {k: max(r["checks"][k]["value"] for r in rows) for k in rows[0]["checks"]}}))


if __name__ == "__main__":
    main(sys.argv[1:])
