#!/usr/bin/env python3
"""Readings the benchmark's fixed numbers are set from, in one process per
cell (never part of a measured run):

    python3 benchmark_torch/tools/calibrate.py --workload <cell> \\
        [--sweep 10,15,20] [--sweep-seconds 15] \\
        [--seeds 1,2,...] [--window 8] [--control 3] [--tiny]

* ``--sweep``: the open loop at each offered rate in turn (the cell's own
  mix otherwise), one JSON line per rate: p50 and p95 of due-to-sources,
  the generator's lateness, how much later the last third of the window
  answered than the first, and how long after the window the last answer
  came. A rate is sustained when every message is answered, its p95 meets
  the mix's latency limit (``slo_p95_ms``), the last third's median is
  within 1.5x the first third's and the backlog drains within 2 s; the
  knee is the highest rate sustained. It prints the knee and the rate the
  mix runs at (its ``rate_share_of_knee`` of the knee, to half a message a
  second), for the mix file to be edited by hand; ``--rate auto`` runs the
  readings below at that rate.
* ``--seeds``: for each seed, the program's weights are replaced in place
  by that seed's, a short window runs at the cell's own load, and a sample
  of its answers is held against the float32 reference: the numbers the
  limits are set above (the lower readings). For the first ``--control``
  seeds the reference at the control's precision (float8 e4m3 operands) is
  put in the program's place over the same queries and compared the same
  way: the numbers the limits are set below (the upper readings); so is the
  float32 reference with each selection fault planted (``faults``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def emit(obj) -> None:
    print(json.dumps(obj, default=str), flush=True)


def window(sv, spec, seed, seconds):
    """(messages, latencies in ms) of one window of the cell's own traffic."""
    from benchmark_torch.harness import chat

    chat.fill(sv.load, spec, chat.window_size(spec, seconds))
    if spec["generator"] == "open_loop":
        msgs, _, lat, _ = chat.open_loop(sv.load, spec, sv.texts, seed, seconds, tag=f"k{seed}x")
        return msgs, lat
    msgs, _, _ = chat.closed_loop(sv.load, spec, sv.texts, seed, seconds)
    return msgs, []


def reseat(sv, seed: int) -> None:
    """The resident models' weights replaced in place by ``seed``'s."""
    import torch

    from benchmark_torch.harness.families import family
    from benchmark_torch.harness.weights import make_weights, role_seed

    engine = sv.rag.engine
    for role, runtime in (("embedder", engine.embedder), ("reranker", engine.reranker)):
        m = sv.config[role]
        hf = make_weights(m, role_seed(seed, role), sv.device)
        with torch.no_grad():
            runtime.model.load_state_dict(family(m).program_state(runtime.model.cfg, hf), strict=True)


def drive(sv, spec, args) -> None:
    from benchmark_torch.harness import arith, chat, check

    n = max([int(round(r * args.sweep_seconds)) for r in args.sweep] + [chat.window_size(spec, args.window)])
    chat.warm_up(sv.load, spec, sv.texts, n)
    knee = None
    for rate in args.sweep:
        s = dict(spec, rate_per_s=rate)
        chat.fill(sv.load, s, chat.window_size(s, args.sweep_seconds))
        b0 = sv.load.ask(cmd="status")
        msgs, lateness, lat, _ = chat.open_loop(sv.load, s, sv.texts, 7_000_000 + int(rate * 10),
                                                args.sweep_seconds, tag=f"r{rate}x")
        b1 = sv.load.ask(cmd="status")
        ok = [m for m in msgs if m.ok]
        w_end = args.sweep_seconds
        third = max(1, len(msgs) // 3)
        first, last = sorted(lat[:third]), sorted(lat[-third:])
        growth = last[len(last) // 2] / first[len(first) // 2]
        drain = max(m.sources_at for m in ok) - w_end if ok else float("inf")
        p95 = arith.percentile(lat, 95)
        sustained = (growth <= 1.5 and drain <= 2.0 and len(ok) == len(msgs)
                     and p95 <= spec.get("slo_p95_ms", float("inf")))
        if sustained:
            knee = rate
        emit({"sweep": {"rate_per_s": rate, "answered_in_window_per_s":
                        sum(m.sources_at < w_end for m in ok) / args.sweep_seconds,
                        "failed": len(msgs) - len(ok), "p50_ms": arith.percentile(lat, 50),
                        "p95_ms": p95, "late_ms": lateness,
                        "last_over_first_third": growth, "drain_s": drain, "sustained": sustained,
                        "mean_batch": (b1.get("requests_served", 0) - b0.get("requests_served", 0))
                        / max(1, b1.get("batches_run", 0) - b0.get("batches_run", 0))}})
    if args.sweep:
        rate = None if knee is None else round(spec["rate_share_of_knee"] * knee * 2) / 2
        emit({"knee_per_s": knee, "rate_per_s": rate})
        if args.rate == "auto" and rate is not None:
            spec = dict(spec, rate_per_s=rate)
    if args.rate not in ("auto", ""):
        spec = dict(spec, rate_per_s=float(args.rate))
    emit({"readings_rate_per_s": spec.get("rate_per_s")})
    ref_mod = check.load_reference(sv.config)
    for i, seed in enumerate(args.seeds):
        reseat(sv, seed)
        msgs, _ = window(sv, spec, seed, args.window)
        records = [check.Record(m.text, m.sources, sv.probe.candidates.get(m.text)) for m in msgs if m.ok]
        chosen = check.sample(records, seed, chat.SAMPLE, ref_mod.n_tokens)
        t0 = time.perf_counter()
        ref = check.Reference(sv.config, seed, sv.device)
        program, seen = check.compare(chosen, ref, exact_search=not chat.is_ivf(sv.config))
        line = {"seed": seed, "messages": len(msgs), "failed": len(msgs) - len(records),
                "missing_candidates": sum(r.candidates is None for r in chosen), "program": program,
                "seen": seen, "reference_s": time.perf_counter() - t0}
        if i < args.control:
            ctrl = check.Reference(sv.config, seed, sv.device, precision="fp8")
            recs = check.control_records([r.text for r in chosen], ctrl)
            del ctrl
            line["control"], line["control_seen"] = check.compare(recs, ref, not chat.is_ivf(sv.config))
            line["faults"] = {order: check.compare(check.control_records([r.text for r in chosen], ref, order), ref,
                                                   not chat.is_ivf(sv.config))[0]
                              for order in ("reverse", "ascending")}
        del ref
        emit(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sweep", default="")
    ap.add_argument("--sweep-seconds", type=float, default=15.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--window", type=float, default=8.0)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--rate", default="", help="'auto': the sweep's rate for the mix; else a rate for the readings")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)
    args.sweep = [float(x) for x in args.sweep.split(",") if x]
    args.seeds = [int(x) for x in args.seeds.split(",") if x]
    from benchmark_torch.harness import chat
    from benchmark_torch.harness.common import load_cell

    cell = load_cell(args.workload)
    first = args.seeds[0] if args.seeds else 1
    with chat.served(cell, first, tiny=args.tiny) as sv:
        emit({"card": chat.power_line() if not args.tiny else "cpu", "cell": cell.name})
        drive(sv, cell.traffic, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
