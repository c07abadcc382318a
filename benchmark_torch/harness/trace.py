"""The profiler's trace of a window, reduced to what the metrics read.

A ``torch.profiler`` trace of every thread (CPU ops, CUDA runtime calls and
the card's kernels, copies and sets) is written as a Chrome trace and read
back here:

* device busy time: the union of kernel, copy and set intervals (the
  ``record_function`` ranges the profiler also puts on the device's
  timeline are left out);
* per ``bench.*`` span instance: the device time of the kernels launched
  by runtime calls inside the span on the span's own thread (matched by
  correlation id);
* the device operations that took most time, and the longest idle gaps
  named by the ``bench.*`` span the host was in at the time.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def prepare(path):
    """A profiler of every thread's host ops and the card's work, started in
    its warm-up step (the tracer's set-up paid now, outside the traced
    window); ``step()`` starts recording, a second ``step()`` stops it and
    writes the Chrome trace to ``path``."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * torch.cuda.is_available()
    prof = profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                   on_trace_ready=lambda p: p.export_chrome_trace(str(path)),
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    return prof


def reduce(path, window_s: float) -> dict:
    with open(path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    device, launches, spans = [], defaultdict(list), []
    dur_of: dict[int, float] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e.get("dur", 0.0)), e.get("name", "")))
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                dur_of[corr] = dur_of.get(corr, 0.0) + float(e.get("dur", 0.0))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[(e.get("pid"), e.get("tid"))].append((float(e["ts"]), corr))
        elif cat == "user_annotation" and str(e.get("name", "")).startswith("bench."):
            spans.append((float(e["ts"]), float(e.get("dur", 0.0)), e["name"], (e.get("pid"), e.get("tid"))))
    for v in launches.values():
        v.sort()
    keys = {k: [t for t, _ in v] for k, v in launches.items()}

    by_span: dict[str, list[float]] = defaultdict(list)
    spans.sort()
    for ts, dur, name, thread in spans:
        v, ks = launches.get(thread, []), keys.get(thread, [])
        a, b = bisect.bisect_left(ks, ts), bisect.bisect_right(ks, ts + dur)
        by_span[name].append(sum(dur_of.get(corr, 0.0) for _, corr in v[a:b]) * 1e-6)

    busy, gaps = 0.0, []
    device.sort()
    cur_s = cur_e = None
    for ts, dur, _ in device:
        if cur_e is None or ts > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((ts - cur_e, cur_e, ts))
            cur_s, cur_e = ts, ts + dur
        else:
            cur_e = max(cur_e, ts + dur)
    if cur_e is not None:
        busy += cur_e - cur_s

    ops: dict[str, float] = defaultdict(float)
    for _, dur, name in device:
        ops[name[:120]] += dur * 1e-6
    starts = [s[0] for s in spans]

    def doing(t: float) -> str:
        names = [s[2] for s in spans[: bisect.bisect_right(starts, t)] if s[0] + s[1] >= t]
        return names[-1] if names else "outside bench spans"

    gaps.sort(reverse=True)
    return {
        "busy_s": busy * 1e-6,
        "window_s": window_s,
        "spans": dict(by_span),
        "device_ops": sorted(([n, s] for n, s in ops.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": [[doing((a + b) / 2), g * 1e-6] for g, a, b in gaps[:10]],
    }
