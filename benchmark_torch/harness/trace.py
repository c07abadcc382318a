"""The profiler's trace of a window, reduced to what the metrics read.

A ``torch.profiler`` trace of every thread (CPU ops, CUDA runtime calls and
the card's kernels, copies and sets) is written as a Chrome trace and read
back here. The program's spans (``tensortruth_tpu_torch/utils/profiling.py``)
are in it as ``record_function`` ranges named ``tt.<name>@<message ids>``;
they are read by the name before ``@``:

* device busy time: the union of kernel, copy and set intervals (the
  ranges the profiler also puts on the device's timeline are left out);
  the card is idle for the rest of the time from its first operation to
  its last;
* per ``tt.*`` span instance: the device time of the kernels launched by
  runtime calls inside the span on the span's own thread (matched by
  correlation id);
* the device operations that took most time, and the longest idle gaps,
  each named by the span that held the host at its midpoint (``holder``).

Threads are told apart by the spans they run: the event loop runs
``tt.ws.message``, the batcher's worker ``tt.batcher.dispatch``, the pump
threads ``tt.rag.retrieve`` or ``tt.llm.stream``. A span holds idle time in
this order: the worker's innermost span; else the event loop's innermost
``tt.route.*`` span (synchronous work on the loop); else a pump's
``tt.llm.stream``, then ``tt.rag.retrieve`` (waiting in the batcher's queue
or window); else ``tt.ws.message`` (the message between stages, its frames
on the loop) or any other ``tt.*`` span; with no span open on any thread,
"no message in flight" (the offered load).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ROLES = (("event loop", {"tt.ws.message"}), ("batcher worker", {"tt.batcher.dispatch"}),
         ("pump", {"tt.rag.retrieve", "tt.llm.stream"}))
NO_MESSAGE = "no message in flight"


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


def base(name: str) -> str:
    """``tt.batcher.dispatch@3,4`` -> ``tt.batcher.dispatch``."""
    return name.split("@", 1)[0]


def load(path) -> dict:
    """The trace's parts, in microseconds: ``device``, (start, end, name,
    correlation id) of each kernel, copy and set; ``launches``, thread ->
    sorted (start, correlation id) of its runtime calls; ``spans``, (start,
    end, name before ``@``, thread) of each ``tt.*`` range, sorted."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f).get("traceEvents", [])
    device, launches, spans = [], defaultdict(list), []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        cat, name = e.get("cat", ""), str(e.get("name", ""))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, name, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[(e.get("pid"), e.get("tid"))].append((ts, corr))
        elif cat == "user_annotation" and name.startswith("tt."):
            spans.append((ts, ts + dur, base(name), (e.get("pid"), e.get("tid"))))
    for v in launches.values():
        v.sort()
    device.sort(key=lambda d: d[:2])
    spans.sort(key=lambda r: r[:3])
    return {"device": device, "launches": dict(launches), "spans": spans}


def device_extent(device: list) -> tuple[float, float]:
    """The first device operation's start and the last one's end."""
    return (device[0][0], max(e for _, e, *_ in device)) if device else (0.0, 0.0)


def idle_intervals(device: list) -> list[tuple[float, float]]:
    """From the first device operation's start to the last one's end, the
    stretches that no operation covers."""
    out, cur = [], None
    for s, e, *_ in device:
        if cur is not None and s > cur:
            out.append((cur, s))
        cur = e if cur is None else max(cur, e)
    return out


def span_device_s(t: dict) -> dict[str, list[float]]:
    """Span name -> device seconds of each of its instances, in start order:
    the kernels, copies and sets launched inside the instance on its own
    thread."""
    dur_of: dict = defaultdict(float)
    for s, e, _, corr in t["device"]:
        if corr is not None:
            dur_of[corr] += e - s
    keys = {k: [ts for ts, _ in v] for k, v in t["launches"].items()}
    out: dict[str, list[float]] = defaultdict(list)
    for s, e, name, thread in t["spans"]:
        v, ks = t["launches"].get(thread, []), keys.get(thread, [])
        a, b = bisect.bisect_left(ks, s), bisect.bisect_right(ks, e)
        out[name].append(sum(dur_of.get(corr, 0.0) for _, corr in v[a:b]) * 1e-6)
    return dict(out)


def roles(spans: list) -> dict:
    """Thread -> its role, from the spans it runs (``other`` for none)."""
    names = defaultdict(set)
    for _, _, name, thread in spans:
        names[thread].add(name)
    return {t: next((role for role, markers in ROLES if markers & n), "other") for t, n in names.items()}


def open_at(spans: list, t: float) -> list:
    return [s for s in spans if s[0] <= t < s[1]]


def innermost(open_spans: list) -> dict:
    """Thread -> the name of its latest-started open span (of two that start
    together, the shorter: the one nested in the other)."""
    out = {}
    for _, _, name, thread in sorted(open_spans, key=lambda s: (s[0], -s[1])):
        out[thread] = name
    return out


def holder(open_spans: list, role_of: dict) -> str:
    """Which span holds idle time while ``open_spans`` are open (the order in
    the module's docstring); ``NO_MESSAGE`` with none."""
    if not open_spans:
        return NO_MESSAGE
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


def reduce(path, window_s: float) -> dict:
    t = load(path)
    device, spans = t["device"], t["spans"]
    idle = idle_intervals(device)
    first, last = device_extent(device)
    ops: dict[str, float] = defaultdict(float)
    for s, e, name, _ in device:
        ops[name[:120]] += (e - s) * 1e-6
    role_of = roles(spans)
    longest = sorted(idle, key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": (last - first - sum(b - a for a, b in idle)) * 1e-6,
        "window_s": window_s,
        "spans": span_device_s(t),
        "device_ops": sorted(([n, s] for n, s in ops.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": [[holder(open_at(spans, (a + b) / 2), role_of), (b - a) * 1e-6] for a, b in longest],
    }
