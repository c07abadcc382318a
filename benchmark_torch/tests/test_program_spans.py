"""The readers of the program's own spans (``harness/program.py``, the
``metrics/*.py`` that read ``tensortruth_tpu_torch/utils/profiling.py``'s
records or its ``tt.*`` ranges in the trace), the trace's reduction
(``harness/trace.py``) and the idle-gap tool (``tools/gaps.py``), on the CPU:

    python -m pytest benchmark_torch/tests/test_program_spans.py -q

* each host-span reader gives the number its docstring defines from
  synthetic records, counts only the traced window, and gives None with no
  records or with a program that has no span recorder;
* a traced ``--tiny`` rehearsal of each cell prints all five of them;
* a synthetic Chrome trace reduces to device time per ``tt.*`` span name
  (message ids left off, kernels matched on the span's own thread), names
  each idle gap by the span holding the host, and gives ``query_step_ms``
  and ``rerank_ms`` per ``tt.batcher.dispatch``;
* ``topk_roofline`` counts a search's queries from its parent
  ``tt.query_step``, not the padded batch the search counts;
* the gap tool names a gap by each thread's innermost span and splits the
  idle time into "no message in flight" and the spans holding it.
"""

from __future__ import annotations

import json
import subprocess
import sys
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NEW = ["queue_wait_ms.poisson", "dispatch_ms.poisson", "session_io_ms.poisson", "loop_blocked_ms.poisson",
       "rerank_pad_pct.poisson"]

sys.path.insert(0, str(ROOT))


@pytest.fixture
def ring(monkeypatch):
    """An empty ring of the program's span recorder; ``add(name, t0, t1,
    **counts)`` puts a record in it."""
    from tensortruth_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_ring", deque(maxlen=profiling.RING_SIZE))

    def add(name, t0, t1, rids=(1,), seq=None, parent=None, **counts):
        seq = seq or len(profiling._ring) + 1
        profiling._ring.append(profiling.Record("tt." + name, rids, seq, parent, 1, t0, t1, counts))
        return seq
    return add


def read(name, t0=10.0, t1=20.0):
    from benchmark_torch.harness import chat

    return chat.load_metric(name).read(SimpleNamespace(trace_t0=t0, trace_t1=t1))


def test_readers_on_synthetic_records(ring):
    for name in NEW:
        assert read(name) is None, name
    # outside the window (started before it): never read
    ring("batcher.queue", 9.0, 10.5)
    ring("ws.message", 9.5, 10.2)
    ring("route.session_io", 9.6, 9.7)
    # two messages, four saves and a title and two context reads among them
    ring("ws.message", 11.0, 11.2, rids=(2,))
    ring("ws.message", 12.0, 12.3, rids=(3,))
    for t0, t1 in ((11.0, 11.004), (11.3, 11.31), (12.0, 12.002), (12.4, 12.404)):
        ring("route.session_io", t0, t1, bytes=100)
    ring("route.title", 11.31, 11.33)
    ring("route.context", 11.004, 11.005)
    ring("route.context", 12.002, 12.003)
    ring("batcher.queue", 11.01, 11.02)
    ring("batcher.queue", 12.01, 12.04)
    ring("batcher.dispatch", 11.02, 11.05, rids=(2,), requests=1)
    ring("batcher.dispatch", 12.04, 12.05, rids=(3,), requests=1)
    ring("batcher.dispatch", 19.9, 29.9, rids=(4,), requests=1)  # open at the window's end: left out
    ring("rerank.launch", 11.03, 11.04, pairs=10, forwards=2, tokens=2700, slots=7200)
    ring("rerank.launch", 12.045, 12.05, pairs=10, forwards=1, tokens=300, slots=800)
    assert read("queue_wait_ms.poisson") == pytest.approx(20.0)
    assert read("dispatch_ms.poisson") == pytest.approx(20.0)
    assert read("session_io_ms.poisson") == pytest.approx(10.0)
    assert read("loop_blocked_ms.poisson") == pytest.approx(21.0)
    assert read("rerank_pad_pct.poisson") == pytest.approx(62.5)
    assert read("session_io_ms.poisson", None, None) is None  # no trace, no window


def test_readers_of_a_program_without_the_recorder(ring, monkeypatch):
    from tensortruth_tpu_torch.utils import profiling

    ring("batcher.queue", 11.0, 11.1)
    assert read("queue_wait_ms.poisson") == pytest.approx(100.0)
    monkeypatch.delattr(profiling, "recorded")
    for name in NEW:
        assert read(name) is None, name


@pytest.mark.parametrize("cell", CELLS)
def test_traced_tiny_rehearsal_prints_the_five(cell):
    code = (
        "import json, sys, time; sys.path.insert(0, %r)\n"
        "from benchmark_torch.harness import chat\n"
        "from benchmark_torch.harness.common import load_cell\n"
        "r = chat.run(load_cell(%r), 31, 4.0, True, time.time(), tiny=True)\n"
        "print(json.dumps(r))\n" % (str(ROOT), cell)
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    for name in NEW:
        assert r["metrics"][name]["value"] >= 0, name
    assert 0 < r["metrics"]["rerank_pad_pct.poisson"]["value"] < 100


def x(name, ts, dur, tid, cat="user_annotation", corr=None):
    """One complete event of a Chrome trace."""
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce_reads_the_programs_spans(tmp_path):
    from benchmark_torch.harness import chat, trace

    loop, worker, pump, other, card = 10, 20, 30, 40, 7
    events = [
        # messages 1 and 2: on the loop 0-2200, a save 0-300 and a context read 1550-1650 on it
        x("tt.ws.message@1", 0, 2200, loop), x("tt.route.session_io@1", 0, 300, loop),
        x("tt.route.context@1", 1550, 100, loop),
        x("tt.rag.retrieve@1", 300, 1600, pump),
        # their dispatch: the query step with its search nested, then the rerank's launch
        x("tt.batcher.dispatch@1,2", 500, 1000, worker), x("tt.query_step@1,2", 500, 500, worker),
        x("tt.search@1,2", 700, 200, worker), x("tt.rerank.launch@1,2", 1000, 400, worker),
        x("tt.batcher.finish@1,2", 1650, 150, worker), x("tt.rerank.finish@1,2", 1650, 150, worker),
        # launches on the worker, and one on another thread inside the search's time
        x("cudaLaunchKernel", 550, 5, worker, "cuda_runtime", 1),
        x("cudaLaunchKernel", 750, 5, worker, "cuda_runtime", 2),
        x("cudaMemcpyAsync", 760, 5, other, "cuda_runtime", 5),
        x("cudaLaunchKernel", 1100, 5, worker, "cuda_runtime", 3),
        x("cudaMemcpyAsync", 1660, 5, worker, "cuda_runtime", 4),
        # the card: what they launched, and work of no span
        x("kernel_a", 600, 100, card, "kernel", 1), x("kernel_b", 800, 200, card, "kernel", 2),
        x("memcpy_b", 1000, 10, card, "gpu_memcpy", 2), x("kernel_c", 1100, 400, card, "kernel", 3),
        x("memcpy_d", 1700, 50, card, "gpu_memcpy", 4), x("memcpy_e", 2000, 100, card, "gpu_memcpy", 5),
        x("kernel_f", 2150, 10, card, "kernel"), x("kernel_g", 3000, 100, card, "kernel"),
        x("tt.search@1,2", 800, 200, card, "gpu_user_annotation"),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = trace.reduce(path, 4.0)
    assert t["spans"] == {name: [pytest.approx(s)] for name, s in (
        ("tt.ws.message", 0.0), ("tt.route.session_io", 0.0), ("tt.route.context", 0.0), ("tt.rag.retrieve", 0.0),
        ("tt.batcher.dispatch", 710e-6), ("tt.query_step", 310e-6), ("tt.search", 210e-6),
        ("tt.rerank.launch", 400e-6), ("tt.batcher.finish", 50e-6), ("tt.rerank.finish", 50e-6))}
    assert t["busy_s"] == pytest.approx(970e-6) and t["window_s"] == 4.0
    assert [name for name, _ in t["idle_gaps"]] == [
        trace.NO_MESSAGE, "pump: tt.rag.retrieve", "event loop: tt.route.context", "batcher worker: tt.search",
        "batcher worker: tt.rerank.launch", "event loop: tt.ws.message"]
    assert [s for _, s in t["idle_gaps"]] == pytest.approx([840e-6, 250e-6, 200e-6, 100e-6, 90e-6, 50e-6])
    assert t["device_ops"][0] == ["kernel_c", pytest.approx(400e-6)]
    ctx = SimpleNamespace(trace=t)
    assert chat.load_metric("query_step_ms").read(ctx) == pytest.approx(0.31)
    assert chat.load_metric("rerank_ms").read(ctx) == pytest.approx(0.45)
    assert chat.load_metric("query_step_ms").read(SimpleNamespace(trace=None)) is None


def test_topk_roofline_counts_the_query_steps_queries(ring):
    from benchmark_torch.harness import chat
    from benchmark_torch.harness.arith import bound_s, flat_topk_work

    config = json.loads((ROOT / BENCH["configs"][0]["file"]).read_text())
    d = config["corpus"]["dim"]
    # the window's first search: its query step began before the trace, so its real queries are not known
    ring("search", 10.5, 10.51, parent=99, b=16, n=1_000_000, k=100)
    step = ring("query_step", 11.0, 11.2, queries=3, tokens=40, slots=512)
    ring("search", 11.1, 11.11, parent=step, b=16, n=1_000_000, k=100)
    ring("search", 12.0, 12.01, parent=None, b=4, n=1_000_000, k=10, nprobe=32)  # an IVF search: not B1's
    ctx = SimpleNamespace(trace_t0=10.0, trace_t1=20.0, config=config, trace={"spans": {"tt.search": [2e-3, 1e-3]}})
    got = chat.load_metric("topk_roofline").read(ctx)
    assert got == pytest.approx(100 * bound_s(*flat_topk_work(3, 1_000_000, d, 100, 2)) / 1e-3)
    assert got != pytest.approx(100 * bound_s(*flat_topk_work(16, 1_000_000, d, 100, 2)) / 1e-3)
    assert chat.load_metric("topk_roofline").read(SimpleNamespace(trace_t0=None, trace_t1=None, config=config,
                                                                  trace=None)) is None


def test_gaps_names_each_gap_and_splits_the_idle_time(tmp_path):
    from benchmark_torch.harness import trace
    from benchmark_torch.tools import gaps

    loop, worker, pump = 10, 20, 30
    events = [
        x("kernel_a", 0, 100, 7, "kernel"), x("kernel_b", 1000, 100, 7, "kernel"),
        x("kernel_c", 1500, 100, 7, "kernel"), x("kernel_d", 3000, 100, 7, "kernel"),
        # message 5: on the loop 100-1200, its session save 100-400 blocks the loop
        x("tt.ws.message@5", 100, 1100, loop), x("tt.route.session_io@5", 100, 300, loop),
        # its retrieve on a pump waits 400-600 in the queue, then a dispatch 600-1150
        x("tt.rag.retrieve@5", 400, 750, pump), x("tt.batcher.dispatch@5", 600, 550, worker),
        x("tt.rerank.launch@5", 700, 300, worker),
        # nothing in flight 1600-3000 but a title after the sources, 2200-2400
        x("tt.route.title@5", 2200, 200, loop),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = trace.load(path)
    out = gaps.attribute(t, top=2)
    assert trace.device_extent(t["device"]) == (0, 3100) and out["idle_ms"] == pytest.approx(2.7)
    assert [g["ms"] for g in out["gaps"]] == pytest.approx([1.4, 0.9])
    assert out["gaps"][0]["threads"] == {f"event loop {loop}": "tt.route.title"}
    assert out["gaps"][1]["threads"] == {f"event loop {loop}": "tt.ws.message", f"pump {pump}": "tt.rag.retrieve"}
    assert out["split_ms"] == pytest.approx({
        "event loop: tt.route.session_io": 0.3, "pump: tt.rag.retrieve": 0.2, "batcher worker: tt.rerank.launch": 0.3,
        "batcher worker: tt.batcher.dispatch": 0.15, "event loop: tt.ws.message": 0.05,
        "event loop: tt.route.title": 0.2, "no message in flight": 1.5})
    assert gaps.main([str(path), "--top", "2", "--json", str(tmp_path / "gaps.json")]) == 0
    assert json.loads((tmp_path / "gaps.json").read_text())["split_ms"] == out["split_ms"]
    assert [name for name, _ in trace.reduce(path, 1.0)["idle_gaps"][:2]] == [
        "event loop: tt.route.title", "pump: tt.rag.retrieve"]
