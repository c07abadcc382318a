"""The readers of the program's own spans (``harness/program.py``, the five
``metrics/*.py`` that read ``tensortruth_tpu_torch/utils/profiling.py``'s
records) and the idle-gap tool (``tools/gaps.py``), on the CPU:

    python -m pytest benchmark_torch/tests/test_program_spans.py -q

* each reader gives the number its docstring defines from synthetic
  records, counts only the traced window, and gives None with no records
  or with a program that has no span recorder;
* a traced ``--tiny`` rehearsal of each cell prints all five metrics;
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

    def add(name, t0, t1, rids=(1,), **counts):
        profiling._ring.append(profiling.Record("tt." + name, rids, len(profiling._ring) + 1, None, 1, t0, t1,
                                                counts))
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


def test_gaps_names_each_gap_and_splits_the_idle_time(tmp_path):
    from benchmark_torch.tools import gaps

    def x(name, ts, dur, tid, cat="user_annotation"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}

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
    device, spans, extent = gaps.load(str(path))
    out = gaps.attribute(device, spans, extent, top=2)
    assert extent == (0, 3100) and out["idle_ms"] == pytest.approx(2.7)
    assert [g["ms"] for g in out["gaps"]] == pytest.approx([1.4, 0.9])
    assert out["gaps"][0]["threads"] == {f"event loop {loop}": "tt.route.title"}
    assert out["gaps"][1]["threads"] == {f"event loop {loop}": "tt.ws.message", f"pump {pump}": "tt.rag.retrieve"}
    assert out["split_ms"] == pytest.approx({
        "event loop: tt.route.session_io": 0.3, "pump: tt.rag.retrieve": 0.2, "batcher worker: tt.rerank.launch": 0.3,
        "batcher worker: tt.batcher.dispatch": 0.15, "event loop: tt.ws.message": 0.05,
        "event loop: tt.route.title": 0.2, "no message in flight": 1.5})
    assert gaps.main([str(path), "--top", "2", "--json", str(tmp_path / "gaps.json")]) == 0
    assert json.loads((tmp_path / "gaps.json").read_text())["split_ms"] == out["split_ms"]
