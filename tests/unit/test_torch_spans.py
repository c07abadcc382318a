"""The port's span recorder (``tensortruth_tpu_torch/utils/profiling.py``).

With no ``torch.profiler`` recording, a span is the one shared off span: it
enters no ``record_function`` range and keeps no record. While a profiler
records, spans nest per thread and per asyncio task, take their parent's
message ids, sum their counts, and keep one record each in the ring that
``recorded`` reads; the exported Chrome trace names each span
``tt.<name>@<ids>``, on the thread that ran it.
"""

import asyncio
import json
import threading
import time

import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from tensortruth_tpu_torch.utils import profiling


def _profile():
    return profile(activities=[ProfilerActivity.CPU], experimental_config=_ExperimentalConfig(profile_all_threads=True))


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    def no_range(*args, **kwargs):
        raise AssertionError("a record_function range was entered with no trace recording")

    monkeypatch.setattr(profiling._torch_profiler, "record_function", no_range)
    before = list(profiling._ring)
    t0 = time.perf_counter()
    with profiling.span("ws.message", profiling.next_id()) as outer:
        assert not outer
        outer.count(bytes=3)
        with profiling.span("search", b=1, n=2, k=1) as inner:
            assert inner is outer  # the one shared off span: nothing is allocated
            assert profiling.current_span() is None
        outer.close()
    profiling.record("batcher.queue", 1, t0, time.perf_counter())
    assert list(profiling._ring) == before
    assert profiling.recorded(t0, time.perf_counter()) == []


def test_on_nests_spans_and_records_counts():
    with _profile():
        t0 = time.perf_counter()
        with profiling.span("ws.message", 7) as outer:
            with profiling.span("rerank.launch", pairs=3) as inner:
                assert inner and profiling.current_span() is inner
                inner.count(forwards=1, tokens=5, slots=8)
                inner.count(forwards=1, tokens=2, slots=8)

            def worker():
                assert profiling.current_span() is None  # a new thread starts outside every span
                with profiling.span("batcher.dispatch", [7, 9], requests=2):
                    with profiling.span("search", b=2, n=100, k=10):
                        pass

            thread = threading.Thread(target=worker)
            thread.start()
            thread.join(timeout=30)
            assert not thread.is_alive()
        profiling.record("batcher.queue", 9, t0 - 1.0, time.perf_counter())
        t1 = time.perf_counter()
    recs = {r.name: r for r in profiling.recorded(t0, t1)}
    assert set(recs) == {"tt.ws.message", "tt.rerank.launch", "tt.batcher.dispatch", "tt.search"}
    msg, launch = recs["tt.ws.message"], recs["tt.rerank.launch"]
    dispatch, search = recs["tt.batcher.dispatch"], recs["tt.search"]
    assert msg.rids == launch.rids == (7,) and msg.parent is None and launch.parent == msg.seq
    assert msg.t0 <= launch.t0 <= launch.t1 <= msg.t1
    assert launch.counts == {"pairs": 3, "forwards": 2, "tokens": 7, "slots": 16}
    assert dispatch.rids == search.rids == (7, 9) and search.parent == dispatch.seq and dispatch.parent is None
    assert dispatch.thread == search.thread != msg.thread == threading.get_native_id()
    assert search.counts == {"b": 2, "n": 100, "k": 10}
    # a record kept from elsewhere is inside an interval as a whole: this wait began before t0
    (queue,) = profiling.recorded(t0 - 2.0, t1, "tt.batcher.queue")
    assert queue.rids == (9,) and queue.t1 - queue.t0 >= 1.0
    assert profiling.recorded(t0, t1, "tt.batcher.queue") == []
    # a span still open at the interval's end is not inside it
    assert "tt.ws.message" not in {r.name for r in profiling.recorded(t0, msg.t1 - 1e-6)}


def test_exported_trace_names_each_span_with_its_message_ids(tmp_path):
    """Two messages' spans interleave on one event loop; each task keeps its
    own parent, and a dispatch on another thread serves both."""

    async def message(rid):
        with profiling.span("ws.message", rid):
            await asyncio.sleep(0.01)
            with profiling.span("route.session_io") as io:
                io.count(bytes=10)
                await asyncio.sleep(0.01)

    async def both():
        await asyncio.gather(message(1001), message(1002))

    path = tmp_path / "trace.json"
    with _profile() as prof:
        t0 = time.perf_counter()
        asyncio.run(both())

        def dispatch():
            with profiling.span("batcher.dispatch", [1001, 1002], requests=2):
                with profiling.span("search"):
                    torch.ones(4).add_(1)

        thread = threading.Thread(target=dispatch)
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive()
        t1 = time.perf_counter()
    prof.export_chrome_trace(str(path))

    recs = profiling.recorded(t0, t1)
    messages = {r.rids: r for r in recs if r.name == "tt.ws.message"}
    for r in recs:
        if r.name == "tt.route.session_io":
            assert r.parent == messages[r.rids].seq and r.counts == {"bytes": 10}
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("tt.")]
    tids = {e["name"]: e["tid"] for e in events}
    assert {"tt.ws.message@1001", "tt.ws.message@1002", "tt.route.session_io@1001", "tt.route.session_io@1002",
            "tt.batcher.dispatch@1001,1002", "tt.search@1001,1002"} == set(tids)
    assert tids["tt.ws.message@1001"] == tids["tt.route.session_io@1002"] != tids["tt.batcher.dispatch@1001,1002"]
    assert tids["tt.search@1001,1002"] == tids["tt.batcher.dispatch@1001,1002"]
