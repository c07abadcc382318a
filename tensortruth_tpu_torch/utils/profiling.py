"""Per-stage timing, device tracing and spans for the serving path.

SURVEY.md §5.1: the reference's observability is per-query RetrievalMetrics;
the engine adds stage-level wall timings (condense / embed / top-k / rerank)
attached to every query's metrics, and optional ``torch.profiler`` traces
(host ops and the card's kernels, written as Chrome traces) for deep dives.

While a ``torch.profiler`` trace records (``start_trace``, or any profiler
in the process), ``span`` marks each layer boundary of the serving path as a
``record_function`` range named ``tt.<name>``, on the same clock and thread
as the host ops and kernels it launches, and keeps one ``Record`` of it in a
bounded ring that ``recorded`` reads. A span carries the ids of the chat
messages it serves (one id per message, drawn by ``next_id`` where the
WebSocket route receives it; a span with none takes its parent's); the
Chrome trace carries them after the name, ``tt.batcher.dispatch@3,4``.
Without a trace recording a span is one flag test and records nothing.

The set-up account (``SETUP``, a ``SetupAccount``) is always on: it sums
the seconds of the engine's cold loads, the index reads and model loads
inside them and the kernel library's first load, and the served time of
the app's event loop (chat messages, session creates, WebSocket
handshakes), for the life of the process.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from collections import deque, namedtuple
from contextvars import ContextVar

import torch.autograd.profiler as _torch_profiler


class StageTimer:
    """Collects stage → milliseconds for one query."""

    def __init__(self):
        self.timings_ms: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings_ms[name] = round(
                self.timings_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3, 2
            )

    def to_dict(self) -> dict:
        total = round(sum(self.timings_ms.values()), 2)
        return {**self.timings_ms, "total_ms": total}


# The process's one running trace (torch.profiler allows one at a time):
# {"profile": the profiler, "log_dir": where stop_trace writes it}.
_active: dict = {}


def start_trace(log_dir: str, cuda: bool) -> None:
    """Start a torch.profiler trace of every thread's host ops and, with
    ``cuda``, the card's kernels. Raises if one is running."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    if _active:
        raise RuntimeError("a trace is already running")
    # Every thread's host ops: the server runs its queries on executor threads.
    prof = profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))
    prof.start()
    _active.update(profile=prof, log_dir=log_dir)


def stop_trace() -> str:
    """Stop the running trace and write it into its log dir as a Chrome
    trace; returns the file's path. Raises if none is running."""
    if not _active:
        raise RuntimeError("no trace is running")
    prof, log_dir = _active.pop("profile"), _active.pop("log_dir")
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def device_trace(log_dir: str | None, cuda: bool = True):
    """torch.profiler trace (the card's kernels too unless ``cuda`` is
    False) when a log dir is configured, no-op otherwise."""
    if not log_dir:
        yield
        return
    start_trace(log_dir, cuda)
    try:
        yield
    finally:
        stop_trace()


# -- spans of the serving path --------------------------------------------------

RING_SIZE = 65536


# One finished span: ``tt.<name>``, the message ids it served, its own
# sequence number and its parent's, the native id of the thread it ran on,
# ``time.perf_counter()`` at its start and end, and its counts.
Record = namedtuple("Record", "name rids seq parent thread t0 t1 counts")

_ring: deque = deque(maxlen=RING_SIZE)
_message_ids = itertools.count(1)
_span_ids = itertools.count(1)
# The innermost open span of this thread or asyncio task.
_current: ContextVar = ContextVar("tt_span", default=None)


def next_id() -> int:
    """A new message id (unique in the process)."""
    return next(_message_ids)


def _ids(rid) -> tuple:
    if rid is None:
        return ()
    return (rid,) if isinstance(rid, int) else tuple(rid)


class _Span:
    def __init__(self, name: str, rids: tuple, counts: dict):
        self.name, self.rids, self.counts = name, rids, counts

    def __enter__(self):
        parent = _current.get()
        if not self.rids and parent is not None:
            self.rids = parent.rids
        self.seq, self.parent = next(_span_ids), parent.seq if parent is not None else None
        self._token = _current.set(self)
        label = self.name + "@" + ",".join(map(str, self.rids)) if self.rids else self.name
        self._range = _torch_profiler.record_function(label)
        self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def count(self, **counts) -> None:
        """Add to the span's counts."""
        for key, n in counts.items():
            self.counts[key] = self.counts.get(key, 0) + n

    def close(self) -> None:
        """End the span now (before its block ends); later calls do nothing."""
        if self._range is None:
            return
        t1 = time.perf_counter()
        self._range.__exit__(None, None, None)
        self._range = None
        try:
            _current.reset(self._token)
        except ValueError:  # closed from another context (a generator finalised elsewhere)
            pass
        _ring.append(Record(self.name, self.rids, self.seq, self.parent, threading.get_native_id(), self.t0, t1,
                            self.counts))


class _Off:
    # The span while no trace records: does nothing.
    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def __bool__(self) -> bool:
        return False

    def count(self, **counts) -> None:
        return None

    def close(self) -> None:
        return None


_OFF = _Off()


def span(name: str, rid=None, **counts):
    """Context manager around one layer boundary, usable from any thread:
    span ``tt.<name>`` for the message id(s) ``rid`` (an id or several; by
    default the enclosing span's), with ``counts``. It is false, and
    records nothing, while no profiler records."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Span("tt." + name, _ids(rid), counts)


def record(name: str, rid, t0: float, t1: float, **counts) -> None:
    """Keep a span measured elsewhere (``t0``, ``t1`` on ``time.perf_counter``),
    such as a wait that starts on one thread and ends on another; it is kept
    in the ring only, with no ``record_function`` range."""
    if not _torch_profiler._is_profiler_enabled:
        return
    parent = _current.get()
    _ring.append(Record("tt." + name, _ids(rid), next(_span_ids), parent.seq if parent is not None else None,
                        threading.get_native_id(), t0, t1, counts))


def current_span():
    """The innermost open span of this thread or task, or None."""
    return _current.get()


def recorded(t0: float, t1: float, name: str | None = None) -> list[Record]:
    """The ring's records that started and ended between ``t0`` and ``t1``
    (``time.perf_counter``), of span ``name`` (``tt.<name>``) or of all."""
    return [r for r in list(_ring) if t0 <= r.t0 and r.t1 <= t1 and (name is None or r.name == name)]


# -- the set-up account -----------------------------------------------------------


class _BusyClock:
    """Wall seconds during which one or more of its requests are in flight.
    Only the event loop moves it; ``state`` is replaced whole, so another
    thread reads a consistent pair without a lock."""

    __slots__ = ("in_flight", "state")

    def __init__(self):
        self.in_flight = 0
        # (seconds of the closed busy stretches, start of the open one or None)
        self.state = (0.0, None)

    def enter(self, now: float) -> None:
        if self.in_flight == 0:
            self.state = (self.state[0], now)
        self.in_flight += 1

    def leave(self, now: float) -> None:
        self.in_flight -= 1
        if self.in_flight == 0:
            total, since = self.state
            self.state = (total + now - since, None)

    def seconds(self, clock) -> float:
        total, since = self.state  # read before the clock: ``since`` is never after ``now``
        return total if since is None else total + clock() - since


class _InFlight:
    # One request on the served-time clock, as a context manager.
    __slots__ = ("account", "count")

    def __init__(self, account: "SetupAccount", count: str | None):
        self.account, self.count = account, count

    def __enter__(self):
        account = self.account
        if self.count is not None:
            account._counts[self.count] += 1
        account._busy.enter(account.clock())
        return self

    def __exit__(self, *exc) -> None:
        self.account._busy.leave(self.account.clock())


class SetupAccount:
    """What bringing the server up costs, as process-lifetime totals on the
    host clock, always on (no profiler needed); ``/api/system/rag/status``
    reports ``snapshot()`` under ``setup``.

    Phases, from any thread (``phase``): ``engine`` (each cold
    ``load_engine_for_modules``), ``index_read`` (each ``VectorIndex.load``
    it makes; ``index_read_rows`` and ``_nodes`` count what they read),
    ``models`` (each ``ModelManager._load``, with each role's tokenizer and
    weights parts) and ``kernels`` (the kernel library's first load). Each
    adds ``<key>_s`` and ``<key>_n``; ``engine`` also ``engine_busy_s``, the
    part of it that fell in served time. Under a profiler each is also span
    ``tt.setup.<name>``.

    The served-time clock (``serving``) runs on the app's event loop: it
    keeps the requests in flight (a chat message from the frame received to
    the end of its handling, a session create, a WebSocket handshake until
    its ``prepare`` returns) and adds the wall seconds during which one or
    more are, so overlapping requests count once (``busy_s``). ``messages``
    and ``sessions`` count the chat messages and session creates."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self._lock = threading.Lock()
        self._sums: dict[str, float] = dict.fromkeys(
            [f"{key}_{part}" for key in ("engine", "index_read", "models", "kernels") for part in ("s", "n")]
            + ["engine_busy_s"], 0)
        self._busy = _BusyClock()
        self._counts = {"messages": 0, "sessions": 0}

    def add(self, **amounts) -> None:
        """Add seconds or counts to the totals (any thread)."""
        with self._lock:
            for key, amount in amounts.items():
                self._sums[key] = self._sums.get(key, 0) + amount

    def busy_s(self) -> float:
        """Served seconds so far (any thread)."""
        return self._busy.seconds(self.clock)

    @contextlib.contextmanager
    def phase(self, name: str, key: str | None = None, served: bool = False):
        """Time the block into ``<key>_s`` (``key`` defaults to ``name``),
        under span ``tt.setup.<name>``; with ``served``, also the part of it
        that fell in served time into ``<key>_busy_s``."""
        key = key or name
        with span("setup." + name):
            t0 = self.clock()
            b0 = self.busy_s() if served else 0.0
            try:
                yield
            finally:
                amounts = {f"{key}_s": self.clock() - t0, f"{key}_n": 1}
                if served:
                    amounts[f"{key}_busy_s"] = self.busy_s() - b0
                self.add(**amounts)

    def serving(self, count: str | None = None) -> _InFlight:
        """Context manager: one request in flight on the served-time clock,
        counted under ``count`` (``messages`` or ``sessions``) where given.
        Event loop only."""
        return _InFlight(self, count)

    def snapshot(self) -> dict:
        """The totals so far, with the served seconds up to now."""
        with self._lock:
            out = dict(self._sums)
        out["busy_s"] = self.busy_s()
        out.update(self._counts)
        return out


# The process's account.
SETUP = SetupAccount()


def setup_phase(name: str):
    """Decorator: each call of the function is set-up phase ``name`` of the
    process's account (``SETUP``, looked up at each call), with the part of
    it that fell in served time."""
    def wrap(fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with SETUP.phase(name, served=True):
                return fn(*args, **kwargs)
        return timed
    return wrap
