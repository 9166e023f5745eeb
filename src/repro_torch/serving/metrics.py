"""Serving-tier observability: thread-safe counters and latency histograms.

The serving tier (admission control, deadline scheduling, lease failover)
emits its accounting through a :class:`MetricsRegistry` — a flat namespace
of named :class:`Counter`\\ s and :class:`Histogram`\\ s, optionally labeled
by tenant (``admissions[tenant-a]``).  Everything is in-process and cheap:
counters are a lock + int, histograms keep a bounded window of recent
observations so per-tenant p50/p99 stay O(window) to compute and O(1) to
record.

Beside it, the process-wide **span log**: :func:`enable` turns it on,
:func:`span` times a block of work on ``time.perf_counter_ns`` (the clock a
``torch.profiler`` trace is lined up with), and :func:`drain` hands over
what was recorded.  Off (the default), :func:`span` returns one shared
no-op object after a single module-global check: no clock read, no
allocation, no lock.  Its one counter, ``gc.pause_s``, sums the collector's
pauses while the log is on.  :func:`timed` is the one exception: a stage
timer the program reads whatever the log's state, which records a span
only while the log is on.  Attributes are set on the open span with
:meth:`Span.set` (the no-op's ``set`` does nothing), so a call site
allocates nothing while the log is off.

Nothing here imports jax or the runtime — the registry and the span log are
safe to use from any layer (scheduler, lease table, micro-batcher, the
kernels' device lock) without import cycles.
"""

from __future__ import annotations

import gc
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional


class Counter:
    """Monotonic thread-safe counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Histogram:
    """Sliding-window histogram over the most recent ``window`` observations.

    Percentiles are computed over the window (nearest-rank), which is what a
    serving dashboard wants: recent latency, not lifetime latency.  ``count``
    and ``total`` are lifetime aggregates.
    """

    __slots__ = ("_lock", "_window", "_count", "_total")

    def __init__(self, window: int = 2048) -> None:
        self._lock = threading.Lock()
        self._window: Deque[float] = deque(maxlen=max(1, window))
        self._count = 0
        self._total = 0.0

    def observe(self, value: float) -> None:
        with self._lock:
            self._window.append(float(value))
            self._count += 1
            self._total += float(value)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def total(self) -> float:
        with self._lock:
            return self._total

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile (``p`` in [0, 100]) over the window;
        0.0 when nothing has been observed."""
        with self._lock:
            data = sorted(self._window)
        if not data:
            return 0.0
        rank = min(len(data) - 1, max(0, round((p / 100.0) * (len(data) - 1))))
        return data[int(rank)]


class MetricsRegistry:
    """Named counters/histograms with an optional per-tenant label.

    ``registry.counter("admissions", tenant="a")`` returns (creating on
    first use) the counter registered under ``admissions[a]``; without a
    tenant the bare name is the key.  :meth:`snapshot` flattens everything
    into a plain dict for logs / reports / assertions.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}

    @staticmethod
    def _key(name: str, tenant: Optional[str]) -> str:
        return f"{name}[{tenant}]" if tenant is not None else name

    def counter(self, name: str, tenant: Optional[str] = None) -> Counter:
        key = self._key(name, tenant)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
            return c

    def histogram(
        self, name: str, tenant: Optional[str] = None, *, window: int = 2048
    ) -> Histogram:
        key = self._key(name, tenant)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(window)
            return h

    def counter_value(self, name: str, tenant: Optional[str] = None) -> int:
        key = self._key(name, tenant)
        with self._lock:
            c = self._counters.get(key)
        return c.value if c is not None else 0

    def snapshot(self) -> Dict[str, float]:
        """Flat, JSON-able view: every counter's value plus each histogram's
        ``.count`` / ``.p50`` / ``.p99``."""
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._histograms)
        out: Dict[str, float] = {k: float(c.value) for k, c in counters.items()}
        for k, h in hists.items():
            out[f"{k}.count"] = float(h.count)
            out[f"{k}.p50"] = h.percentile(50)
            out[f"{k}.p99"] = h.percentile(99)
        return out


# -- the span log ----------------------------------------------------------------

tracing = False  # the one flag every span site reads
_log: List["Span"] = []  # finished spans, appended whole (atomic under the GIL)
_tls = threading.local()  # .top: the innermost open span of the thread
_batch_ids = itertools.count(1)
_gc_start_ns = 0
_gc_pause_ns = 0  # the collector's pauses since the last drain, every generation


class Span:
    """One timed block of work: ``name``, ``t0`` / ``t1`` on
    ``perf_counter_ns``, the ``thread`` it ran on, its ``parent`` (the
    innermost span open on the thread when it opened, or the one passed in
    from another thread), the ``batch`` id it inherits, and ``attrs``."""

    __slots__ = ("name", "t0", "t1", "thread", "parent", "batch", "attrs", "_record", "_prev")

    def __init__(self, name: str, parent: Optional["Span"] = None, record: bool = True) -> None:
        self.name = name
        self.parent = parent
        self.batch: Optional[int] = None
        self.attrs: Dict[str, object] = {}
        self.t0 = self.t1 = 0
        self.thread = 0
        self._record = record
        self._prev: Optional[Span] = None

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def start(self) -> "Span":
        """Open the span (``with`` does this; ``start`` / ``stop`` serve a
        stage that a callee ends)."""
        if self._record:
            self._prev = getattr(_tls, "top", None)
            if self.parent is None:
                self.parent = self._prev
            if self.batch is None and self.parent is not None:
                self.batch = self.parent.batch
            self.thread = threading.get_ident()
            _tls.top = self
        self.t0 = time.perf_counter_ns()
        return self

    def stop(self) -> float:
        """Close the span; its seconds."""
        self.t1 = time.perf_counter_ns()
        if self._record:
            _tls.top = self._prev
            _log.append(self)
        return self.seconds

    def __enter__(self) -> "Span":
        return self.start()

    def __exit__(self, et, ev, tb) -> bool:
        self.stop()
        return False

    def __repr__(self) -> str:
        return f"Span({self.name!r}, {self.seconds * 1e3:.3f} ms, batch={self.batch})"


class _NoSpan:
    """The span every site gets while the log is off: enters, sets and
    exits without reading a clock or allocating."""

    __slots__ = ()
    seconds = 0.0

    def set(self, key, value) -> None:
        pass

    def start(self) -> "_NoSpan":
        return self

    def stop(self) -> float:
        return 0.0

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, et, ev, tb) -> bool:
        return False


NO_SPAN = _NoSpan()


def span(name: str, parent: Optional[Span] = None):
    """A span named ``name`` while the log is on (``parent`` carries a span
    across threads), else :data:`NO_SPAN`.  Use as ``with span(...) as s``."""
    if not tracing:
        return NO_SPAN
    return Span(name, parent)


def batch(name: str):
    """:func:`span` that opens a new batch: it and every span under it,
    across threads, carry the next batch id."""
    if not tracing:
        return NO_SPAN
    s = Span(name)
    s.batch = next(_batch_ids)
    return s


def timed(name: str) -> Span:
    """A stage timer: always times its block (one ``perf_counter_ns`` pair,
    ``.seconds``), and is recorded as a span while the log is on."""
    return Span(name, record=tracing)


def current() -> Optional[Span]:
    """The innermost span open on this thread (None while the log is off),
    to pass as another thread's ``parent``."""
    if not tracing:
        return None
    return getattr(_tls, "top", None)


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: every collection's pause adds to the
    ``gc.pause_s`` counter; a full collection (generation 2) is also a
    ``gc.collect`` span.

    It takes no lock: a collection can start inside any allocation, a
    locked block included, and no other collection (so no other call of
    this) runs until it ends."""
    global _gc_start_ns, _gc_pause_ns
    if phase == "start":
        _gc_start_ns = time.perf_counter_ns()
        return
    t1 = time.perf_counter_ns()
    gen = info.get("generation", 0)
    _gc_pause_ns += t1 - _gc_start_ns
    if gen == 2:
        s = Span("gc.collect", getattr(_tls, "top", None), record=False)
        s.t0, s.t1, s.thread = _gc_start_ns, t1, threading.get_ident()
        s.batch = s.parent.batch if s.parent is not None else None
        s.attrs = {"generation": gen}
        _log.append(s)


@dataclass
class Drained:
    """What :func:`drain` hands over: the finished spans in the order they
    closed, and the counters (``gc.pause_s`` where a collection ran)."""

    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, float] = field(default_factory=dict)


def enable() -> None:
    """Turn the span log on (and the collector's callback with it)."""
    global tracing
    if _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    tracing = True


def disable() -> None:
    """Turn the span log off; what it recorded waits for :func:`drain`."""
    global tracing
    tracing = False
    while _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)


def drain() -> Drained:
    """Everything recorded since the last drain, and an empty log."""
    global _log, _gc_pause_ns
    spans, _log = _log, []
    pause_ns, _gc_pause_ns = _gc_pause_ns, 0
    return Drained(spans, {"gc.pause_s": pause_ns / 1e9} if pause_ns else {})
