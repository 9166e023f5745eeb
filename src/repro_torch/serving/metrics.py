"""Serving-tier observability: thread-safe counters and latency histograms.

The serving tier (admission control, deadline scheduling, lease failover)
emits its accounting through a :class:`MetricsRegistry` — a flat namespace
of named :class:`Counter`\\ s and :class:`Histogram`\\ s, optionally labeled
by tenant (``admissions[tenant-a]``).  Everything is in-process and cheap:
counters are a lock + int, histograms keep a bounded window of recent
observations so per-tenant p50/p99 stay O(window) to compute and O(1) to
record.

Nothing here imports jax or the runtime — the registry is safe to use from
any layer (scheduler, lease table, micro-batcher) without import cycles.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, Optional


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
