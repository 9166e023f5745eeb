"""What a traced run (``--trace 1``) records beside the window.

Wrappers are installed on instances and on ``repro_torch.kernels.ops``'s
functions, from the benchmark only, and removed after the window:

- host spans (name, start, end on ``perf_counter_ns``) around the layers'
  entry points: the coordinator's ``probe_batch``, each executor's
  ``_probe_shard_batch`` and ``_rerank``;
- the ``ProbeReport`` each ``probe_batch`` returns, for the program's own
  counters and stage timers;
- each counted kernel op call's arguments, as references: nothing runs on
  the card or the host for them inside the window; their operations and
  bytes are counted from them after the profiler has stopped.

``torch.profiler`` traces the device over the window: every kernel, copy
and set on the card, from which come the busy seconds, the idle gaps and
each hand-written kernel's device time (by its name).  It is started
before the window opens and stopped once the last answer is in, while the
program is idle: stopping it while other threads launch work has been seen
to stall the process for tens of seconds, or for good.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from functools import wraps
from typing import Dict, List, Optional, Tuple

import numpy as np

from harness import peaks

# the port's ops whose calls are counted: op name -> kernel family
COUNTED = {"gather_rerank": "gather_rerank"}
# each family's kernels by the names they are compiled under (csrc/*.cu)
KERNEL_NAMES = {"gather_rerank": ("gather_rerank_kernel",)}
SPANS = {
    "coordinator": ("probe_batch",),
    "executor": ("_probe_shard_batch", "_rerank"),
}
KEEP = {"probe_batch": "probe"}


@dataclass
class Profile:
    window_s: float  # length of the traced part of the window
    busy_s: float  # union of device activity in it
    kernels: Dict[str, float]  # device seconds by kernel name
    gaps: List[Tuple[float, float]]  # idle stretches (start, end), perf_counter seconds


@dataclass
class Recorder:
    counting: bool = False
    spans: List[Tuple[str, int, int, int]] = field(default_factory=list)  # name, t0, t1 (ns), thread
    kept: Dict[str, list] = field(default_factory=lambda: defaultdict(list))
    calls: Dict[str, list] = field(default_factory=lambda: defaultdict(list))
    _undo: list = field(default_factory=list)
    _depth: threading.local = field(default_factory=threading.local)

    # -- wrappers --------------------------------------------------------------
    def _span(self, name, fn):
        keep = KEEP.get(name)

        @wraps(fn)
        def wrapper(*a, **kw):
            t0 = time.perf_counter_ns()
            try:
                out = fn(*a, **kw)
            finally:
                self.spans.append((name, t0, time.perf_counter_ns(), threading.get_ident()))
            if keep is not None and out is not None:
                self.kept[keep].append(out)
            return out

        return wrapper

    def install(self, coordinator, executors) -> None:
        from repro_torch.kernels import ops

        for obj, names in ((coordinator, SPANS["coordinator"]),
                           *((ex, SPANS["executor"]) for ex in executors)):
            for name in names:
                setattr(obj, name, self._span(name, getattr(obj, name)))
                self._undo.append((obj, name, None))
        for name, family in COUNTED.items():
            fn = getattr(ops, name)
            setattr(ops, name, self._counted(name, family, fn))
            self._undo.append((ops, name, fn))

    def remove(self) -> None:
        for obj, name, fn in reversed(self._undo):
            if fn is None:
                delattr(obj, name)  # the class's method again
            else:
                setattr(obj, name, fn)
        self._undo.clear()

    def _counted(self, name, family, fn):
        @wraps(fn)
        def wrapper(*a, **kw):
            depth = getattr(self._depth, "n", 0)
            self._depth.n = depth + 1
            try:
                out = fn(*a, **kw)
            finally:
                self._depth.n = depth
            if self.counting and depth == 0:  # the outermost op of a nested call
                self.calls[family].append((name, a, kw))  # counted after the window
            return out

        return wrapper

    def count(self) -> None:
        """Each recorded call's operations and bytes, in place of the
        references it kept: run once the window and the profiler are over."""
        for family, calls in self.calls.items():
            self.calls[family] = [call_counts(name, a, kw) for name, a, kw in calls]

    def family_bound_s(self, family: str) -> Optional[float]:
        """The least time the chip could take for the family's counted calls
        (each call's own bound, summed), or None where none was counted."""
        calls = self.calls.get(family)
        if not calls:
            return None
        return sum(peaks.bound_s(float(ops), float(nbytes), peak) for ops, nbytes, peak in calls)


# -- operations and bytes each op needs -----------------------------------------
# The counts follow each op's semantics, whatever implements it: every input
# byte it needs read once, every output byte written once; where the work
# depends on the data (sentinel pool slots), what these inputs need.

def _gather_counts(q, x, pids, k):
    """Pooled rerank: 3 D operations a live (query, id) slot; each distinct
    live row read once, the queries and ids read once, (dist, id) pairs out."""
    import torch

    nq, d = q.shape
    n = x.shape[0]
    p = pids.reshape(nq, -1)
    valid = (p >= 0) & (p < n)
    live = int(valid.sum())
    flat = torch.sort(torch.where(valid, p.long(), -1).reshape(-1)).values
    distinct = int(((flat[1:] != flat[:-1]) & (flat[1:] >= 0)).sum() + (flat[:1] >= 0).sum())
    ops = 3 * d * live
    nbytes = 4 * d * distinct + 4 * nq * d + 4 * p.numel() + 8 * nq * k
    return ops, nbytes, peaks.F32_FLOPS


def call_counts(name: str, a: tuple, kw: dict):
    """(operations, bytes, peak rate) of one recorded call of op ``name``."""
    def arg(i, key):
        return a[i] if len(a) > i else kw[key]

    if name == "gather_rerank":
        return _gather_counts(arg(0, "queries"), arg(1, "points"), arg(2, "pool_ids"), arg(3, "k"))
    raise KeyError(name)


# -- the profiler -------------------------------------------------------------

class DeviceTrace:
    """``torch.profiler`` over part of the window: ``start()`` / ``stop()``
    from the client thread, then ``read()``."""

    def __init__(self) -> None:
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = None
        self._mark_ns = None

    def start(self) -> None:
        import torch

        t = time.perf_counter()
        self._prof.start()
        with torch.profiler.record_function("portbench::mark"):
            self._mark_ns = time.perf_counter_ns()
        self.t0 = time.perf_counter()
        self.cost = {"start_s": self.t0 - t}

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.stop()
        self.cost["stop_s"] = time.perf_counter() - self.t1

    def read(self) -> Profile:
        from torch.autograd import DeviceType

        t_read = time.perf_counter()
        events = self._prof.profiler.kineto_results.events()
        self.cost["events"] = len(events)
        mark = next(e for e in events if e.name() == "portbench::mark")
        offset = mark.start_ns() - self._mark_ns  # profiler clock - perf_counter_ns
        lo = int(self.t0 * 1e9) + offset
        hi = int(self.t1 * 1e9) + offset
        spans, kernels = [], defaultdict(float)
        for e in events:
            if e.device_type() != DeviceType.CUDA:
                continue
            s = max(e.start_ns(), lo)
            t = min(e.start_ns() + e.duration_ns(), hi)
            if t <= s:
                continue
            spans.append((s, t))
            kernels[e.name()] += (t - s) / 1e9
        busy, gaps = 0, []
        cur_s = cur_t = lo
        for s, t in sorted(spans):
            if s > cur_t:
                busy += cur_t - cur_s
                gaps.append(((cur_t - offset) / 1e9, (s - offset) / 1e9))
                cur_s = s
            cur_t = max(cur_t, t)
        busy += cur_t - cur_s
        if hi > cur_t:
            gaps.append(((cur_t - offset) / 1e9, (hi - offset) / 1e9))
        self.cost["read_s"] = time.perf_counter() - t_read
        return Profile(window_s=self.t1 - self.t0, busy_s=busy / 1e9, kernels=dict(kernels),
                       gaps=gaps)


def family_device_s(prof: Profile, family: str) -> float:
    names = KERNEL_NAMES[family]
    return sum(s for k, s in prof.kernels.items() if any(n in k for n in names))


SHORT_GAP_S = 20e-6  # an idle stretch this short is a launch's own latency
TOP = 10  # entries of each breakdown list: the result line takes at most 10


def idle_by_host(prof: Profile, spans: List[Tuple[str, int, int, int]]) -> list:
    """Idle device seconds by what the host was doing: each gap split at the
    edges of the recorded host spans, each piece charged to the innermost
    span open over it (the latest opened), else to ``client/batcher``."""
    edges = sorted(spans, key=lambda s: s[1])
    starts = np.array([s[1] for s in edges], np.int64) / 1e9
    ends = np.array([s[2] for s in edges], np.int64) / 1e9
    total: Dict[str, float] = defaultdict(float)
    for g0, g1 in prof.gaps:
        if g1 - g0 < SHORT_GAP_S:
            total["between launches (< 20 us)"] += g1 - g0
            continue
        near = np.flatnonzero((starts < g1) & (ends > g0))
        cuts = np.unique(np.clip(np.concatenate([[g0, g1], starts[near], ends[near]]), g0, g1))
        for a, b in zip(cuts[:-1], cuts[1:]):
            mid = (a + b) / 2
            open_ = near[(starts[near] <= mid) & (ends[near] >= mid)]
            label = edges[open_[-1]][0] if len(open_) else "client/batcher"
            total[label] += b - a
    return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:TOP]
