"""The probe micro-batcher: the front door for concurrent probe traffic.

:class:`ProbeMicroBatcher` takes single queries from any thread through
``submit()``; a drainer collects a micro-batch (bounded by ``max_batch`` /
``max_wait_s``) and issues ONE ``Coordinator.probe_batch`` call, so
coordinator routing, fragment dispatch, and kernel launches amortize across
whatever concurrency the serving tier sees.

:func:`make_serve_fns` builds the LM serving steps, ``prefill_step`` and
``serve_step``.  With ``retrieval=`` an ANN probe
(:func:`repro_torch.serving.device_index.make_probe_fn`) is fused into the
decode step: the output distribution's soft embedding queries the
snapshot-bound index and the retrieved neighbours' tokens interpolate the
output distribution (kNN-LM), the paper's index as a serving feature.

Port of ``repro/serving/serve_loop.py``: the batcher, ``ServeConfig`` and
``make_serve_fns``.

One repair against the reference: with a :class:`SemanticResultCache`
attached, ``submit`` moves the cache's snapshot watermark to the table's
current snapshot before it looks an answer up.  The reference moves it only
on commits made through the coordinator (refresh, compaction) and on
drained reports, so after an append committed elsewhere it serves the
pre-append answer of a cached query until some probe drains; the port
serves the appended rows through the fresh tail at once.
"""

from __future__ import annotations

import math
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.device_cache import concrete_device
from repro_torch.models.model import Model, cache_shapes, param_shapes, torch_dtype
from repro_torch.models.sharding import (
    DEFAULT_RULES,
    LogicalRules,
    NamedSharding,
    implicit_replication,
    is_dtensor,
    logical_to_sharding,
    place,
    place_tree,
    spec_for,
)
from repro_torch.runtime.coordinator import ProbeReport
from repro_torch.serving.admission import (
    AdmissionController,
    AdmissionRejected,
    DeadlineExceeded,
    DegradationPolicy,
    ProbeParams,
    TenantPolicy,
)
from repro_torch.serving import metrics as spans
from repro_torch.serving.metrics import MetricsRegistry


@dataclass
class MicroBatchStats:
    batches: int = 0
    queries: int = 0
    max_batch_seen: int = 0
    filtered_queries: int = 0
    # adaptive sizing: how often the drainer grew / shrank max_batch
    grows: int = 0
    shrinks: int = 0
    # masked top-k kernel calls the drained probes cost (mask-plane path:
    # one per scoring flavor per shard per batch, however many distinct
    # predicates the concurrent submitters carried)
    kernel_dispatches: int = 0
    # submissions refused because the bounded queue was full (fail-fast
    # backpressure — the caller saw queue.Full, no Future was created)
    rejected: int = 0
    # background fresh-tail compactions this batcher kicked off
    compactions: int = 0
    # ... and how many of those failed in the background (the daemon used
    # to swallow exceptions silently; now the last failure is recorded)
    compaction_errors: int = 0
    last_compaction_error: str = ""
    # serving tier: submissions refused at the door by per-tenant token
    # buckets (the caller saw AdmissionRejected, no Future was created)
    admission_rejected: int = 0
    # queries whose deadline passed — dropped before dispatch or refused
    # after a late completion; their Future got DeadlineExceeded, they were
    # never served silently late
    deadline_misses: int = 0
    # batches / queries served with a degraded (labeled) answer
    degraded_batches: int = 0
    degraded_queries: int = 0
    # serving-tier cache hierarchy (serving/cache.py): queries answered at
    # the door by the semantic result cache (no admission token, no
    # dispatch) vs queries that went through to a probe ...
    semantic_hits: int = 0
    semantic_misses: int = 0
    # ... Stage-A (query, shard) fragments the coordinator's shard-probe
    # cache answered across this batcher's drained probes ...
    shard_cache_hits: int = 0
    # ... semantic entries dropped because a refresh/compaction committed a
    # new snapshot (mirrors the attached cache's invalidation total), and
    # entries evicted by the semantic cache's byte budget while inserting
    # this batcher's answers (the shard cache's counters live on the cache)
    cache_invalidations: int = 0
    cache_evictions: int = 0


@dataclass
class _Submission:
    """One queued probe: the query plus its serving-tier envelope."""

    query: np.ndarray
    k: int
    filter: object
    fut: Future
    tenant: str = "default"
    deadline: Optional[float] = None  # monotonic seconds, None = no deadline
    submitted: float = field(default_factory=time.monotonic)


class ProbeMicroBatcher:
    """Drain a queue of concurrent single-query probes into ``probe_batch``.

    Usage::

        with ProbeMicroBatcher(coordinator, "docs", max_batch=64) as mb:
            fut = mb.submit(q, k=10)        # from any number of threads
            fut2 = mb.submit(q2, k=10, filter="category = 'news'")
            hits = fut.result()             # per-query ProbeHit list
            hits_lists = mb.probe_many(Q, k=10)   # sync convenience

    The drainer waits ``max_wait_s`` after the first pending request (or
    until ``max_batch`` accumulate), groups requests by ``k`` (a batch probe
    shares one k), and resolves each Future with its query's hits.  Filtered
    and unfiltered submissions batch together: per-query predicates ride the
    same ``probe_batch`` call, and a batch does NOT need filter-homogeneous
    traffic to hit the kernel fast path — the executors answer a coalesced
    fragment's kernel-planned queries with one multi-mask kernel call per
    shard however many distinct predicates the submitters carried
    (``stats.kernel_dispatches`` counts the calls).  Errors propagate to
    every Future in the failed batch.

    With ``adaptive=True`` the drainer resizes ``max_batch`` from observed
    queue depth instead of holding the configured constant: a full drain
    that leaves requests queued doubles it (up to ``max_batch_cap``), and a
    drain well under the current size with an idle queue halves it (down to
    ``min_batch``) — deeper backlog buys more coalescing, light traffic
    keeps latency low.

    ``max_queue`` bounds the submission queue: when set, a ``submit`` that
    finds it full fails fast with :class:`queue.Full` instead of queueing
    unboundedly (``stats.rejected`` counts the refusals) — backpressure the
    caller can see, instead of a probe latency that silently grows with the
    backlog.  Unset, the queue is unbounded (the legacy behavior).

    ``compact_tail_over`` (with ``index_name``) turns on the background
    fresh-tail compaction policy: when a drained batch reports at least
    that many tail rows (appended-but-unindexed, served via the exact tail
    tier), a daemon thread folds the tail into the Vamana shards with
    :meth:`Coordinator.compact_tail` — serving traffic keeps flowing
    against the stale-but-tail-served snapshot until the refresh commits.
    A failed background compaction is recorded in
    ``stats.compaction_errors`` / ``stats.last_compaction_error`` instead
    of vanishing with the daemon thread.

    **Multi-tenant serving.**  Each submission carries ``(tenant,
    deadline_ms)``.  With an :class:`AdmissionController` attached (pass
    ``admission=`` or the ``tenant_policies=`` convenience), a tenant over
    its token-bucket rate is refused at the door with
    :class:`AdmissionRejected` — before it can occupy queue space
    (``stats.admission_rejected``).  The drainer is deadline-aware:
    already-expired queries are dropped with :class:`DeadlineExceeded`
    (``stats.deadline_misses``) and never dispatched, earlier deadlines
    flush first, and a result that completes past its deadline is likewise
    refused — never served silently late.  Per-tenant latency histograms
    (p50/p99) and decision counters live in ``self.metrics``.

    **Degradation.**  With a :class:`DegradationPolicy` attached, a drain
    under pressure (queue depth vs. capacity, and batch-latency EMA vs. the
    tightest pending deadline) trades answer quality for latency through
    the policy's typed steps — shrink k, drop the rerank oversample, skip
    the fresh-tail scan — instead of queueing unboundedly.  Degraded
    answers are labeled on the report (``ProbeReport.degraded``) and
    counted (``stats.degraded_batches``).  ``force_degrade`` is the
    operator override: ``"auto"`` (pressure-driven), ``"on"`` (every step,
    always), ``"off"`` (policy ignored — behavior is bit-for-bit the
    pre-degradation serving path).

    Caveat: the coordinator's per-probe I/O accounting
    (``ProbeReport.bytes_read``) resets a store-global counter, so byte
    attribution is best-effort when OTHER threads probe the same
    coordinator concurrently with the drainer; hits are unaffected.
    """

    def __init__(
        self,
        coordinator,
        table_name: str,
        *,
        strategy: str = "auto",
        max_batch: int = 64,
        max_wait_s: float = 0.002,
        adaptive: bool = False,
        min_batch: int = 4,
        max_batch_cap: int = 512,
        max_queue: Optional[int] = None,
        compact_tail_over: Optional[int] = None,
        index_name: Optional[str] = None,
        admission: Optional[AdmissionController] = None,
        tenant_policies: Optional[Dict[str, TenantPolicy]] = None,
        degradation: Optional[DegradationPolicy] = None,
        force_degrade: str = "auto",
        metrics: Optional[MetricsRegistry] = None,
        semantic_cache=None,
        **probe_kwargs,
    ) -> None:
        self.coordinator = coordinator
        self.table_name = table_name
        self.strategy = strategy
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.adaptive = adaptive
        self.min_batch = max(1, min_batch)
        self.max_batch_cap = max(max_batch, max_batch_cap)
        if compact_tail_over is not None and index_name is None:
            raise ValueError("compact_tail_over requires index_name")
        self.compact_tail_over = compact_tail_over
        self.index_name = index_name
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if admission is None and tenant_policies is not None:
            admission = AdmissionController(tenant_policies, metrics=self.metrics)
        self.admission = admission
        if force_degrade not in ("off", "auto", "on"):
            raise ValueError(f"force_degrade must be off/auto/on, got {force_degrade!r}")
        if degradation is None and force_degrade == "on":
            degradation = DegradationPolicy()
        self.degradation = degradation
        self.force_degrade = force_degrade
        # optional whole-answer SemanticResultCache (serving/cache.py):
        # consulted in submit() BEFORE admission — a hit costs no token
        self.semantic_cache = semantic_cache
        if semantic_cache is not None and semantic_cache.metrics is None:
            semantic_cache.metrics = self.metrics
        self.probe_kwargs = probe_kwargs
        self.stats = MicroBatchStats()
        self._stats_lock = threading.Lock()
        self._max_queue = max_queue
        self._latency_ema = 0.0  # EMA of drained-batch service time (s)
        self._queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=max_queue or 0)
        self._thread: Optional[threading.Thread] = None
        self._compact_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ProbeMicroBatcher":
        if self._thread is None:
            if self.semantic_cache is not None and hasattr(
                self.coordinator, "register_result_cache"
            ):
                # push invalidation: a refresh/compaction commit moves the
                # semantic cache's snapshot watermark at the commit itself,
                # closing the window where a hit could serve a pre-commit
                # answer before any post-commit report is drained
                self.coordinator.register_result_cache(
                    self.table_name, self.semantic_cache
                )
            self._stop.clear()
            self._thread = threading.Thread(target=self._drain_loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        if self.semantic_cache is not None and hasattr(
            self.coordinator, "unregister_result_cache"
        ):
            self.coordinator.unregister_result_cache(
                self.table_name, self.semantic_cache
            )
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._compact_thread is not None:
            self._compact_thread.join(timeout=30.0)
            self._compact_thread = None
        # requests enqueued before stop() but never drained must not strand
        # their waiters — fail them loudly
        while True:
            try:
                sub = self._queue.get_nowait()
            except queue_mod.Empty:
                break
            if not sub.fut.done():
                sub.fut.set_exception(RuntimeError("micro-batcher stopped"))

    def __enter__(self) -> "ProbeMicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission -------------------------------------------------------
    def submit(
        self,
        query,
        k: int = 10,
        filter=None,
        *,
        tenant: str = "default",
        deadline_ms: Optional[float] = None,
    ) -> Future:
        """Enqueue one query; the Future resolves to its ProbeHit list.
        ``filter`` (a Predicate or SQL WHERE fragment) makes it a filtered
        probe — it shares the batch with unfiltered submissions.

        ``tenant`` attributes the query for admission control and per-tenant
        latency metrics; with an admission controller attached, a tenant
        over its rate gets :class:`AdmissionRejected` here (counted in
        ``stats.admission_rejected``; no Future is created).

        ``deadline_ms`` is a relative deadline: if the result cannot be
        delivered within that many milliseconds the Future fails with
        :class:`DeadlineExceeded` (``stats.deadline_misses``) — expired
        queries are dropped before dispatch, and late completions are
        refused rather than served silently late.

        With ``max_queue`` set, a full queue raises :class:`queue.Full`
        immediately (fail-fast backpressure; counted in
        ``stats.rejected``) instead of blocking or queueing unboundedly."""
        if self._thread is None:
            raise RuntimeError("micro-batcher is not running (call start())")
        q = np.asarray(query, np.float32).reshape(-1)
        if self.semantic_cache is not None:
            # a commit made outside the coordinator (an append) has no push
            # hook: read the snapshot the probe would resolve, so no answer
            # of an older one serves
            self.semantic_cache.observe_snapshot(self._snapshot_id())
            # semantic result cache: answered at the door — the hit consumes
            # NO admission token (the tenant didn't use any compute), skips
            # the queue, and resolves the Future immediately
            entry = self.semantic_cache.lookup(tenant, q, k, filter)
            if entry is not None:
                with self._stats_lock:
                    self.stats.semantic_hits += 1
                self.metrics.counter("served", tenant).inc()
                self.metrics.histogram("latency_ms", tenant).observe(0.0)
                fut = Future()
                fut.set_result(list(entry.hits))
                return fut
            with self._stats_lock:
                self.stats.semantic_misses += 1
        if self.admission is not None and not self.admission.admit(tenant):
            with self._stats_lock:
                self.stats.admission_rejected += 1
            raise AdmissionRejected(tenant)
        now = time.monotonic()
        sub = _Submission(
            query=q,
            k=k,
            filter=filter,
            fut=Future(),
            tenant=tenant,
            deadline=now + deadline_ms / 1e3 if deadline_ms is not None else None,
            submitted=now,
        )
        try:
            self._queue.put_nowait(sub)
        except queue_mod.Full:
            with self._stats_lock:
                self.stats.rejected += 1
            self.metrics.counter("queue_rejected", tenant).inc()
            raise
        return sub.fut

    def _snapshot_id(self) -> Optional[int]:
        """The snapshot the next probe resolves: the pinned one of a
        time-travel batcher, else the table's current one; None for a
        coordinator without a catalog."""
        if self.probe_kwargs.get("snapshot_id") is not None:
            return self.probe_kwargs["snapshot_id"]
        catalog = getattr(self.coordinator, "catalog", None)
        if catalog is None:
            return None
        meta = catalog.load_table(self.table_name)
        as_of = self.probe_kwargs.get("as_of_ms")
        snap = meta.snapshot_as_of(as_of) if as_of is not None else meta.current_snapshot()
        return None if snap is None else snap.snapshot_id

    def probe_many(
        self,
        queries,
        k: int = 10,
        filter=None,
        *,
        tenant: str = "default",
        deadline_ms: Optional[float] = None,
    ) -> List[list]:
        """Submit a block of queries and wait for all results (in order)."""
        futs = [
            self.submit(q, k, filter=filter, tenant=tenant, deadline_ms=deadline_ms)
            for q in queries
        ]
        return [f.result() for f in futs]

    # -- drainer ----------------------------------------------------------
    def _drain_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue_mod.Empty:
                continue
            pending = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(pending) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    pending.append(self._queue.get(timeout=remaining))
                except queue_mod.Empty:
                    break
            self._flush(pending)
            if self.adaptive:
                self._adapt(len(pending), self._queue.qsize())

    def _adapt(self, drained: int, queue_depth: int) -> None:
        """Resize ``max_batch`` from observed load: a full drain with
        requests still queued means the window is too small (double it); a
        drain well under the window with an idle queue means it is too
        large (halve it).  Bounded by [min_batch, max_batch_cap]."""
        if drained >= self.max_batch and queue_depth > 0:
            grown = min(self.max_batch * 2, self.max_batch_cap)
            if grown > self.max_batch:
                self.max_batch = grown
                self.stats.grows += 1
        elif queue_depth == 0 and drained <= self.max_batch // 4:
            shrunk = max(self.max_batch // 2, self.min_batch)
            if shrunk < self.max_batch:
                self.max_batch = shrunk
                self.stats.shrinks += 1

    # -- deadline / pressure accounting -----------------------------------
    def _miss_deadline(self, sub: _Submission, now: float) -> None:
        with self._stats_lock:
            self.stats.deadline_misses += 1
        self.metrics.counter("deadline_misses", sub.tenant).inc()
        if not sub.fut.done():
            sub.fut.set_exception(
                DeadlineExceeded(sub.tenant, now - (sub.deadline or now))
            )

    def _pressure(self, pending: List[_Submission], now: float) -> float:
        """Serving pressure in [0, 1]: how full the queue is (drained batch
        + still-queued backlog vs. capacity), escalated when the observed
        batch service time (EMA) eats into the tightest pending deadline."""
        cap = self._max_queue if self._max_queue else 4 * self.max_batch
        p = min(1.0, (len(pending) + self._queue.qsize()) / max(1, cap))
        if self._latency_ema > 0.0:
            headrooms = [s.deadline - now for s in pending if s.deadline is not None]
            if headrooms:
                tightest = max(min(headrooms), 1e-6)
                p = max(p, min(1.0, self._latency_ema / tightest))
        return p

    def _flush(self, pending: list) -> None:
        """Serve one drained batch: a ``batcher.flush`` span (see
        ``serving.metrics``) that ends with every answer on the host, its
        ``queries`` the submissions it sent to a probe and ``wait_s`` their
        summed time in the queue, from submit to this flush's start."""
        with spans.span("batcher.flush") as flush:
            self._flush_pending(pending, flush)

    def _flush_pending(self, pending: list, flush) -> None:
        now = time.monotonic()
        # deadline-aware: already-expired queries are rejected, not served
        # late; the survivors flush earliest-deadline-first (stable within
        # equal deadlines, deadline-free queries keep arrival order last)
        live: List[_Submission] = []
        for sub in pending:
            if sub.deadline is not None and now >= sub.deadline:
                self._miss_deadline(sub, now)
            else:
                live.append(sub)
        if spans.tracing:
            flush.set("queries", len(live))
            flush.set("wait_s", sum(now - sub.submitted for sub in live))
        if not live:
            return
        live.sort(key=lambda s: s.deadline if s.deadline is not None else math.inf)
        degrade = self.degradation is not None and self.force_degrade != "off"
        pressure = 0.0
        if degrade:
            pressure = 1.0 if self.force_degrade == "on" else self._pressure(live, now)
        by_k: Dict[int, List[_Submission]] = {}
        for sub in live:
            by_k.setdefault(sub.k, []).append(sub)
        for k, items in by_k.items():
            queries = np.stack([s.query for s in items])
            filters = [s.filter for s in items]
            any_filtered = any(f is not None for f in filters)
            labels: Tuple[str, ...] = ()
            probe_kwargs = self.probe_kwargs
            k_eff = k
            if degrade:
                params, labels = self.degradation.apply(
                    ProbeParams(
                        k=k,
                        include_tail=self.probe_kwargs.get("include_tail", True),
                    ),
                    pressure,
                )
                if labels:
                    k_eff = params.k
                    probe_kwargs = dict(self.probe_kwargs)
                    probe_kwargs["include_tail"] = params.include_tail
                    if params.oversample is not None:
                        probe_kwargs["oversample"] = params.oversample
            try:
                report = self.coordinator.probe_batch(
                    self.table_name,
                    queries,
                    k_eff,
                    strategy=self.strategy,
                    filter=filters if any_filtered else None,
                    **probe_kwargs,
                )
            except Exception as exc:  # propagate to every waiter
                for s in items:
                    s.fut.set_exception(exc)
                continue
            if labels:
                report.degraded = labels
                for name in labels:
                    self.metrics.counter(f"degraded:{name}").inc()
            done = time.monotonic()
            batch_s = done - now
            self._latency_ema = (
                batch_s
                if self._latency_ema == 0.0
                else 0.8 * self._latency_ema + 0.2 * batch_s
            )
            with self._stats_lock:
                self.stats.batches += 1
                self.stats.queries += len(items)
                self.stats.filtered_queries += sum(
                    1 for f in filters if f is not None
                )
                self.stats.kernel_dispatches += report.kernel_dispatches
                self.stats.shard_cache_hits += getattr(report, "shard_cache_hits", 0)
                self.stats.max_batch_seen = max(self.stats.max_batch_seen, len(items))
                if labels:
                    self.stats.degraded_batches += 1
                    self.stats.degraded_queries += len(items)
            # semantic cache maintenance: the report's snapshot id is the
            # invalidation watermark (a refresh/compaction commit changes
            # it, evicting every answer computed against the old snapshot).
            # Answers are cacheable at the k they were ACTUALLY served at —
            # a shrink_k-degraded answer is keyed under its degraded k_eff
            # so it can never satisfy a later full-k query; other
            # degradation steps (drop_oversample, skip_tail) lower quality
            # at the same k, so those answers are not cached at all.
            cacheable = self.semantic_cache is not None and all(
                lbl.startswith("shrink_k") for lbl in labels
            )
            if self.semantic_cache is not None:
                # belt-and-braces pull path (commits through OTHER
                # coordinators have no hook into this cache); the stats
                # field mirrors the cache's own total either way
                self.semantic_cache.observe_snapshot(
                    getattr(report, "snapshot_id", None)
                )
                with self._stats_lock:
                    self.stats.cache_invalidations = (
                        self.semantic_cache.stats.invalidations
                    )
            for s, hits in zip(items, report.hits):
                # the deadline covers delivery, not just dispatch: a result
                # that completed late is refused, never served silently late
                if s.deadline is not None and done > s.deadline:
                    self._miss_deadline(s, done)
                    continue
                self.metrics.histogram("latency_ms", s.tenant).observe(
                    (done - s.submitted) * 1e3
                )
                self.metrics.counter("served", s.tenant).inc()
                s.fut.set_result(hits)
                if cacheable:
                    ev = self.semantic_cache.put(
                        s.tenant,
                        s.query,
                        k_eff,
                        s.filter,
                        hits,
                        snapshot_id=getattr(report, "snapshot_id", None),
                        report=ProbeReport(
                            hits=[hits],
                            strategy=report.strategy,
                            files_scanned=0,
                            bytes_read=0,
                            cache="semantic",
                            snapshot_id=getattr(report, "snapshot_id", None),
                            degraded=labels,
                        ),
                    )
                    if ev:
                        with self._stats_lock:
                            self.stats.cache_evictions += ev
            self._maybe_compact(report)

    def _maybe_compact(self, report) -> None:
        """Background fresh-tail compaction: when a drained batch served at
        least ``compact_tail_over`` tail rows, fold the tail into the graph
        shards off the serving path.  At most one compaction runs at a
        time; the refresh commit resets the tail, so the trigger naturally
        disarms until enough new appends accumulate.  A compaction that
        fails in the background is recorded in ``stats.compaction_errors``
        / ``stats.last_compaction_error`` — daemon-thread failures must not
        vanish silently."""
        if self.compact_tail_over is None:
            return
        if report.tail_rows < self.compact_tail_over:
            return
        if self._compact_thread is not None and self._compact_thread.is_alive():
            return
        self.stats.compactions += 1

        def _run() -> None:
            try:
                self.coordinator.compact_tail(
                    self.table_name,
                    self.index_name,
                    threshold_rows=self.compact_tail_over,
                )
            except Exception as exc:  # noqa: BLE001 — record, don't crash serving
                with self._stats_lock:
                    self.stats.compaction_errors += 1
                    self.stats.last_compaction_error = f"{type(exc).__name__}: {exc}"
                self.metrics.counter("compaction_errors").inc()

        self._compact_thread = threading.Thread(target=_run, daemon=True)
        self._compact_thread.start()


@dataclass
class ServeConfig:
    knn_lambda: float = 0.25  # kNN-LM interpolation weight
    knn_temperature: float = 1.0
    greedy: bool = True
    param_dtype: str = "bfloat16"  # serving params are bf16 (no masters)


def make_serve_fns(
    model: Model,
    mesh=None,
    rules: Optional[LogicalRules] = None,
    cfg: ServeConfig = ServeConfig(),
    retrieval: Optional[Callable] = None,  # probe fn from make_probe_fn
    index_template=None,  # a DeviceAnnIndex: structure for the index's shardings
    batch_hint: int = 1,
    max_len_hint: int = 1,
    device="cuda",
):
    """The serving steps of ``model`` on ``device`` (CUDA by default; raises
    without a card): ``(prefill_step, serve_step, sample, Shardings)``.

    - ``prefill_step(params, ids, cache)`` → (last-token logits, cache);
    - ``serve_step(params, ids, cache, pos, index=None)`` → (logits, cache):
      one decode step at position ``pos`` (the cache is updated in place),
      kNN-LM-mixed against ``index`` when ``retrieval`` is set and an index
      is given;
    - ``sample(logits, generator=None)`` → tokens: the argmax with
      ``cfg.greedy``, else a categorical draw from ``generator``.

    ``params`` must be stored in ``cfg.param_dtype`` on ``device`` (the
    steps raise otherwise: serving keeps no f32 masters).

    With ``mesh=None`` the steps run eagerly on tensors, and the fourth
    element is ``None``.  On a mesh (a ``DeviceMesh``), as the reference's
    ``jit(in_shardings=...)``: params, cache and ids are placed by ``rules``
    (default :data:`DEFAULT_RULES`) as DTensors at each call (a tensor
    already in its placement is left alone), the cache's placement sized
    by ``batch_hint`` / ``max_len_hint``, the index's by
    ``index_template.shardings(mesh)`` (required with ``retrieval``); the
    steps run under ``implicit_replication`` and return DTensors (the
    cache in its placement).  ``Shardings`` has ``params``, ``cache``,
    ``ids`` and ``index``."""
    dev = concrete_device(device)
    if model.device != dev:
        raise ValueError(f"the model lives on {model.device}, the serving steps on {dev}")
    want = torch_dtype(cfg.param_dtype)

    def check_params(params, path=""):
        for key, leaf in params.items():
            if isinstance(leaf, dict):
                check_params(leaf, f"{path}{key}/")
            elif leaf.dtype != want or leaf.device != dev:
                raise ValueError(f"param {path}{key} is {leaf.dtype} on {leaf.device}; "
                                 f"serving takes {want} on {dev}")

    shardings = None
    if mesh is not None:
        rules = rules or DEFAULT_RULES
        ids_extra = (model.cfg.num_codebooks,) if model.cfg.num_codebooks else ()
        batch_logical = ("batch", "seq") + (("codebook",) if ids_extra else ())

        class Shardings:
            params = logical_to_sharding(model.axes, rules, mesh, shapes_tree=param_shapes(model))
            cache = logical_to_sharding(
                model.cache_axes(batch_hint, max_len_hint), rules, mesh,
                shapes_tree=cache_shapes(model, batch_hint, max_len_hint))
            ids = NamedSharding(mesh, spec_for(batch_logical, rules, mesh,
                                               dim_sizes=(batch_hint, 1) + ids_extra))
            index = None

        if retrieval is not None:
            if index_template is None:
                raise ValueError("retrieval requires index_template for shardings")
            Shardings.index = index_template.shardings(mesh)
        shardings = Shardings

    def as_ids(ids):
        return ids if torch.is_tensor(ids) and ids.device == dev else torch.as_tensor(ids, device=dev)

    def on_mesh(params, ids, cache):
        """The step's inputs in their placements (unchanged without a mesh)."""
        check_params(params)
        ids = as_ids(ids)
        if mesh is None:
            return params, ids, cache
        return (place_tree(params, shardings.params), place(ids, shardings.ids),
                place_tree(cache, shardings.cache))

    def prefill_step(params, ids, cache):
        params, ids, cache = on_mesh(params, ids, cache)
        if mesh is None:
            return model.prefill(params, ids, cache)
        with implicit_replication():
            logits, cache = model.prefill(params, ids, cache)
        return logits, place_tree(cache, shardings.cache)

    def serve_step(params, ids, cache, pos, index=None):
        """One decode step: logits for the new token (+ cache update),
        optionally kNN-LM-interpolated against the ANN index."""
        params, ids, cache = on_mesh(params, ids, cache)
        if mesh is None:
            return _decode(params, ids, cache, pos, index)
        with implicit_replication():
            return _decode(params, ids, cache, pos, index)

    def _decode(params, ids, cache, pos, index):
        logits, cache = model.decode(params, ids, cache, pos)
        if retrieval is None or index is None:
            return logits, cache
        # Query vector: the probability-weighted lm_head embedding of the
        # output distribution ("soft embedding", dim = d_model).  The corpus
        # index is built in the same space, so query and keys are
        # commensurate regardless of architecture family.
        head = params["lm_head"]
        probs = torch.softmax(logits.float(), dim=-1)
        if model.cfg.num_codebooks:
            q = torch.einsum("bscv,cdv->bsd", probs.to(head.dtype), head)[:, 0]
        else:
            q = torch.einsum("bsv,dv->bsd", probs.to(head.dtype), head)[:, 0]
        dists, neigh_tokens = retrieval(index, q)  # (B, k), (B, k)
        if mesh is not None:  # the mesh probe's answer is replicated
            dists, neigh_tokens = dists.to_local(), neigh_tokens.to_local()
        # scatter neighbour tokens into a vocab distribution
        w = torch.softmax(-dists / cfg.knn_temperature, dim=-1)  # (B, k)
        V = logits.shape[-1]
        knn_probs = torch.zeros((q.shape[0], V), dtype=torch.float32, device=dev)
        knn_probs.scatter_add_(1, neigh_tokens.clamp(0, V - 1), w * (neigh_tokens >= 0))
        base = probs[:, 0]
        if model.cfg.num_codebooks:
            knn_probs = knn_probs[:, None, :]
        mixed = (1 - cfg.knn_lambda) * base + cfg.knn_lambda * knn_probs
        return torch.log(torch.clamp(mixed, min=1e-20))[:, None], cache

    def sample(logits, generator: Optional[torch.Generator] = None):
        if is_dtensor(logits):
            logits = logits.full_tensor()
        if cfg.greedy:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float(), dim=-1)
        flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
        return flat.reshape(probs.shape[:-1])

    return prefill_step, serve_step, sample, shardings
