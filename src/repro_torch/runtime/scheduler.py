"""Cache-aware scheduler with failure recovery and straggler mitigation.

Responsibilities (DESIGN.md §6):

- **Cache-aware placement** — tasks carry a ``cache_key``; executors that
  already hold the key (L1 or SSD) are preferred, mirroring the paper's
  "cache-aware scheduler" reuse (§3.1, §5).
- **Failure recovery** — a heartbeat monitor marks dead executors; their
  in-flight fragments are reassigned (attempt+1) to survivors.  Completed
  shard blobs are durable in the object store, so reassignment is
  idempotent: tasks write to deterministic output paths.
- **Straggler mitigation** — speculative backup tasks: once half the wave is
  done, any task running longer than ``speculation_factor ×`` the median
  completed latency is duplicated onto an idle executor; first finisher
  wins, the loser's (identical) output is dropped.  The wave returns once
  a loser that is computing has finished (one still asleep in a failure
  gate is left there: past the gate it computes nothing).
- **Elasticity** — executors can be added/removed between (or during)
  waves; the dispatch loop only consults the live set.
- **Leased placement** — shard→executor affinity is explicit, expiring
  state in a :class:`repro_torch.serving.leases.LeaseTable`: live executors renew
  their leases from the poll loop, dispatch prefers valid lease holders
  (replicated ≥2 per shard), and a fragment whose executor's lease lapsed
  mid-wave — death observed by heartbeat or by ``ExecutorDead`` at task
  entry — is re-dispatched to a surviving holder
  (``stats.redispatches``).  Safe because executors are stateless: the
  survivor re-reads the shard from the Puffin blob and produces the
  identical result.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.runtime import fragments as F
from repro_torch.runtime.executor import Executor, ExecutorDead, InjectedFailure
from repro_torch.serving.leases import LeaseTable
from repro_torch.serving.metrics import MetricsRegistry


@dataclass
class SchedulerStats:
    dispatched: int = 0
    reassigned: int = 0
    speculative: int = 0
    failures_seen: int = 0
    cache_preferred_hits: int = 0
    # batched-probe coalescing: fragments offered to run_coalesced_wave vs
    # fragments eliminated by merging same-shard probes
    probe_fragments_offered: int = 0
    probe_fragments_coalesced: int = 0
    # fragments re-dispatched to a survivor because their executor's lease
    # lapsed (executor died mid-wave, seen via heartbeat or ExecutorDead)
    redispatches: int = 0
    # dispatches that preferred a valid lease holder for the fragment's shard
    lease_preferred_hits: int = 0


class ExecutorPool:
    """Live executor set with heartbeat checks."""

    def __init__(self, executors: List[Executor]) -> None:
        self._lock = threading.Lock()
        self._executors: Dict[str, Executor] = {e.executor_id: e for e in executors}

    def add(self, executor: Executor) -> None:
        with self._lock:
            self._executors[executor.executor_id] = executor

    def remove(self, executor_id: str) -> None:
        with self._lock:
            self._executors.pop(executor_id, None)

    def live(self) -> List[Executor]:
        with self._lock:
            return [e for e in self._executors.values() if e.heartbeat()]

    def all(self) -> List[Executor]:
        with self._lock:
            return list(self._executors.values())

    def get(self, executor_id: str) -> Optional[Executor]:
        with self._lock:
            return self._executors.get(executor_id)


@dataclass
class _Attempt:
    task_index: int
    executor: Executor
    thread: threading.Thread
    started: float
    speculative: bool = False
    # set, under the wave's lock, once this attempt's fragment has been
    # re-dispatched elsewhere (its executor died mid-wave), by the monitor
    # or by the attempt's own ``ExecutorDead``: whichever comes second
    # requeues nothing
    abandoned: bool = False
    # set, under the wave's lock, once the attempt passed its executor's
    # failure gates with its fragment still open: it now runs torch ops
    computing: bool = False


class Scheduler:
    def __init__(
        self,
        pool: ExecutorPool,
        *,
        max_attempts: int = 4,
        enable_speculation: bool = False,
        speculation_factor: float = 3.0,
        poll_interval: float = 0.005,
        lease_table: Optional[LeaseTable] = None,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.pool = pool
        self.max_attempts = max_attempts
        self.enable_speculation = enable_speculation
        self.speculation_factor = speculation_factor
        self.poll_interval = poll_interval
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.leases = (
            lease_table if lease_table is not None else LeaseTable(metrics=self.metrics)
        )
        self.stats = SchedulerStats()

    def run_coalesced_wave(self, tasks: List[object]) -> List[object]:
        """Coalesce batchable shard-probe fragments, then dispatch the wave.

        Per-(query, shard) probe fragments targeting the same shard blob with
        the same search parameters merge into a single fragment carrying the
        stacked query block — ≤ one dispatch per shard for a whole batch
        instead of B × shards.  Results align to the MERGED fragment list."""
        merged = F.coalesce_batch_probes(tasks)
        self.stats.probe_fragments_offered += len(tasks)
        self.stats.probe_fragments_coalesced += len(tasks) - len(merged)
        return self.run_wave(merged)

    def run_wave(self, tasks: List[object]) -> List[object]:
        """Dispatch a wave of fragments; returns results aligned to tasks.

        Raises RuntimeError if any task exhausts ``max_attempts`` or the
        executor pool dies entirely.
        """
        n = len(tasks)
        results: List[Optional[object]] = [None] * n
        done = [False] * n
        attempts_count = [0] * n
        pending: "queue.Queue[int]" = queue.Queue()
        for i in range(n):
            pending.put(i)
        inflight: List[_Attempt] = []
        completed_latencies: List[float] = []
        lock = threading.Lock()
        errors: List[str] = []

        def start(att: _Attempt) -> bool:
            with lock:
                att.computing = not done[att.task_index]
                return att.computing

        def run_one(idx: int, executor: Executor, speculative: bool, attempt_obj: list):
            try:
                out = executor.handle(tasks[idx], wanted=lambda: start(attempt_obj[0]))
                with lock:
                    if not done[idx]:
                        done[idx] = True
                        results[idx] = out
                        completed_latencies.append(time.time() - attempt_obj[0].started)
            except (ExecutorDead, InjectedFailure, Exception) as exc:  # noqa: BLE001
                if isinstance(exc, ExecutorDead):
                    # the holder died mid-wave: lapse its leases immediately
                    # so no later pick in this wave prefers it
                    executor.kill()
                    self.leases.expire_holder(executor.executor_id)
                with lock:
                    self.stats.failures_seen += 1
                    att = attempt_obj[0]
                    if not done[idx]:
                        attempts_count[idx] += 1
                        if attempts_count[idx] >= self.max_attempts:
                            errors.append(f"task {idx} failed {attempts_count[idx]}x: {exc!r}")
                            done[idx] = True  # give up; surfaced below
                        elif not att.abandoned:
                            # a death the monitor already re-dispatched is
                            # not requeued again: that third attempt would
                            # still be computing torch ops when the wave
                            # returns, and a torch op in a thread that the
                            # interpreter's exit catches aborts the process
                            att.abandoned = True
                            self.stats.reassigned += 1
                            if isinstance(exc, ExecutorDead):
                                self.stats.redispatches += 1
                                self.metrics.counter("redispatches").inc()
                            pending.put(idx)

        busy: Dict[str, int] = {}

        def pick_executor(idx: int) -> Optional[Executor]:
            live_all = self.pool.live()
            live = [e for e in live_all if busy.get(e.executor_id, 0) == 0]
            if not live:
                return None
            key = getattr(tasks[idx], "cache_key", None)
            if key:
                # lease-checked dispatch: top the shard's lease up to its
                # replica target from the whole live set, then prefer a free
                # valid holder (cached holders first, else primary order)
                lease = self.leases.ensure(key, [e.executor_id for e in live_all])
                holders = lease.valid_holders(self.leases._clock())
                holding = [e for e in live if e.executor_id in holders]
                if holding:
                    self.stats.lease_preferred_hits += 1
                    cached = [e for e in holding if e.has_cached(key)]
                    if cached:
                        self.stats.cache_preferred_hits += 1
                        return cached[0]
                    return min(holding, key=lambda e: holders.index(e.executor_id))
                cached = [e for e in live if e.has_cached(key)]
                if cached:
                    self.stats.cache_preferred_hits += 1
                    return cached[0]
            # least-loaded by completed count for spread
            return min(live, key=lambda e: e.tasks_done)

        while True:
            with lock:
                all_done = all(done)
            if all_done:
                break
            live_now = self.pool.live()
            if not live_now:
                raise RuntimeError("entire executor pool is dead")
            # heartbeats renew leases; executors that stopped answering age out
            for e in live_now:
                self.leases.renew(e.executor_id)
            # reap finished attempts; re-dispatch fragments whose executor
            # died while holding them (lease lapsed mid-wave) — safe because
            # executors are stateless, so the survivor recomputes the
            # identical result and done-first-wins dedupes
            for att in list(inflight):
                if not att.thread.is_alive():
                    busy[att.executor.executor_id] = max(
                        0, busy.get(att.executor.executor_id, 0) - 1
                    )
                    inflight.remove(att)
                elif not att.abandoned and not att.executor.heartbeat():
                    self.leases.expire_holder(att.executor.executor_id)
                    with lock:
                        if att.abandoned or done[att.task_index]:
                            continue
                        att.abandoned = True
                        self.stats.redispatches += 1
                    self.metrics.counter("redispatches").inc()
                    pending.put(att.task_index)
            # dispatch pending
            try:
                while True:
                    idx = pending.get_nowait()
                    with lock:
                        if done[idx]:
                            continue
                    ex = pick_executor(idx)
                    if ex is None:
                        pending.put(idx)
                        break
                    holder: list = []
                    th = threading.Thread(
                        target=run_one, args=(idx, ex, False, holder), daemon=True
                    )
                    att = _Attempt(idx, ex, th, time.time())
                    holder.append(att)
                    busy[ex.executor_id] = busy.get(ex.executor_id, 0) + 1
                    inflight.append(att)
                    self.stats.dispatched += 1
                    th.start()
            except queue.Empty:
                pass
            # speculation
            if self.enable_speculation and completed_latencies:
                with lock:
                    frac_done = sum(done) / n
                if frac_done >= 0.5:
                    lat = sorted(completed_latencies)
                    median = lat[len(lat) // 2]
                    for att in list(inflight):
                        if att.speculative:
                            continue
                        with lock:
                            if done[att.task_index]:
                                continue
                        if time.time() - att.started > self.speculation_factor * max(
                            median, 1e-3
                        ):
                            ex = pick_executor(att.task_index)
                            if ex is not None and ex is not att.executor:
                                holder = []
                                th = threading.Thread(
                                    target=run_one,
                                    args=(att.task_index, ex, True, holder),
                                    daemon=True,
                                )
                                spec = _Attempt(att.task_index, ex, th, time.time(), True)
                                holder.append(spec)
                                busy[ex.executor_id] = busy.get(ex.executor_id, 0) + 1
                                inflight.append(spec)
                                att.speculative = True  # don't re-speculate
                                self.stats.speculative += 1
                                th.start()
            time.sleep(self.poll_interval)
        # A wave owns the threads it starts.  A loser still running torch
        # ops (a speculative pair's slower half, or an attempt whose
        # executor was declared dead while it computed) is waited for: a
        # torch op still running when the interpreter exits aborts the
        # process.  An attempt still in a failure gate (a straggler's
        # delay, a held kill) is not: past the gate it computes nothing.
        with lock:
            losers = [att.thread for att in inflight if att.computing]
        for th in losers:
            th.join()
        if errors:
            raise RuntimeError("; ".join(errors))
        return results  # type: ignore[return-value]
