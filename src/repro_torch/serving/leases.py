"""Leased shard assignment for stateless executors.

The coordinator's shard→executor placement becomes explicit, expiring
state: a :class:`LeaseTable` maps each shard key (the fragment's
``cache_key`` — puffin path + shard id) to an ordered set of lease holders
with per-holder expiry times.  Executors renew their leases by
heartbeating through the scheduler's poll loop; a holder that stops
heartbeating (crash, kill, network partition) simply ages out after
``ttl`` — or is lapsed immediately via :meth:`expire_holder` when the
scheduler observes the death first.

Because executors are stateless (every shard byte lives in the object
store behind the snapshot), a lease is *permission to serve*, not
ownership of data: re-granting a lapsed lease to a survivor is always
safe — the replacement re-reads the shard from the Puffin blob and
produces the identical answer.  The table therefore optimizes for cache
affinity, not correctness:

- **Replication** — ``ensure`` tops every lease up to ``replicas``
  holders (primary first), so a single death never leaves a shard
  without a warm candidate.
- **Hot-shard replication** — shards whose dispatch count crosses
  ``hot_dispatches`` get one extra holder (up to ``max_holders``), so a
  hot shard's traffic can spread instead of serializing behind one
  executor's cache.

Pure stdlib; unit-testable with an injected clock.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from repro_torch.serving.metrics import MetricsRegistry


@dataclass
class Lease:
    """One shard's lease: ordered holders (primary first) + expiries."""

    shard_key: str
    holders: List[str] = field(default_factory=list)
    expires: Dict[str, float] = field(default_factory=dict)
    dispatches: int = 0

    def valid_holders(self, now: float) -> List[str]:
        return [h for h in self.holders if self.expires.get(h, 0.0) > now]


class LeaseTable:
    """Expiring shard→executors assignment with replication.

    All methods are thread-safe; the scheduler calls :meth:`renew` from its
    poll loop (driven by live-executor heartbeats), :meth:`ensure` at
    dispatch time, and :meth:`expire_holder` the moment a dispatch observes
    ``ExecutorDead``.
    """

    def __init__(
        self,
        *,
        ttl: float = 0.5,
        replicas: int = 2,
        hot_dispatches: int = 32,
        max_holders: int = 4,
        clock: Callable[[], float] = time.monotonic,
        metrics: Optional[MetricsRegistry] = None,
    ) -> None:
        self.ttl = float(ttl)
        self.replicas = max(1, replicas)
        self.hot_dispatches = hot_dispatches
        self.max_holders = max(self.replicas, max_holders)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._clock = clock
        self._lock = threading.Lock()
        self._leases: Dict[str, Lease] = {}
        self._by_holder: Dict[str, Set[str]] = {}

    # -- grant / renew / expire -------------------------------------------
    def ensure(
        self,
        shard_key: str,
        candidates: List[str],
        *,
        now: Optional[float] = None,
    ) -> Lease:
        """Grant or top up the lease for ``shard_key`` from ``candidates``
        (live executor ids).  Tops holders up to ``replicas`` (+1 once the
        shard runs hot), preferring the least-leased candidates so load
        spreads.  Counts the dispatch for hotness tracking."""
        now = self._clock() if now is None else now
        with self._lock:
            lease = self._leases.get(shard_key)
            if lease is None:
                lease = self._leases[shard_key] = Lease(shard_key)
            lease.dispatches += 1
            target = self.replicas + (1 if lease.dispatches > self.hot_dispatches else 0)
            target = min(target, self.max_holders, max(1, len(candidates)))
            valid = set(lease.valid_holders(now))
            # age out lapsed holders (keeps the primary slot meaningful)
            for h in list(lease.holders):
                if h not in valid:
                    lease.holders.remove(h)
                    lease.expires.pop(h, None)
                    self._by_holder.get(h, set()).discard(shard_key)
                    self.metrics.counter("lease_expiries").inc()
            fresh = [c for c in candidates if c not in valid]
            fresh.sort(key=lambda c: len(self._by_holder.get(c, ())))
            for c in fresh[: max(0, target - len(lease.holders))]:
                lease.holders.append(c)
                lease.expires[c] = now + self.ttl
                self._by_holder.setdefault(c, set()).add(shard_key)
                self.metrics.counter("lease_grants").inc()
            return lease

    def renew(self, executor_id: str, *, now: Optional[float] = None) -> None:
        """Heartbeat: extend every lease this executor holds."""
        now = self._clock() if now is None else now
        with self._lock:
            for key in self._by_holder.get(executor_id, ()):  # pragma: no branch
                lease = self._leases.get(key)
                if lease is not None and executor_id in lease.expires:
                    lease.expires[executor_id] = now + self.ttl
            self.metrics.counter("lease_renewals").inc()

    def expire_holder(self, executor_id: str) -> int:
        """Lapse every lease held by ``executor_id`` immediately (the
        scheduler observed its death before the TTL did).  Returns how many
        leases lapsed."""
        with self._lock:
            keys = self._by_holder.pop(executor_id, set())
            lapsed = 0
            for key in keys:
                lease = self._leases.get(key)
                if lease is not None and executor_id in lease.holders:
                    lease.holders.remove(executor_id)
                    lease.expires.pop(executor_id, None)
                    lapsed += 1
            if lapsed:
                self.metrics.counter("lease_expiries").inc(lapsed)
            return lapsed

    # -- queries ----------------------------------------------------------
    def now(self) -> float:
        return self._clock()

    def valid_holders(self, shard_key: str, *, now: Optional[float] = None) -> List[str]:
        now = self._clock() if now is None else now
        with self._lock:
            lease = self._leases.get(shard_key)
            return lease.valid_holders(now) if lease is not None else []

    def holder_load(self, executor_id: str) -> int:
        with self._lock:
            return len(self._by_holder.get(executor_id, ()))

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """JSON-able view of the table (for logs / debugging / tests)."""
        now = self._clock()
        with self._lock:
            return {
                key: {
                    "holders": list(lease.holders),
                    "valid": lease.valid_holders(now),
                    "dispatches": lease.dispatches,
                }
                for key, lease in self._leases.items()
            }
