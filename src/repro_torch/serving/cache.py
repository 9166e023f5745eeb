"""Serving-tier cache hierarchy: snapshot-keyed, byte-bounded, two layers.

Real query streams are Zipfian — a handful of hot queries dominates — but
a compute-disaggregated engine recomputes every mask, shard probe, and
rerank from scratch on every wave.  With stateless executors and all
durable state in object storage, the compute side is the only place a
cache can live (the SHINE / d-HNSW move).  The snapshot id gives us an
exact, zero-cost invalidation token: index + data are a pure function of
the snapshot, so an entry keyed by snapshot id can never be stale for
that snapshot, and a refresh/compaction commit (which installs a NEW
random id) invalidates by key mismatch alone.

Two layers:

- :class:`ShardProbeCache` — cross-batch Stage-A cache owned by the
  coordinator.  Key: ``(table, snapshot_id, shard_id, predicate, probe
  params, plan op, query digest)``; value: that shard's candidate list
  (ids + approximate distances).  A hit skips mask evaluation AND the
  kernel dispatch for that (query, shard) fragment; the cached
  candidates re-merge through the unchanged Stage-A merge, so final hits
  are bit-identical to the uncached path by construction.

- :class:`SemanticResultCache` — whole-answer cache in front of
  ``ProbeMicroBatcher.submit`` (the redisvl ``SessionManager`` shape):
  answer from a prior result when the L2 distance between query vectors
  is under a per-index threshold, with an exact-duplicate fast path.
  Entries are scoped per tenant and per ``(k, filter)``, and carry the
  snapshot id they were computed against; a snapshot-id change observed
  on any later report evicts every entry from the old snapshot.

Both caches are thread-safe bounded LRUs with byte-size accounting and
hit/miss/eviction/invalidation counters, optionally mirrored into a
:class:`repro_torch.serving.metrics.MetricsRegistry`.

Snapshot ids are *random* (``new_snapshot_id``), not monotone —
invalidation is always "id changed", never an ordering comparison, which
is also what keeps time travel safe: a probe of an old snapshot carries
the old id in its keys and can never alias a newer snapshot's entries.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "CacheStats",
    "SemanticCacheEntry",
    "SemanticResultCache",
    "ShardCacheEntry",
    "ShardProbeCache",
    "query_digest",
]


def query_digest(vec: np.ndarray) -> bytes:
    """Content digest of one query vector (float32 bytes, exact)."""
    q = np.ascontiguousarray(vec, dtype=np.float32)
    return hashlib.sha1(q.tobytes()).digest()


@dataclass
class CacheStats:
    """Counters one cache layer maintains (also mirrored to metrics)."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0      # LRU byte-budget pressure
    invalidations: int = 0  # snapshot-id change

    def snapshot(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
        }


@dataclass
class ShardCacheEntry:
    """One shard's Stage-A candidate list for one (query, predicate, params)."""

    candidates: List[Any]  # List[fragments.ProbeCandidate]
    table_name: str
    snapshot_id: int
    served_by: str         # executor that computed the fragment originally
    nbytes: int


def _candidates_nbytes(candidates: List[Any]) -> int:
    # ProbeCandidate: file_path str + row_group/row_offset/vec_id/shard_id
    # ints + one float; ~64 bytes of payload plus the path.
    n = 64  # entry overhead
    for c in candidates:
        n += 64 + len(getattr(c, "file_path", ""))
    return n


class ShardProbeCache:
    """Cross-batch Stage-A shard-probe cache (coordinator-side).

    Bounded LRU with byte accounting.  Keys are opaque tuples built by the
    coordinator — ``(table, snapshot_id, shard_id, predicate, (k, L,
    use_pq, oversample), plan_op, query_digest)`` — so a hit is only ever
    possible for the *same* snapshot, predicate, search parameters, and
    exact query vector, which is what makes re-merging the cached
    candidates bit-identical to recomputing them.
    """

    def __init__(self, max_bytes: int = 16 << 20, metrics: Any = None):
        self.max_bytes = int(max_bytes)
        self.metrics = metrics  # MetricsRegistry or None
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, ShardCacheEntry]" = OrderedDict()
        self._total_bytes = 0

    # -- introspection -------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes

    def entries_snapshot(self) -> List[Tuple[tuple, ShardCacheEntry]]:
        """Copy of (key, entry) pairs, LRU → MRU order (for tests)."""
        with self._lock:
            return list(self._entries.items())

    # -- core ----------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        if self.metrics is not None and n:
            self.metrics.counter(f"shard_cache_{name}").inc(n)

    def get(self, key: tuple) -> Optional[ShardCacheEntry]:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                self.stats.misses += 1
            else:
                self._entries.move_to_end(key)
                self.stats.hits += 1
        self._count("hits" if ent is not None else "misses")
        return ent

    def put(
        self,
        key: tuple,
        candidates: List[Any],
        *,
        table_name: str,
        snapshot_id: int,
        served_by: str,
    ) -> int:
        """Insert one shard's candidate list; returns evictions caused."""
        nbytes = _candidates_nbytes(candidates)
        if nbytes > self.max_bytes:
            return 0  # would evict the whole cache for one entry
        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._total_bytes -= old.nbytes
            self._entries[key] = ShardCacheEntry(
                candidates=list(candidates),
                table_name=table_name,
                snapshot_id=int(snapshot_id),
                served_by=served_by,
                nbytes=nbytes,
            )
            self._total_bytes += nbytes
            while self._total_bytes > self.max_bytes and self._entries:
                _, victim = self._entries.popitem(last=False)
                self._total_bytes -= victim.nbytes
                evicted += 1
            self.stats.evictions += evicted
        self._count("evictions", evicted)
        return evicted

    def invalidate(self, table_name: str, current_snapshot_id: int) -> int:
        """Drop every entry for ``table_name`` whose snapshot id differs
        from the just-committed one.  Ids are random, so this is a pure
        identity check — never an ordering comparison.  Returns the count.
        """
        dropped = 0
        with self._lock:
            stale = [
                k
                for k, e in self._entries.items()
                if e.table_name == table_name
                and e.snapshot_id != int(current_snapshot_id)
            ]
            for k in stale:
                ent = self._entries.pop(k)
                self._total_bytes -= ent.nbytes
                dropped += 1
            self.stats.invalidations += dropped
        self._count("invalidations", dropped)
        return dropped

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._total_bytes = 0


@dataclass
class SemanticCacheEntry:
    """One cached whole answer, scoped to (tenant, k, filter)."""

    tenant: str
    query: np.ndarray       # float32, flat — kept for the distance check
    digest: bytes           # exact-duplicate fast path
    k: int
    filter_key: Any
    snapshot_id: Optional[int]
    hits: List[Any]         # the served per-query hit list
    report: Any = None      # minimal ProbeReport with cache="semantic"
    nbytes: int = 0
    served_hits: int = field(default=0)  # times this entry answered a query


class SemanticResultCache:
    """Whole-answer cache keyed by query *meaning*, not just bytes.

    ``lookup`` first tries the exact-duplicate digest, then scans the
    (tenant, k, filter) scope for a cached query vector within
    ``distance_threshold`` (L2).  Entries only serve while their snapshot
    id matches the watermark — the snapshot id carried by the most recent
    probe report ``observe_snapshot`` saw.  When the watermark changes
    (refresh/compaction committed), every entry from another snapshot is
    evicted and counted as an invalidation.
    """

    def __init__(
        self,
        max_bytes: int = 8 << 20,
        distance_threshold: float = 0.0,
        metrics: Any = None,
    ):
        self.max_bytes = int(max_bytes)
        self.distance_threshold = float(distance_threshold)
        self.metrics = metrics
        self.stats = CacheStats()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, SemanticCacheEntry]" = OrderedDict()
        self._scopes: Dict[tuple, "OrderedDict[tuple, None]"] = {}
        self._total_bytes = 0
        self._watermark: Optional[int] = None

    # -- introspection -------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self._total_bytes

    @property
    def watermark(self) -> Optional[int]:
        with self._lock:
            return self._watermark

    # -- helpers -------------------------------------------------------
    @staticmethod
    def _scope(tenant: str, k: int, filter_key: Any) -> tuple:
        return (tenant, int(k), filter_key)

    def _count(self, name: str, n: int = 1, tenant: Optional[str] = None) -> None:
        if self.metrics is not None and n:
            self.metrics.counter(f"semantic_cache_{name}", tenant).inc(n)

    def _drop_locked(self, key: tuple) -> None:
        ent = self._entries.pop(key, None)
        if ent is None:
            return
        self._total_bytes -= ent.nbytes
        scope = self._scopes.get(self._scope(ent.tenant, ent.k, ent.filter_key))
        if scope is not None:
            scope.pop(key, None)
            if not scope:
                self._scopes.pop(self._scope(ent.tenant, ent.k, ent.filter_key), None)

    # -- core ----------------------------------------------------------
    def observe_snapshot(self, snapshot_id: Optional[int]) -> int:
        """Feed the snapshot id a fresh probe report resolved against.

        First sighting pins the watermark; a *changed* id evicts every
        entry from another snapshot and moves the watermark.  Returns the
        number of entries invalidated.
        """
        if snapshot_id is None:
            return 0
        sid = int(snapshot_id)
        dropped = 0
        with self._lock:
            if self._watermark == sid:
                return 0
            self._watermark = sid
            stale = [
                k for k, e in self._entries.items() if e.snapshot_id != sid
            ]
            for k in stale:
                self._drop_locked(k)
                dropped += 1
            self.stats.invalidations += dropped
        self._count("invalidations", dropped)
        return dropped

    def lookup(
        self, tenant: str, query: np.ndarray, k: int, filter_key: Any
    ) -> Optional[SemanticCacheEntry]:
        q = np.ascontiguousarray(query, dtype=np.float32).reshape(-1)
        dig = hashlib.sha1(q.tobytes()).digest()
        scope_key = self._scope(tenant, k, filter_key)
        with self._lock:
            wm = self._watermark
            exact = (scope_key, dig)
            ent = self._entries.get(exact)
            if ent is not None and (wm is None or ent.snapshot_id == wm):
                self._entries.move_to_end(exact)
                ent.served_hits += 1
                self.stats.hits += 1
                hit = ent
            else:
                hit = None
                if self.distance_threshold > 0.0:
                    scope = self._scopes.get(scope_key)
                    if scope:
                        best = None
                        best_d = self.distance_threshold
                        for key in scope:
                            cand = self._entries[key]
                            if wm is not None and cand.snapshot_id != wm:
                                continue
                            if cand.query.shape != q.shape:
                                continue
                            d = float(np.linalg.norm(cand.query - q))
                            if d <= best_d:
                                best, best_d = key, d
                        if best is not None:
                            self._entries.move_to_end(best)
                            hit = self._entries[best]
                            hit.served_hits += 1
                            self.stats.hits += 1
                if hit is None:
                    self.stats.misses += 1
        self._count("hits" if hit is not None else "misses", tenant=tenant)
        return hit

    def put(
        self,
        tenant: str,
        query: np.ndarray,
        k: int,
        filter_key: Any,
        hits: List[Any],
        *,
        snapshot_id: Optional[int],
        report: Any = None,
    ) -> int:
        """Cache one served answer under the k it was *actually* answered
        at (a degraded ``shrink_k`` answer is keyed by its degraded k, so
        it can never satisfy a later full-k query).  Returns evictions.
        """
        try:
            hash(filter_key)
        except TypeError:
            return 0  # unhashable filter — not cacheable, never wrong
        q = np.ascontiguousarray(query, dtype=np.float32).reshape(-1)
        dig = hashlib.sha1(q.tobytes()).digest()
        nbytes = q.nbytes + 128 + _candidates_nbytes(hits)
        if nbytes > self.max_bytes:
            return 0
        scope_key = self._scope(tenant, k, filter_key)
        key = (scope_key, dig)
        evicted = 0
        with self._lock:
            self._drop_locked(key)
            ent = SemanticCacheEntry(
                tenant=tenant,
                query=q.copy(),
                digest=dig,
                k=int(k),
                filter_key=filter_key,
                snapshot_id=None if snapshot_id is None else int(snapshot_id),
                hits=list(hits),
                report=report,
                nbytes=nbytes,
            )
            self._entries[key] = ent
            self._scopes.setdefault(scope_key, OrderedDict())[key] = None
            self._total_bytes += nbytes
            while self._total_bytes > self.max_bytes and self._entries:
                victim_key = next(iter(self._entries))
                self._drop_locked(victim_key)
                evicted += 1
            self.stats.evictions += evicted
        self._count("evictions", evicted, tenant=tenant)
        return evicted

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._scopes.clear()
            self._total_bytes = 0
