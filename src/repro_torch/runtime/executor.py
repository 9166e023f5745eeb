"""Executor process model (paper §3.1): stateless worker + SSD/L1 caches.

Port of ``repro/runtime/executor.py``, unfiltered slice.  An executor owns:

- an **SSD cache** directory keyed by ``(object_path, credential_fingerprint,
  byte_range, etag)`` — raw blob bytes survive across tasks and are safe to
  lose (the object store is the source of truth);
- an **L1 cache** of deserialized Vamana graphs (bounded LRU);
- a ``device`` its kernels run on (CUDA by default; ``"cpu"`` runs the
  plain PyTorch versions);
- task handlers for partition scan, shard build, unfiltered shard probe and
  exact rerank.  Batched probes, fresh-tail scans, refreshes and predicates
  raise ``NotImplementedError`` naming the ROADMAP item that ports them.

Failure-injection hooks (``kill()``, ``fail_next()``, ``delay_next()``,
``kill_next()``) drive the scheduler's fault-tolerance paths.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blobs import ShardLocationMap, decode_shard_blob, encode_shard_blob
from repro_torch.core.pq import PQCodebook, encode as pq_encode
from repro_torch.core.vamana import VamanaGraph, VamanaParams, build_vamana
from repro_torch.iceberg.puffin import _decompress  # codec shared with Puffin blobs
from repro_torch.kernels import ops
from repro_torch.kernels.device_cache import resolve_device, to_device
from repro_torch.lakehouse.objectstore import ObjectStore
from repro_torch.lakehouse.vparquet import VParquetReader
from repro_torch.runtime import fragments as F


class ExecutorDead(RuntimeError):
    """Raised when a task lands on a dead executor (heartbeat timeout)."""


class InjectedFailure(RuntimeError):
    """Deterministic task failure for tests."""


def _scan_files_with_locations(
    store: ObjectStore, files: List[str]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Read the vector column of ``files`` with per-row locations.

    Returns (vectors, file_idx, row_group, row_offset, file_paths)."""
    vecs: List[np.ndarray] = []
    fidx: List[np.ndarray] = []
    rgrp: List[np.ndarray] = []
    roff: List[np.ndarray] = []
    for i, path in enumerate(files):
        r = VParquetReader.from_store(store, path)
        for rg_id, rg in enumerate(r.row_groups):
            arr = r.read_column("vec", [rg_id])
            n = arr.shape[0]
            vecs.append(arr)
            fidx.append(np.full(n, i, np.uint32))
            rgrp.append(np.full(n, rg_id, np.uint32))
            roff.append(np.arange(n, dtype=np.uint32))
    if not vecs:
        return (
            np.empty((0, 0), np.float32),
            np.empty(0, np.uint32),
            np.empty(0, np.uint32),
            np.empty(0, np.uint32),
            list(files),
        )
    return (
        np.concatenate(vecs),
        np.concatenate(fidx),
        np.concatenate(rgrp),
        np.concatenate(roff),
        list(files),
    )


def _locmap_membership(
    locmap: ShardLocationMap, n: int, live: Optional[np.ndarray] = None
) -> List[Tuple[str, int]]:
    """Distinct (file_path, row_group) pairs a shard's (live) rows occupy —
    the zone-map membership used for coordinator-side shard pruning."""
    fidx = np.asarray(locmap.file_idx[:n], np.int64)
    rgrp = np.asarray(locmap.row_group[:n], np.int64)
    if live is not None:
        fidx, rgrp = fidx[live[:n]], rgrp[live[:n]]
    pairs = np.unique(np.stack([fidx, rgrp], axis=1), axis=0)
    return sorted((locmap.file_paths[int(f)], int(g)) for f, g in pairs)


def _partition_of(
    vectors: np.ndarray, centroids: np.ndarray, device: torch.device
) -> np.ndarray:
    """Nearest partition centroid of every vector (the kmeans_assign kernel
    on the card; the reference pins its plain version)."""
    part, _ = ops.kmeans_assign(
        to_device(vectors, device),
        to_device(centroids, device),
        backend="auto",
    )
    return part.cpu().numpy()


def _owner_shards(
    vectors: np.ndarray,
    centroids: np.ndarray,
    shard_of_partition: np.ndarray,
    device: torch.device,
) -> np.ndarray:
    return shard_of_partition[_partition_of(vectors, centroids, device)]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1, {item})"
    )


class Executor:
    def __init__(
        self,
        executor_id: str,
        store: ObjectStore,
        cache_dir: str,
        *,
        l1_capacity: int = 4,
        credential_fingerprint: str = "default-cred",
        device="cuda",
    ) -> None:
        self.executor_id = executor_id
        self.store = store
        self.cache_dir = cache_dir
        self.device = resolve_device(device)
        os.makedirs(cache_dir, exist_ok=True)
        self.cred = credential_fingerprint
        self._l1: "OrderedDict[str, Tuple[VamanaGraph, ShardLocationMap]]" = OrderedDict()
        self._l1_capacity = l1_capacity
        self._lock = threading.Lock()
        # failure injection
        self.dead = False
        self._fail_budget = 0
        self._delay_next = 0.0
        self._kill_mid_task = 0
        self._kill_hold_s = 0.0
        # metrics
        self.tasks_done = 0
        self.cache_hits = 0
        self.cache_misses = 0
        # dispatch tallies, as the reference keeps them: masked top-k kernel
        # calls and the filtered path's gather-rerank pool reranks,
        # executor-wide plus a per-task thread-local count (each task attempt
        # runs on its own scheduler thread).  The unfiltered path this slice
        # ports issues neither, so they stay 0 until the filtered slice.
        self.masked_kernel_dispatches = 0
        self.rerank_kernel_dispatches = 0
        self._dispatch_tls = threading.local()

    # -- health -----------------------------------------------------------
    def heartbeat(self) -> bool:
        return not self.dead

    def kill(self) -> None:
        self.dead = True

    def revive(self) -> None:
        self.dead = False
        self._kill_mid_task = 0  # disarm any unspent chaos budget

    def fail_next(self, count: int = 1) -> None:
        self._fail_budget = count

    def delay_next(self, seconds: float) -> None:
        self._delay_next = seconds

    def kill_next(self, count: int = 1, *, hold_s: float = 0.0) -> None:
        """Chaos hook: die while HOLDING the next ``count`` accepted tasks
        (heartbeat goes dark mid-task for ``hold_s``, then the result is
        lost with ``ExecutorDead``)."""
        self._kill_mid_task = count
        self._kill_hold_s = hold_s

    def _gate(self) -> None:
        if self.dead:
            raise ExecutorDead(self.executor_id)
        if self._fail_budget > 0:
            self._fail_budget -= 1
            raise InjectedFailure(f"injected failure on {self.executor_id}")
        if self._delay_next > 0:
            d, self._delay_next = self._delay_next, 0.0
            time.sleep(d)

    # -- SSD cache ------------------------------------------------------------
    def _cache_path(self, object_path: str, offset: int, length: int) -> str:
        etag = ""
        try:
            etag = self.store.stat(object_path).etag
        except Exception:
            pass
        key = hashlib.sha1(
            f"{object_path}|{self.cred}|{offset}|{length}|{etag}".encode()
        ).hexdigest()
        return os.path.join(self.cache_dir, key + ".blob")

    def has_cached(self, cache_key: Optional[str]) -> bool:
        if not cache_key:
            return False
        with self._lock:
            if any(k.startswith(cache_key) for k in self._l1):
                return True
        # any SSD entry tagged with this logical key
        marker = os.path.join(self.cache_dir, hashlib.sha1(cache_key.encode()).hexdigest() + ".key")
        return os.path.exists(marker)

    def _mark_cached(self, cache_key: Optional[str]) -> None:
        if not cache_key:
            return
        marker = os.path.join(self.cache_dir, hashlib.sha1(cache_key.encode()).hexdigest() + ".key")
        with open(marker, "wb") as f:
            f.write(b"1")

    def fetch_range_cached(self, object_path: str, offset: int, length: int) -> Tuple[bytes, bool]:
        """Range-read through the SSD cache.  Returns (bytes, cache_hit)."""
        cpath = self._cache_path(object_path, offset, length)
        if os.path.exists(cpath):
            with open(cpath, "rb") as f:
                self.cache_hits += 1
                return f.read(), True
        data = self.store.get_range(object_path, offset, length)
        tmp = cpath + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, cpath)
        self.cache_misses += 1
        return data, False

    def _load_shard(
        self, puffin_path: str, offset: int, length: int, codec: Optional[str], cache_key: Optional[str]
    ) -> Tuple[VamanaGraph, ShardLocationMap, bool]:
        l1_key = f"{cache_key or puffin_path}@{offset}"
        with self._lock:
            if l1_key in self._l1:
                self._l1.move_to_end(l1_key)
                self.cache_hits += 1
                g, lm = self._l1[l1_key]
                return g, lm, True
        raw, hit = self.fetch_range_cached(puffin_path, offset, length)
        payload = _decompress(codec, raw)
        graph, locmap = decode_shard_blob(payload, lazy_vectors=True, device=self.device)
        if not np.any(graph.vectors[: graph.n]):
            # lean blob (paper §4.3 retention policy): full-precision vectors
            # omitted — re-fetch them from Parquet through the location map
            # (the "extra round trip" trade-off), then L1-cache as usual.
            graph.vectors[: graph.n] = self._fetch_vectors(locmap, graph.n)
        with self._lock:
            self._l1[l1_key] = (graph, locmap)
            while len(self._l1) > self._l1_capacity:
                self._l1.popitem(last=False)
        self._mark_cached(cache_key)
        return graph, locmap, hit

    def _fetch_vectors(self, locmap: ShardLocationMap, n: int) -> np.ndarray:
        """Read each indexed vector's row from its source Parquet row group."""
        readers: dict = {}
        out = None
        for vid in range(n):
            fpath = locmap.file_paths[int(locmap.file_idx[vid])]
            if fpath not in readers:
                readers[fpath] = VParquetReader.from_store(self.store, fpath)
            row = readers[fpath].read_rows(
                "vec", int(locmap.row_group[vid]), [int(locmap.row_offset[vid])]
            )[0]
            if out is None:
                out = np.empty((n, row.shape[0]), np.float32)
            out[vid] = row
        return out if out is not None else np.empty((0, 0), np.float32)

    # -- dispatch tallies -----------------------------------------------------
    def _task_dispatches(self) -> int:
        return getattr(self._dispatch_tls, "count", 0)

    def _task_mbeam(self) -> Tuple[int, int]:
        t = self._dispatch_tls
        return getattr(t, "mbeam_rows", 0), getattr(t, "mbeam_fallbacks", 0)

    def _reset_task_tallies(self) -> None:
        self._dispatch_tls.count = 0
        self._dispatch_tls.mbeam_rows = 0
        self._dispatch_tls.mbeam_fallbacks = 0

    # -- dispatch ------------------------------------------------------------
    def handle(self, task) -> object:
        self._gate()
        if self._kill_mid_task > 0:
            self._kill_mid_task -= 1
            self.dead = True  # heartbeat goes dark while the task is held
            if self._kill_hold_s > 0:
                time.sleep(self._kill_hold_s)
            raise ExecutorDead(self.executor_id)
        if isinstance(task, F.ScanPartitionTaskInfo):
            result = self._scan_partition(task)
        elif isinstance(task, F.IndexBuildTaskInfo):
            result = self._build_shard(task)
        elif isinstance(task, F.ProbeTaskInfo):
            result = self._probe_shard(task)
        elif isinstance(task, F.BatchProbeTaskInfo):
            raise _not_ported("the coalesced batch probe", "item 5 (probe_batch)")
        elif isinstance(task, F.TailScanTaskInfo):
            raise _not_ported("the fresh-tail scan", "item 6 (fresh tail)")
        elif isinstance(task, F.RerankTaskInfo):
            result = self._rerank(task)
        elif isinstance(task, F.RefreshTaskInfo):
            raise _not_ported("the shard refresh", "item 5 (refresh; needs insert_batch)")
        else:
            raise TypeError(f"unknown task type {type(task)}")
        self.tasks_done += 1
        return result

    # -- handlers --------------------------------------------------------------
    def _scan_partition(self, task: F.ScanPartitionTaskInfo) -> F.ScanPartitionResult:
        vectors, fidx, rgrp, roff, paths = _scan_files_with_locations(
            self.store, task.assigned_files
        )
        out = F.ScanPartitionResult(executor_id=self.executor_id)
        if vectors.shape[0] == 0:
            return out
        owners = _owner_shards(
            vectors, task.partition_centroids, task.shard_of_partition, self.device
        )
        for shard in range(task.num_shards):
            sel = np.flatnonzero(owners == shard)
            if len(sel) == 0:
                continue
            out.per_shard[shard] = (
                vectors[sel],
                fidx[sel],
                rgrp[sel],
                roff[sel],
                paths,
            )
        return out

    def _build_shard(self, task: F.IndexBuildTaskInfo) -> F.IndexBuildResult:
        t0 = time.time()
        if task.exchanged is not None:
            vectors, fidx, rgrp, roff, paths = task.exchanged
        else:
            vectors, fidx, rgrp, roff, paths = _scan_files_with_locations(
                self.store, task.assigned_files
            )
            if task.partition_mode == "centroid" and task.partition_centroids is not None:
                owners = _owner_shards(
                    vectors, task.partition_centroids, task.shard_of_partition, self.device
                )
                sel = np.flatnonzero(owners == task.shard_id)
                vectors, fidx, rgrp, roff = vectors[sel], fidx[sel], rgrp[sel], roff[sel]
        if vectors.shape[0] == 0:
            raise ValueError(f"shard {task.shard_id}: no vectors to index")
        params = VamanaParams(R=task.R, L=task.L, alpha=task.alpha, metric=task.metric)
        graph = build_vamana(
            vectors, params, passes=task.build_passes, batch=task.build_batch,
            seed=task.shard_id, device=self.device,
        )
        if task.pq_m:
            pq = PQCodebook(task.pq_codebook, task.metric)
            graph.attach_pq(pq, pq_encode(pq, vectors, device=self.device))
        # per-partition counts for the routing table
        counts = None
        if task.partition_centroids is not None:
            part = _partition_of(vectors, task.partition_centroids, self.device)
            counts = np.bincount(part, minlength=task.partition_centroids.shape[0])
        locmap = ShardLocationMap(paths, fidx, rgrp, roff)
        blob = encode_shard_blob(graph, locmap, include_vectors=task.include_vectors)
        self.store.put(task.output_path, blob)
        return F.IndexBuildResult(
            shard_id=task.shard_id,
            output_path=task.output_path,
            vector_count=graph.n,
            byte_size=len(blob),
            executor_id=self.executor_id,
            build_seconds=time.time() - t0,
            partition_counts=counts,
            rg_membership=_locmap_membership(locmap, graph.n),
        )

    def _shard_search(
        self,
        task,
        graph,
        queries: Optional[np.ndarray] = None,
        width: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Shared Stage-A search: batched beam search (PQ ADC when the shard
        carries codes) over however many queries the fragment brought.
        ``width`` overrides the task's own k * oversample candidate count."""
        q = task.queries if queries is None else queries
        k_eff = min(width or task.k * task.oversample, graph.num_live)
        L = max(task.L, k_eff)
        if task.use_pq and graph.pq is not None:
            return graph.search_pq(q, k_eff, L=L)
        return graph.search(q, k_eff, L=L)

    def _row_candidates(
        self, graph, locmap, dists_row, ids_row, shard_id: int
    ) -> List[F.ProbeCandidate]:
        cands: List[F.ProbeCandidate] = []
        for d, vid in zip(dists_row, ids_row):
            if not np.isfinite(d) or vid < 0 or vid >= graph.n:
                continue
            fpath, rg, ro = locmap.lookup(int(vid))
            cands.append(
                F.ProbeCandidate(
                    file_path=fpath,
                    row_group=rg,
                    row_offset=ro,
                    approx_distance=float(d),
                    vec_id=int(vid),
                    shard_id=shard_id,
                )
            )
        return cands

    def _probe_shard(self, task: F.ProbeTaskInfo) -> F.ProbeResult:
        if task.predicate is not None:
            raise _not_ported("the filtered probe", "item 6 (filtered slice)")
        t0 = time.time()
        graph, locmap, hit = self._load_shard(
            task.puffin_path, task.blob_offset, task.blob_length, task.blob_codec, task.cache_key
        )
        self._reset_task_tallies()
        dists, ids = self._shard_search(task, graph)
        mb_rows, mb_fb = self._task_mbeam()
        result = F.ProbeResult(
            shard_id=task.shard_id, executor_id=self.executor_id, cache_hit=hit,
            kernel_dispatches=self._task_dispatches(),
            masked_beam_rows=mb_rows, masked_beam_fallbacks=mb_fb,
        )
        for qi in range(task.queries.shape[0]):
            result.candidates.append(
                self._row_candidates(graph, locmap, dists[qi], ids[qi], task.shard_id)
            )
        result.probe_seconds = time.time() - t0
        return result

    def _rerank(self, task: F.RerankTaskInfo) -> F.RerankResult:
        rows_flat: List[Tuple[str, int, int]] = []
        # per flat row: None => every query owns it, else the owning set
        owners_flat: List[Optional[set]] = []
        vec_parts: List[np.ndarray] = []
        for fpath, groups in task.masks.items():
            reader = VParquetReader.from_store(self.store, fpath)
            f_own = task.file_owners.get(fpath) if task.file_owners else None
            r_own = task.row_owners.get(fpath) if task.row_owners else None
            for rg_id, offsets in groups.items():
                arr = reader.read_rows("vec", rg_id, offsets)
                vec_parts.append(arr)
                rg_own = r_own.get(rg_id) if r_own is not None else None
                for off in offsets:
                    rows_flat.append((fpath, rg_id, off))
                    if rg_own is not None:
                        owners_flat.append(rg_own.get(off, set()))
                    else:
                        owners_flat.append(f_own)
        result = F.RerankResult(executor_id=self.executor_id)
        q = np.ascontiguousarray(task.queries, np.float32)
        if not rows_flat:
            result.rows = [[] for _ in range(q.shape[0])]
            return result
        cands = np.concatenate(vec_parts)
        # the union of every query's rows is read and scored ONCE — a single
        # rerank_distances kernel call; ownership filters the (Q, N) matrix
        d = ops.exact_distances(
            to_device(q, self.device),
            to_device(cands, self.device),
            metric=task.metric,
            backend="auto",
        ).cpu().numpy()
        for qi in range(q.shape[0]):
            owned = [
                ci for ci in range(len(rows_flat))
                if owners_flat[ci] is None or qi in owners_flat[ci]
            ]
            near = np.argsort(d[qi, owned], kind="stable")[: task.keep]
            owned = [owned[j] for j in near]
            result.rows.append(
                [F.RerankRow(*rows_flat[ci], float(d[qi, ci])) for ci in owned]
            )
        return result
