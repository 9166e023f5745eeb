"""Executor process model (paper §3.1): stateless worker + SSD/L1 caches.

Port of ``repro/runtime/executor.py``.  An executor owns:

- an **SSD cache** directory keyed by ``(object_path, credential_fingerprint,
  byte_range, etag)`` — raw blob bytes survive across tasks and are safe to
  lose (the object store is the source of truth);
- an **L1 cache** of deserialized Vamana graphs (bounded LRU);
- a ``device`` its kernels run on (CUDA by default; ``"cpu"`` runs the
  plain PyTorch versions);
- task handlers for partition scan, shard build, shard probe (unfiltered,
  filtered, batched, and the quantized ExactScan behind its full-precision
  guard), fresh-tail scan, exact rerank and shard refresh (tombstones plus
  greedy insert).

Failure-injection hooks (``kill()``, ``fail_next()``, ``delay_next()``,
``kill_next()``) drive the scheduler's fault-tolerance paths.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.blobs import ShardLocationMap, decode_shard_blob, encode_shard_blob
from repro_torch.core.pq import PQCodebook, encode as pq_encode
from repro_torch.core.vamana import VamanaGraph, VamanaParams, build_vamana
from repro_torch.iceberg.puffin import _decompress  # codec shared with Puffin blobs
from repro_torch.core.pq import build_luts
from repro_torch.kernels import device_cache, ops
from repro_torch.kernels.device_cache import resolve_device, to_device
from repro_torch.lakehouse.objectstore import ObjectStore
from repro_torch.lakehouse.vparquet import VParquetReader
from repro_torch.runtime import fragments as F
from repro_torch.runtime import planner
from repro_torch.runtime.predicates import row_group_mask
from repro_torch.serving import metrics as spans


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
        # filtered search: (shard key, rows, predicate) -> per-vector-id bool
        # mask; the live masks (tombstones folded in) and their device bytes
        # are cached beside it, so a repeated predicate uploads nothing
        self._mask_cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._mask_cache_capacity = 64
        self._live_cache: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._dev_masks: "OrderedDict[int, Tuple[np.ndarray, torch.Tensor]]" = OrderedDict()
        self._lock = threading.Lock()
        # comparison switches: answer heterogeneous-filter fragments with
        # the one-call-per-predicate-group loop instead of the single
        # mask-plane call, and/or keep mixed exact + PQ fragments on one
        # dispatch per flavor instead of the unified kernel.  Both interpret
        # the same planner-resolved ops, so the hits are identical.
        self.force_group_loop = False
        self.force_split_flavors = False
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
        # calls (executor-wide, plus a per-task thread-local count: each task
        # attempt runs on its own scheduler thread) and, separately, the
        # filtered path's gather-rerank pool reranks
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
    def _count_dispatch(self) -> None:
        """Record one masked-kernel call: executor-wide total (locked) and
        the current task's thread-local tally."""
        with self._lock:
            self.masked_kernel_dispatches += 1
        self._dispatch_tls.count = getattr(self._dispatch_tls, "count", 0) + 1

    def _count_rerank(self) -> None:
        """Record one gather-rerank call (kept apart from the masked-scan
        dispatches, as the reference keeps it)."""
        with self._lock:
            self.rerank_kernel_dispatches += 1

    def _task_dispatches(self) -> int:
        return getattr(self._dispatch_tls, "count", 0)

    def _count_mbeam(self, rows: int, fallbacks: int) -> None:
        """Tally MaskedBeam rows of the current task and how many of them
        under-delivered and went to the exact masked fallback."""
        t = self._dispatch_tls
        t.mbeam_rows = getattr(t, "mbeam_rows", 0) + rows
        t.mbeam_fallbacks = getattr(t, "mbeam_fallbacks", 0) + fallbacks

    def _task_mbeam(self) -> Tuple[int, int]:
        t = self._dispatch_tls
        return getattr(t, "mbeam_rows", 0), getattr(t, "mbeam_fallbacks", 0)

    def _reset_task_tallies(self) -> None:
        self._dispatch_tls.count = 0
        self._dispatch_tls.mbeam_rows = 0
        self._dispatch_tls.mbeam_fallbacks = 0

    # -- filtered search ------------------------------------------------------
    def _resolve_op(self, task, op, live_mask: np.ndarray, has_pq: bool):
        """Refine a planner op with the measured match count; every
        threshold lives in runtime/planner.py, and the mask-plane path and
        the ``force_group_loop`` baseline both resolve here."""
        if op is None:
            op = planner.default_filtered_op(task.k, task.oversample, task.use_pq)
        return planner.resolve(
            op,
            match_count=int(live_mask.sum()),
            k=task.k,
            oversample=task.oversample,
            has_pq=task.use_pq and has_pq,
        )

    @staticmethod
    def _dedup_rows(
        masks: List[np.ndarray], keys: List[object]
    ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Per-query mask rows keyed by their predicate collapse to the
        unique rows plus a (Q,) row index."""
        pos: Dict[object, int] = {}
        unique: List[np.ndarray] = []
        idx = np.empty(len(masks), np.int64)
        for j, (m, key) in enumerate(zip(masks, keys)):
            p = pos.get(key)
            if p is None:
                p = len(unique)
                pos[key] = p
                unique.append(m)
            idx[j] = p
        return unique, idx

    def _predicate_mask(self, locmap: ShardLocationMap, n: int, pred, shard_key: str) -> np.ndarray:
        """Executor-side row bitmask: does vector id's source row satisfy
        ``pred``?  Each (file, row_group) of the location map is evaluated
        once with attribute-column projection; the per-id gather is cached
        per (shard, row count, predicate)."""
        key = (shard_key, n, pred)
        with self._lock:
            if key in self._mask_cache:
                self._mask_cache.move_to_end(key)
                return self._mask_cache[key]
        mask = np.zeros(n, bool)
        fidx = np.asarray(locmap.file_idx[:n], np.int64)
        rgrp = np.asarray(locmap.row_group[:n], np.int64)
        roff = np.asarray(locmap.row_offset[:n], np.int64)
        readers: Dict[str, VParquetReader] = {}
        for fi, rg in {(int(a), int(b)) for a, b in zip(fidx, rgrp)}:
            fpath = locmap.file_paths[fi]
            if fpath not in readers:
                readers[fpath] = VParquetReader.from_store(self.store, fpath)
            rg_mask = row_group_mask(pred, readers[fpath], rg)
            sel = np.flatnonzero((fidx == fi) & (rgrp == rg))
            mask[sel] = rg_mask[roff[sel]]
        with self._lock:
            self._mask_cache[key] = mask
            while len(self._mask_cache) > self._mask_cache_capacity:
                self._mask_cache.popitem(last=False)
        return mask

    def _live_mask(self, graph, locmap, pred, shard_key: str) -> np.ndarray:
        """``_predicate_mask & ~tombstones``, cached beside the predicate
        mask (keyed also by the tombstone count, which only grows), so a
        repeated predicate returns the same array and its device copy is
        reused."""
        mask = self._predicate_mask(locmap, graph.n, pred, shard_key)
        ts = graph.tombstones[: graph.n]
        key = (shard_key, graph.n, pred, int(ts.sum()))
        with self._lock:
            live = self._live_cache.get(key)
            if live is not None:
                self._live_cache.move_to_end(key)
                return live
        live = mask & ~ts
        with self._lock:
            self._live_cache[key] = live
            while len(self._live_cache) > self._mask_cache_capacity:
                self._live_cache.popitem(last=False)
        return live

    def _dev(self, mask: np.ndarray) -> torch.Tensor:
        """A host mask on the executor's device: on a card, uint8 bytes
        uploaded once per mask object (held, so its id cannot be reused)."""
        if self.device.type == "cpu":
            return torch.from_numpy(np.ascontiguousarray(mask))
        key = id(mask)
        with self._lock:
            hit = self._dev_masks.get(key)
            if hit is not None and hit[0] is mask:
                self._dev_masks.move_to_end(key)
                return hit[1]
        dev = to_device(mask, self.device, torch.uint8)
        with self._lock:
            self._dev_masks[key] = (mask, dev)
            while len(self._dev_masks) > 2 * self._mask_cache_capacity:
                self._dev_masks.popitem(last=False)
        return dev

    def _dev_rows(self, unique_masks: List[np.ndarray]) -> torch.Tensor:
        return torch.stack([self._dev(m) for m in unique_masks])

    def _q(self, queries: np.ndarray) -> torch.Tensor:
        return to_device(np.ascontiguousarray(queries, np.float32), self.device)

    def _idx(self, row_index: np.ndarray) -> torch.Tensor:
        return to_device(np.asarray(row_index, np.int64), self.device, torch.int32)

    @staticmethod
    def _np(d: torch.Tensor, ids: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        return d.cpu().numpy(), ids.cpu().numpy().astype(np.int64)

    def _exact_masked(
        self,
        graph,
        queries: np.ndarray,
        live_mask: np.ndarray,
        k_eff: int,
        dtype: str = "f32",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Pre-filter exact scan: one ``masked_exact_topk`` call ranks only
        the rows passing the mask.  Output is always (Q, k_eff); slots past
        the passing rows hold (+inf, -1).

        A quantized ``dtype`` runs the plan's two-stage form: the bf16 /
        int8 scan over the cached quantized device copy ranks a
        ``quant_guard_pool``-sized pool, and the full-precision
        ``gather_rerank`` guard scores that pool down to ``k_eff``, so the
        emitted distances are exact f32."""
        self._count_dispatch()
        if dtype != "f32":
            q = self._q(queries)
            stored, x_scale = device_cache.device_vectors_quant(graph, dtype)
            pool = min(planner.quant_guard_pool(k_eff), graph.n)
            _qd, pids = ops.masked_exact_topk(
                q, stored, self._dev(live_mask), int(pool), metric=graph.params.metric,
                backend="auto", dtype=dtype, x_scale=x_scale,
            )
            return self._rerank_pool(graph, q, pids, int(k_eff))
        d, ids = ops.masked_exact_topk(
            self._q(queries),
            device_cache.device_vectors(graph),
            self._dev(live_mask),
            int(k_eff),
            metric=graph.params.metric,
            backend="auto",
        )
        return self._np(d, ids)

    def _masked_pq_stage(
        self, graph, queries: np.ndarray, live_mask: np.ndarray, pool: int, k_out: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """PQScan: one masked ADC call scores every passing code row at the
        planner-resolved ``pool``, then the survivors get the exact rerank."""
        q = self._q(queries)
        luts = build_luts(graph.pq, q, device=self.device)
        self._count_dispatch()
        _pq_d, pids = ops.masked_pq_topk(
            luts, device_cache.device_codes_u8(graph), self._dev(live_mask), int(pool),
            backend="auto",
        )
        return self._rerank_pool(graph, q, pids, k_out)

    def _rerank_pool(
        self, graph, q: torch.Tensor, pids: torch.Tensor, k_out: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact full-precision rerank of a (Q, pool) candidate pool through
        one ``gather_rerank`` call; sentinel slots (pid < 0) stay
        (+inf, -1)."""
        self._count_rerank()
        d, ids = ops.gather_rerank(
            q,
            device_cache.device_vectors(graph),
            pids.to(torch.int32),
            int(k_out),
            metric=graph.params.metric,
            backend="auto",
        )
        return self._np(d, ids)

    def _exact_masked_plane(
        self,
        graph,
        queries: np.ndarray,
        unique_masks,
        row_index,
        k_out: int,
        dtype: str = "f32",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Heterogeneous-predicate ExactScan: one call answers every query
        of a fragment under its own row of the dedup'd plane.  A quantized
        ``dtype`` runs the scan-plus-guard form of ``_exact_masked``."""
        self._count_dispatch()
        if dtype != "f32":
            q = self._q(queries)
            stored, x_scale = device_cache.device_vectors_quant(graph, dtype)
            pool = min(planner.quant_guard_pool(k_out), graph.n)
            _qd, pids = ops.masked_exact_topk_dedup(
                q, stored, self._dev_rows(unique_masks), self._idx(row_index), int(pool),
                metric=graph.params.metric, backend="auto", dtype=dtype, x_scale=x_scale,
            )
            return self._rerank_pool(graph, q, pids, int(k_out))
        d, ids = ops.masked_exact_topk_dedup(
            self._q(queries),
            device_cache.device_vectors(graph),
            self._dev_rows(unique_masks),
            self._idx(row_index),
            int(k_out),
            metric=graph.params.metric,
            backend="auto",
        )
        return self._np(d, ids)

    def _masked_pq_plane(
        self,
        graph,
        queries: np.ndarray,
        unique_masks,
        row_index,
        pool: int,
        k_out: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Heterogeneous-predicate PQScan: one multi-mask ADC call at the
        shared ``pool`` (planner.resolve pins it for every PQ row of a
        fragment), then the shared exact rerank."""
        q = self._q(queries)
        luts = build_luts(graph.pq, q, device=self.device)
        self._count_dispatch()
        _pq_d, pids = ops.masked_pq_topk_dedup(
            luts,
            device_cache.device_codes_u8(graph),
            self._dev_rows(unique_masks),
            self._idx(row_index),
            int(pool),
            backend="auto",
        )
        return self._rerank_pool(graph, q, pids, k_out)

    def _unified_masked_stage(
        self,
        graph,
        queries: np.ndarray,
        unique_masks,
        row_index,
        flavor: np.ndarray,
        pq_pool: int,
        k_out: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Mixed-flavor fragment: one ``unified_masked_topk`` call returns
        max(k_out, pq_pool) columns; exact rows keep their first k_out (the
        top-k is prefix-stable, so this equals a dedicated exact call), PQ
        rows send their ``pq_pool`` ADC survivors to the shared exact
        rerank."""
        q = self._q(queries)
        luts = build_luts(graph.pq, q, device=self.device)
        kk = int(max(k_out, pq_pool))
        self._count_dispatch()
        d, ids = ops.unified_masked_topk_dedup(
            q,
            device_cache.device_vectors(graph),
            luts,
            device_cache.device_codes_u8(graph),
            self._dev_rows(unique_masks),
            self._idx(row_index),
            to_device(flavor, self.device, torch.bool),
            kk,
            metric=graph.params.metric,
            backend="auto",
        )
        d_np, ids_np = self._np(d, ids)
        out_d = np.empty((q.shape[0], k_out), np.float32)
        out_i = np.empty((q.shape[0], k_out), np.int64)
        ex = ~flavor
        out_d[ex] = d_np[ex, :k_out]
        out_i[ex] = ids_np[ex, :k_out]
        if flavor.any():
            sel = torch.as_tensor(np.flatnonzero(flavor)).to(self.device)
            rd, ri = self._rerank_pool(
                graph, q[sel], ids[sel][:, : int(pq_pool)].contiguous(), k_out
            )
            out_d[flavor] = rd
            out_i[flavor] = ri
        return out_d, out_i

    def _filtered_search(
        self, task, graph, locmap, queries: np.ndarray, pred, op
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Stage-A search under one predicate shared by a group of queries:
        resolve the planner's op against the measured match count, then run
        it (ExactScan and PQScan on the masked kernels, MaskedBeam on the
        predicate-aware traversal, PostfilterBeam on the over-fetched beam;
        both beams fall back to the exact masked scan for rows they
        under-deliver)."""
        shard_key = f"{task.cache_key or task.puffin_path}@{task.blob_offset}"
        live_mask = self._live_mask(graph, locmap, pred, shard_key)
        final = self._resolve_op(task, op, live_mask, graph.pq is not None)
        Qn = queries.shape[0]
        if isinstance(final, planner.Skip):
            return (
                np.full((Qn, 1), np.inf, np.float32),
                np.full((Qn, 1), -1, np.int64),
            )
        if isinstance(final, planner.PQScan):
            return self._masked_pq_stage(graph, queries, live_mask, final.pool, final.k)
        if isinstance(final, planner.ExactScan):
            return self._exact_masked(
                graph, queries, live_mask, final.k, dtype=getattr(final, "dtype", "f32")
            )
        if isinstance(final, planner.MaskedBeam):
            return self._masked_beam(task, graph, queries, live_mask, final)
        return self._postfilter_beam(task, graph, queries, live_mask, final)

    def _postfilter_beam_core(
        self, task, graph, queries: np.ndarray, mask_plane: np.ndarray, pool: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Over-fetch the ordinary beam to ``pool``, drop each row's
        candidates failing its mask, and return the post-filtered pool
        sorted ascending per row (failures at the (+inf, -1) tail)."""
        p = min(int(pool), graph.num_live)
        L = max(task.L, p)
        if task.use_pq and graph.pq is not None:
            dists, ids = graph.search_pq(queries, p, L=L)
        else:
            dists, ids = graph.search(queries, p, L=L)
        safe = np.clip(ids, 0, graph.n - 1)
        passing = (
            np.take_along_axis(mask_plane, safe, axis=1)
            & (ids >= 0)
            & np.isfinite(dists)
        )
        dists = np.where(passing, dists, np.inf)
        ids = np.where(passing, ids, -1)
        order = np.argsort(dists, axis=1)
        return (
            np.take_along_axis(dists, order, axis=1),
            np.take_along_axis(ids, order, axis=1),
        )

    def _postfilter_beam(
        self, task, graph, queries: np.ndarray, live_mask: np.ndarray, op
    ) -> Tuple[np.ndarray, np.ndarray]:
        """PostfilterBeam for a group sharing one mask; rows the beam
        under-delivers fall back to the exact masked scan."""
        plane = np.broadcast_to(live_mask, (queries.shape[0], live_mask.shape[0]))
        dists, ids = self._postfilter_beam_core(task, graph, queries, plane, op.pool)
        dists = dists[:, : op.k]
        ids = ids[:, : op.k]
        short = np.isinf(dists).any(axis=1)
        if short.any():
            rows = np.flatnonzero(short)
            ed, ei = self._exact_masked(graph, queries[rows], live_mask, op.k)
            dists[rows] = ed
            ids[rows] = ei
        return dists, ids

    def _masked_beam_core(
        self, task, graph, queries: np.ndarray, unique_masks, row_index, width: int, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The predicate-aware traversal (``VamanaGraph.search_masked``) at
        the planner-widened admit target, the beam depth at max(task.L, k);
        the dedup'd mask rows go as the cached device bytes.  A beam pass,
        not a masked-kernel dispatch."""
        w = max(1, min(int(width), graph.num_live))
        L = max(task.L, min(int(k), graph.num_live))
        return graph.search_masked(
            queries,
            w,
            self._dev_rows(unique_masks),
            row_index,
            L=L,
            use_pq=task.use_pq and graph.pq is not None,
        )

    def _masked_beam(
        self, task, graph, queries: np.ndarray, live_mask: np.ndarray, op
    ) -> Tuple[np.ndarray, np.ndarray]:
        """MaskedBeam for a group sharing one mask; rows the traversal
        under-delivers fall back to the exact masked scan."""
        dists, ids = self._masked_beam_core(
            task,
            graph,
            queries,
            [live_mask],
            np.zeros(queries.shape[0], np.int64),
            op.width,
            op.k,
        )
        dists = dists[:, : op.k]
        ids = ids[:, : op.k]
        short = np.isinf(dists).any(axis=1)
        self._count_mbeam(queries.shape[0], int(short.sum()))
        if short.any():
            rows = np.flatnonzero(short)
            ed, ei = self._exact_masked(graph, queries[rows], live_mask, op.k)
            dists[rows] = ed
            ids[rows] = ei
        return dists, ids

    # -- dispatch ------------------------------------------------------------
    def handle(self, task, *, wanted: Optional[Callable[[], bool]] = None) -> object:
        """Run one task.  ``wanted`` (the scheduler's "is this fragment still
        open?") is asked after the failure gates: a straggler whose wave was
        won by another attempt while it slept returns None without computing.
        A torch op still running in a daemon thread when the interpreter
        exits aborts the process (the op's tensor release takes the GIL
        inside a ``noexcept`` destructor, and the exiting interpreter answers
        with ``pthread_exit``), so an attempt whose fragment is already done
        does not start computing."""
        self._gate()
        if self._kill_mid_task > 0:
            self._kill_mid_task -= 1
            self.dead = True  # heartbeat goes dark while the task is held
            if self._kill_hold_s > 0:
                time.sleep(self._kill_hold_s)
            raise ExecutorDead(self.executor_id)
        if wanted is not None and not wanted():
            return None
        if isinstance(task, F.ScanPartitionTaskInfo):
            result = self._scan_partition(task)
        elif isinstance(task, F.IndexBuildTaskInfo):
            result = self._build_shard(task)
        elif isinstance(task, F.ProbeTaskInfo):
            result = self._probe_shard(task)
        elif isinstance(task, F.BatchProbeTaskInfo):
            result = self._probe_shard_batch(task)
        elif isinstance(task, F.TailScanTaskInfo):
            result = self._tail_scan(task)
        elif isinstance(task, F.RerankTaskInfo):
            result = self._rerank(task)
        elif isinstance(task, F.RefreshTaskInfo):
            result = self._refresh_shard(task)
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
        ``width`` is a planner Beam op's candidate count; absent, the task's
        own k * oversample applies."""
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
        with spans.span("shard.load"):
            graph, locmap, hit = self._load_shard(
                task.puffin_path, task.blob_offset, task.blob_length, task.blob_codec,
                task.cache_key,
            )
        self._reset_task_tallies()
        with spans.span("shard.search"):
            if task.predicate is not None:
                dists, ids = self._filtered_search(
                    task, graph, locmap, task.queries, task.predicate, task.plan_op
                )
            else:
                dists, ids = self._shard_search(task, graph)
        mb_rows, mb_fb = self._task_mbeam()
        result = F.ProbeResult(
            shard_id=task.shard_id, executor_id=self.executor_id, cache_hit=hit,
            kernel_dispatches=self._task_dispatches(),
            masked_beam_rows=mb_rows, masked_beam_fallbacks=mb_fb,
        )
        with spans.span("shard.candidates"):
            for qi in range(task.queries.shape[0]):
                result.candidates.append(
                    self._row_candidates(graph, locmap, dists[qi], ids[qi], task.shard_id)
                )
        return result

    def _tail_scan(self, task: F.TailScanTaskInfo) -> F.BatchProbeResult:
        """Fresh-tail Stage A: score one appended-but-unindexed row group
        for every query routed to it with one masked exact call (an
        all-ones row, or the dedup'd plane when the batch carries
        predicates).  Sentinel slots are dropped before candidates leave
        the executor."""
        result = F.BatchProbeResult(shard_id=task.tail_id, executor_id=self.executor_id)
        self._reset_task_tallies()
        qidx = np.asarray(task.query_index, np.int64)
        reader = VParquetReader.from_store(self.store, task.file_path)
        vectors = np.ascontiguousarray(reader.read_column("vec", [task.row_group]), np.float32)
        n = vectors.shape[0]
        if n == 0:
            for qi in qidx:
                result.candidates[int(qi)] = []
            return result
        k_eff = min(max(1, task.k * task.oversample), n)
        all_rows = np.ones(n, bool)
        masks: List[np.ndarray] = []
        keys: List[object] = []
        for bi in range(task.queries.shape[0]):
            pred = task.filters[bi] if task.filters else None
            if pred is None:
                masks.append(all_rows)
                keys.append(None)
            else:
                masks.append(row_group_mask(pred, reader, task.row_group))
                keys.append(pred)
        unique, row_index = self._dedup_rows(masks, keys)
        q = self._q(task.queries)
        x = to_device(vectors, self.device)
        rows = to_device(np.stack(unique), self.device, torch.uint8)
        self._count_dispatch()
        if len(unique) == 1:
            d, ids = ops.masked_exact_topk(
                q, x, rows[0], int(k_eff), metric=task.metric, backend="auto"
            )
        else:
            d, ids = ops.masked_exact_topk_dedup(
                q, x, rows, self._idx(row_index), int(k_eff), metric=task.metric, backend="auto"
            )
        d, ids = self._np(d, ids)
        for bi, qi in enumerate(qidx):
            result.candidates[int(qi)] = [
                F.ProbeCandidate(
                    file_path=task.file_path,
                    row_group=task.row_group,
                    row_offset=int(vid),
                    approx_distance=float(dist),
                    vec_id=int(vid),
                    shard_id=task.tail_id,
                )
                for dist, vid in zip(d[bi], ids[bi])
                if np.isfinite(dist) and vid >= 0
            ]
        result.kernel_dispatches = self._task_dispatches()
        return result

    def _probe_shard_batch(self, task: F.BatchProbeTaskInfo) -> F.BatchProbeResult:
        """Coalesced Stage A: one shard load, then every kernel-planned
        query of the fragment in ONE masked-kernel call per shard, however
        many distinct predicates and whichever mix of exact and ADC flavors
        (the unified kernel).  Unfiltered fragments keep the batched beam
        search, so their hits equal sequential ``probe`` calls.

        Spans (``serving.metrics``): ``shard.load`` (the L1 hit, or the
        blob's read, decode and upload), ``shard.search`` (the beams, which
        end at their ``.cpu()``; on a filtered fragment the whole plane,
        candidates included) and ``shard.candidates`` (ids to table rows,
        host only)."""
        with spans.span("shard.load"):
            graph, locmap, hit = self._load_shard(
                task.puffin_path, task.blob_offset, task.blob_length, task.blob_codec,
                task.cache_key,
            )
        result = F.BatchProbeResult(
            shard_id=task.shard_id, executor_id=self.executor_id, cache_hit=hit
        )
        self._reset_task_tallies()
        qidx = np.asarray(task.query_index, np.int64)
        if not task.filters:
            with spans.span("shard.search"):
                dists, ids = self._shard_search(task, graph)
            with spans.span("shard.candidates"):
                for bi, qi in enumerate(qidx):
                    result.candidates[int(qi)] = self._row_candidates(
                        graph, locmap, dists[bi], ids[bi], task.shard_id
                    )
            return result
        with spans.span("shard.search"):
            if self.force_group_loop:
                self._probe_groups(task, graph, locmap, result, qidx, range(len(qidx)))
            else:
                self._probe_mask_plane(task, graph, locmap, result, qidx)
        result.kernel_dispatches = self._task_dispatches()
        result.masked_beam_rows, result.masked_beam_fallbacks = self._task_mbeam()
        return result

    def _probe_groups(
        self, task, graph, locmap, result, qidx: np.ndarray, rows
    ) -> None:
        """Per-predicate-group Stage A (behind ``force_group_loop``): one
        pass per distinct (predicate, plan op), interpreting the same
        resolved ops as the mask-plane path."""
        groups: Dict[tuple, List[int]] = {}
        for bi in rows:
            op = task.plan_ops[bi] if task.plan_ops else None
            groups.setdefault((task.filters[bi], op), []).append(bi)
        for (pred, op), members in groups.items():
            queries = task.queries[members]
            if pred is None:
                if isinstance(op, planner.ExactScan):
                    live = ~graph.tombstones[: graph.n]
                    k_out = max(1, min(op.k, graph.n))
                    dists, ids = self._exact_masked(
                        graph, queries, live, k_out, dtype=getattr(op, "dtype", "f32")
                    )
                else:
                    w = op.width if isinstance(op, planner.Beam) else 0
                    dists, ids = self._shard_search(task, graph, queries, width=w or None)
            else:
                dists, ids = self._filtered_search(task, graph, locmap, queries, pred, op)
            for j, bi in enumerate(members):
                result.candidates[int(qidx[bi])] = self._row_candidates(
                    graph, locmap, dists[j], ids[j], task.shard_id
                )

    def _probe_mask_plane(
        self, task, graph, locmap, result, qidx: np.ndarray
    ) -> None:
        """Mask-plane Stage A: resolve every query's op against its match
        count, then answer all kernel-planned queries with one call (the
        dedup'd exact or ADC plane, or the unified kernel when the flavors
        mix).  Beam-planned rows share one beam pass per width,
        PostfilterBeam and MaskedBeam rows share passes per pool / width,
        and their under-delivered rows share one fused exact fallback."""
        shard_key = f"{task.cache_key or task.puffin_path}@{task.blob_offset}"
        n = graph.n
        tomb_live = ~graph.tombstones[:n]
        k_out = max(1, min(task.k * task.oversample, n))
        exact_rows: List[int] = []
        exact_masks: List[np.ndarray] = []
        exact_keys: List[object] = []
        exact_dtypes: List[str] = []
        pq_rows: List[int] = []
        pq_masks: List[np.ndarray] = []
        pq_keys: List[object] = []
        beam_rows: Dict[int, List[int]] = {}  # planner Beam width -> rows
        post_rows: Dict[int, List[int]] = {}
        post_masks: Dict[int, np.ndarray] = {}
        post_ks: Dict[int, int] = {}
        mbeam_rows: Dict[int, List[int]] = {}  # planner MaskedBeam width -> rows
        mbeam_masks: Dict[int, np.ndarray] = {}
        mbeam_ks: Dict[int, int] = {}
        pq_pool = 0
        for bi in range(len(qidx)):
            pred = task.filters[bi]
            op = task.plan_ops[bi] if task.plan_ops else None
            if pred is None:
                if isinstance(op, planner.ExactScan):
                    # unfiltered query in a mixed fragment on a small shard:
                    # an all-ones row (only tombstones masked)
                    exact_rows.append(bi)
                    exact_masks.append(tomb_live)
                    exact_keys.append(None)
                    exact_dtypes.append(getattr(op, "dtype", "f32"))
                else:
                    w = op.width if isinstance(op, planner.Beam) else 0
                    beam_rows.setdefault(int(w), []).append(bi)
                continue
            live = self._live_mask(graph, locmap, pred, shard_key)
            final = self._resolve_op(task, op, live, graph.pq is not None)
            if isinstance(final, planner.Skip):
                result.candidates[int(qidx[bi])] = []
            elif isinstance(final, planner.PQScan):
                pq_rows.append(bi)
                pq_masks.append(live)
                pq_keys.append(pred)
                pq_pool = final.pool  # pinned: identical for every PQ row
            elif isinstance(final, planner.ExactScan):
                exact_rows.append(bi)
                exact_masks.append(live)
                exact_keys.append(pred)
                exact_dtypes.append(getattr(final, "dtype", "f32"))
            elif isinstance(final, planner.MaskedBeam):
                mbeam_rows.setdefault(int(final.width), []).append(bi)
                mbeam_masks[bi] = live
                mbeam_ks[bi] = final.k
            else:  # PostfilterBeam
                post_rows.setdefault(int(final.pool), []).append(bi)
                post_masks[bi] = live
                post_ks[bi] = final.k

        def _emit(rows, dists, ids):
            for j, bi in enumerate(rows):
                result.candidates[int(qidx[bi])] = self._row_candidates(
                    graph, locmap, dists[j], ids[j], task.shard_id
                )

        # Reduced-precision exact rows never join the unified fusion (the
        # unified kernel scores exact rows in f32 only): each dtype gets its
        # own scan-plus-guard dispatch, and the f32 rows go on below
        quant_groups: Dict[str, List[int]] = {}
        for pos, dt in enumerate(exact_dtypes):
            if dt != "f32":
                quant_groups.setdefault(dt, []).append(pos)
        if quant_groups:
            for dt, poss in sorted(quant_groups.items()):
                rows = [exact_rows[p] for p in poss]
                unique, idx = self._dedup_rows(
                    [exact_masks[p] for p in poss], [exact_keys[p] for p in poss]
                )
                if len(unique) == 1:
                    dists, ids = self._exact_masked(
                        graph, task.queries[rows], unique[0], k_out, dtype=dt
                    )
                else:
                    dists, ids = self._exact_masked_plane(
                        graph, task.queries[rows], unique, idx, k_out, dtype=dt
                    )
                _emit(rows, dists, ids)
            keep = [p for p, dt in enumerate(exact_dtypes) if dt == "f32"]
            exact_rows = [exact_rows[p] for p in keep]
            exact_masks = [exact_masks[p] for p in keep]
            exact_keys = [exact_keys[p] for p in keep]

        if exact_rows and pq_rows and not self.force_split_flavors:
            # mixed flavors: ONE unified dispatch for the whole fragment
            rows = exact_rows + pq_rows
            unique, idx = self._dedup_rows(exact_masks + pq_masks, exact_keys + pq_keys)
            flavor = np.zeros(len(rows), bool)
            flavor[len(exact_rows):] = True
            dists, ids = self._unified_masked_stage(
                graph, task.queries[rows], unique, idx, flavor, pq_pool, k_out
            )
            _emit(rows, dists, ids)
        else:
            # one dispatch per flavor: the single-mask kernel for one unique
            # row, else the dedup'd plane
            if exact_rows:
                unique, idx = self._dedup_rows(exact_masks, exact_keys)
                if len(unique) == 1:
                    dists, ids = self._exact_masked(
                        graph, task.queries[exact_rows], unique[0], k_out
                    )
                else:
                    dists, ids = self._exact_masked_plane(
                        graph, task.queries[exact_rows], unique, idx, k_out
                    )
                _emit(exact_rows, dists, ids)
            if pq_rows:
                unique, idx = self._dedup_rows(pq_masks, pq_keys)
                if len(unique) == 1:
                    dists, ids = self._masked_pq_stage(
                        graph, task.queries[pq_rows], unique[0], pq_pool, k_out
                    )
                else:
                    dists, ids = self._masked_pq_plane(
                        graph, task.queries[pq_rows], unique, idx, pq_pool, k_out
                    )
                _emit(pq_rows, dists, ids)
        for w, rows in sorted(beam_rows.items()):
            dists, ids = self._shard_search(task, graph, task.queries[rows], width=w or None)
            _emit(rows, dists, ids)
        short_rows: List[int] = []
        if post_rows:
            short_rows += self._postfilter_pooled(
                task, graph, locmap, result, qidx, post_rows, post_masks, post_ks
            )
        if mbeam_rows:
            short_rows += self._masked_beam_pooled(
                task, graph, locmap, result, qidx, mbeam_rows, mbeam_masks, mbeam_ks
            )
        if short_rows:
            self._fused_exact_fallback(
                task, graph, locmap, result, qidx, sorted(short_rows),
                {**post_masks, **mbeam_masks},
            )

    def _masked_beam_pooled(
        self,
        task,
        graph,
        locmap,
        result,
        qidx: np.ndarray,
        rows_by_width: Dict[int, List[int]],
        masks_by_row: Dict[int, np.ndarray],
        ks_by_row: Dict[int, int],
    ) -> List[int]:
        """MaskedBeam rows of a fragment: one traversal per distinct width,
        each row under its own mask row and sliced to its own k.  Returns
        the under-delivered rows for the fused fallback."""
        short_rows: List[int] = []
        total = 0
        for width, rows in sorted(rows_by_width.items()):
            unique, idx = self._dedup_rows(
                [masks_by_row[bi] for bi in rows], [task.filters[bi] for bi in rows]
            )
            dists, ids = self._masked_beam_core(
                task, graph, task.queries[rows], unique, idx, width,
                max(ks_by_row[bi] for bi in rows),
            )
            total += len(rows)
            for j, bi in enumerate(rows):
                kj = ks_by_row[bi]
                dj, ij = dists[j, :kj], ids[j, :kj]
                if np.isinf(dj).any():
                    short_rows.append(bi)
                else:
                    result.candidates[int(qidx[bi])] = self._row_candidates(
                        graph, locmap, dj, ij, task.shard_id
                    )
        self._count_mbeam(total, len(short_rows))
        return short_rows

    def _fused_exact_fallback(
        self,
        task,
        graph,
        locmap,
        result,
        qidx: np.ndarray,
        short_rows: List[int],
        masks_by_row: Dict[int, np.ndarray],
    ) -> None:
        """One masked-kernel call answers every beam row the fragment
        under-delivered, postfilter and masked-beam rows alike."""
        k_out = max(1, min(task.k * task.oversample, graph.n))
        unique, idx = self._dedup_rows(
            [masks_by_row[bi] for bi in short_rows], [task.filters[bi] for bi in short_rows]
        )
        if len(unique) == 1:
            d, i = self._exact_masked(graph, task.queries[short_rows], unique[0], k_out)
        else:
            d, i = self._exact_masked_plane(graph, task.queries[short_rows], unique, idx, k_out)
        for j, bi in enumerate(short_rows):
            result.candidates[int(qidx[bi])] = self._row_candidates(
                graph, locmap, d[j], i[j], task.shard_id
            )

    def _postfilter_pooled(
        self,
        task,
        graph,
        locmap,
        result,
        qidx: np.ndarray,
        rows_by_pool: Dict[int, List[int]],
        masks_by_row: Dict[int, np.ndarray],
        ks_by_row: Dict[int, int],
    ) -> List[int]:
        """PostfilterBeam rows of a fragment: one over-fetched beam pass per
        distinct pool, each row filtered under its own mask and sliced to
        its own k.  Returns the under-delivered rows for the fused
        fallback."""
        short_rows: List[int] = []
        for pool, rows in sorted(rows_by_pool.items()):
            plane = np.stack([masks_by_row[bi] for bi in rows])
            dists, ids = self._postfilter_beam_core(task, graph, task.queries[rows], plane, pool)
            for j, bi in enumerate(rows):
                kj = ks_by_row[bi]
                dj, ij = dists[j, :kj], ids[j, :kj]
                if np.isinf(dj).any():
                    short_rows.append(bi)
                else:
                    result.candidates[int(qidx[bi])] = self._row_candidates(
                        graph, locmap, dj, ij, task.shard_id
                    )
        return short_rows

    def _rerank(self, task: F.RerankTaskInfo) -> F.RerankResult:
        """Stage B on this executor's files: read the masked rows
        (``rerank.read``, host only), score the union of every query's rows
        in one ``exact_distances`` call (``rerank.score``, ends at its
        ``.cpu()``), then each query's owned rows and top ``keep``
        (``rerank.select``, host only)."""
        vec_parts: List[np.ndarray] = []
        with spans.span("rerank.read"):
            for fpath, groups in task.masks.items():
                reader = VParquetReader.from_store(self.store, fpath)
                for rg_id, offsets in groups.items():
                    vec_parts.append(reader.read_rows("vec", rg_id, offsets))
        result = F.RerankResult(executor_id=self.executor_id)
        q = np.ascontiguousarray(task.queries, np.float32)
        if not any(len(v) for v in vec_parts):
            result.rows = [[] for _ in range(q.shape[0])]
            return result
        cands = np.concatenate(vec_parts)
        # the union of every query's rows is read and scored ONCE — a single
        # rerank_distances kernel call; ownership filters the (Q, N) matrix
        with spans.span("rerank.score"):
            d = ops.exact_distances(
                to_device(q, self.device),
                to_device(cands, self.device),
                metric=task.metric,
                backend="auto",
            ).cpu().numpy()
        with spans.span("rerank.select"):
            rows_flat: List[Tuple[str, int, int]] = []
            # per flat row: None => every query owns it, else the owning set
            owners_flat: List[Optional[set]] = []
            for fpath, groups in task.masks.items():
                f_own = task.file_owners.get(fpath) if task.file_owners else None
                r_own = task.row_owners.get(fpath) if task.row_owners else None
                for rg_id, offsets in groups.items():
                    rg_own = r_own.get(rg_id) if r_own is not None else None
                    for off in offsets:
                        rows_flat.append((fpath, rg_id, off))
                        if rg_own is not None:
                            owners_flat.append(rg_own.get(off, set()))
                        else:
                            owners_flat.append(f_own)
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

    def _refresh_shard(self, task: F.RefreshTaskInfo) -> F.RefreshResult:
        t0 = time.time()
        graph, locmap, _hit = self._load_shard(
            task.puffin_path, task.blob_offset, task.blob_length, task.blob_codec, task.cache_key
        )
        # deletions first: tombstone every vector whose source file was removed
        tombstoned = 0
        if task.removed_files:
            removed = set(task.removed_files)
            path_arr = np.array(
                [locmap.file_paths[int(i)] for i in locmap.file_idx[: graph.n]]
            )
            doomed = np.flatnonzero(np.isin(path_arr, list(removed)))
            fresh = doomed[~graph.tombstones[doomed]]
            graph.tombstone(fresh)
            tombstoned = int(len(fresh))
        # insertions: scan the added files, keep the rows this shard owns
        inserted = 0
        if task.added_files:
            vectors, fidx, rgrp, roff, paths = _scan_files_with_locations(
                self.store, task.added_files
            )
            if vectors.shape[0]:
                owners = _owner_shards(
                    vectors, task.partition_centroids, task.shard_of_partition, self.device
                )
                sel = np.flatnonzero(owners == task.shard_id)
                if len(sel):
                    graph.insert_batch(vectors[sel])
                    inserted = int(len(sel))
                    base = len(locmap.file_paths)
                    locmap.file_paths.extend(paths)
                    locmap.file_idx = np.concatenate([locmap.file_idx, fidx[sel] + base])
                    locmap.row_group = np.concatenate([locmap.row_group, rgrp[sel]])
                    locmap.row_offset = np.concatenate([locmap.row_offset, roff[sel]])
        blob = encode_shard_blob(graph, locmap, include_vectors=task.include_vectors)
        self.store.put(task.output_path, blob)
        # The refresh mutated the L1 entry's graph and location map in place:
        # evict it (a probe of the old snapshot re-decodes the old blob) and
        # every mask of this shard, with their device copies — the row set
        # changed, so masks computed before the refresh are stale.
        l1_key = f"{task.cache_key or task.puffin_path}@{task.blob_offset}"
        with self._lock:
            self._l1.pop(l1_key, None)
            for cache in (self._mask_cache, self._live_cache):
                for key in [kk for kk in cache if kk[0] == l1_key]:
                    self._dev_masks.pop(id(cache.pop(key)), None)
        return F.RefreshResult(
            shard_id=task.shard_id,
            output_path=task.output_path,
            executor_id=self.executor_id,
            inserted=inserted,
            tombstoned=tombstoned,
            vector_count=graph.n,
            byte_size=len(blob),
            tombstone_ratio=graph.tombstone_ratio,
            refresh_seconds=time.time() - t0,
            rg_membership=_locmap_membership(
                locmap, graph.n, live=~graph.tombstones[: graph.n]
            ),
        )
