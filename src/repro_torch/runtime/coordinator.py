"""Coordinator: index lifecycle orchestration (paper §3.1, §5, §6, §7).

Copy of ``repro/runtime/coordinator.py`` with a ``device`` for the
coordinator's own Stage-0 work (and for decoding a shard it rebuilds).
The port's executors answer every task it sends: builds, probes (filtered,
batched, quantized, over the fresh tail), reranks and refreshes.

Implements the paper's three protocols against the runtime substrate:

- :meth:`Coordinator.create_index` — Stage 0 (sample + k-means + PQ train on
  the coordinator), Stage 1 (parallel per-shard build on executors, with the
  centroid-mode all-to-all exchange), Stage 2 (assemble the Puffin file,
  optimistic-concurrency commit of ``statistics-file``).
- :meth:`Coordinator.probe` — tiered probe placement: coordinator-local
  centroid pruning below the size threshold, else the three-stage
  distributed probe (Stage A shard beam search → Stage B exact rerank on
  row-group masks → Stage C ordered merge).
- :meth:`Coordinator.probe_batch` — the batched multi-query pipeline:
  centroid routing and tiered placement are vectorized over the whole
  batch, the scheduler coalesces per-(query, shard) probe fragments into
  at most ONE fragment per shard (each executor runs a single batched
  beam search + rerank kernel call for all queries routed to it), Stage B
  reads the union of every query's candidate rows once with per-query
  ownership, and Stage C does a per-query ordered merge.  Per-query
  results are identical to sequential :meth:`probe` calls; dispatch,
  kernel-launch, and I/O costs amortize across the batch.
- :meth:`Coordinator.refresh_index` — manifest diff → per-shard greedy
  insert + lazy tombstones → per-shard rebuild above the tombstone-ratio
  threshold → metadata-only commit.  Unchanged shard blobs are byte-copied
  into the new Puffin, never rebuilt or re-encoded.

Both probe entry points take ``filter=`` (a predicate tree or SQL WHERE
fragment): the coordinator zone-map-prunes shards/row-groups, then plans
per shard by estimated selectivity — pre-filter exact scan (few rows
pass), filter-aware masked beam (mid), or over-fetched post-filter (most
rows pass) — with per-query predicates surviving fragment coalescing.
A batch carrying heterogeneous predicates is NOT split per predicate
group on the kernel path: each coalesced fragment ships its per-query
predicate list and the executor answers every kernel-planned query with
one multi-mask (Q, N)-plane kernel call per shard
(``ProbeReport.kernel_dispatches`` counts the calls).
"""

from __future__ import annotations

import heapq
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.blobs import (
    ATTR_ZONEMAP_BLOB_TYPE,
    CENTROID_BLOB_TYPE,
    FRESH_TAIL_BLOB_TYPE,
    ROUTING_BLOB_TYPE,
    SHARD_BLOB_TYPE,
    AttrZoneMap,
    FreshTail,
    RoutingTable,
    ShardInfo,
    build_zonemap,
    decode_fresh_tail_blob,
    decode_routing_blob,
    decode_zonemap_blob,
    encode_routing_blob,
    encode_zonemap_blob,
)
from repro_torch.core.centroid_index import CentroidIndex, build_centroid_index
from repro_torch.core.kmeans import train_kmeans
from repro_torch.core.pq import train_pq
from repro_torch.iceberg.catalog import RestCatalog
from repro_torch.iceberg.diff import diff_snapshots
from repro_torch.iceberg.puffin import PuffinReader, PuffinWriter, preferred_codec
from repro_torch.iceberg.snapshot import Snapshot, TableMetadata
from repro_torch.kernels.device_cache import resolve_device
from repro_torch.lakehouse.table import LakehouseTable
from repro_torch.runtime import fragments as F
from repro_torch.runtime import planner
from repro_torch.runtime.planner import PlanOp, ProbePlan
from repro_torch.runtime.predicates import Predicate, parse_predicate, row_group_mask
from repro_torch.runtime.scheduler import ExecutorPool, Scheduler
from repro_torch.serving import metrics as spans
from repro_torch.serving.cache import ShardProbeCache, query_digest
from repro_torch.serving.metrics import MetricsRegistry

TOMBSTONE_REBUILD_THRESHOLD = 0.20  # paper §7.3

# Fresh-tail compaction: once the appended-but-unindexed tail crosses this
# many rows, fold it into the Vamana shards (a refresh commit) — below it
# the exact tail scan is cheaper than a graph rebuild (paper §7.3's
# incremental-refresh economics applied to the delta tier).
TAIL_COMPACT_THRESHOLD_ROWS = 4096

# Selectivity-adaptive filtered-probe planning lives in runtime/planner.py
# (the probe-plan IR): the coordinator asks the planner for per-(query,
# shard) plan ops and ships them with the tasks; executors interpret them.


@dataclass
class IndexConfig:
    name: str
    column: str = "vec"
    R: int = 64
    L: int = 100
    alpha: float = 1.2
    metric: str = "l2"
    pq_m: int = 0  # 0 => full-precision graph only
    pq_nbits: int = 8
    num_shards: Optional[int] = None  # default: one per live executor
    partitions_per_shard: int = 4
    include_vectors: bool = True
    sample_rate: float = 0.01
    # PQ codebooks train on this sample: too small a floor measurably hurts
    # ADC quality (EXPERIMENTS §1) — 8k ≈ 1% of the smallest bench corpus
    min_sample: int = 8192
    partition_mode: str = "centroid"  # centroid | file
    coordinator_probe_threshold_mb: float = 100.0  # paper §3.3
    oversample: int = 4  # paper §9.3
    build_passes: int = 2
    build_batch: int = 128


@dataclass
class BuildReport:
    puffin_path: str
    snapshot_id: int
    base_snapshot_id: int
    num_shards: int
    vector_count: int
    total_bytes: int
    stage0_seconds: float
    stage1_seconds: float
    stage2_seconds: float
    shard_results: List[F.IndexBuildResult] = field(default_factory=list)


@dataclass
class ProbeHit:
    file_path: str
    row_group: int
    row_offset: int
    distance: float


@dataclass
class ProbeReport:
    hits: List[List[ProbeHit]]  # per query
    strategy: str
    files_scanned: int
    bytes_read: int
    stage_a_seconds: float = 0.0
    stage_b_seconds: float = 0.0
    stage_c_seconds: float = 0.0
    shards_probed: int = 0
    cache_hits: int = 0
    # batched pipeline: how many queries rode this probe and how many
    # shard-probe fragments were actually dispatched after coalescing
    batch_size: int = 0
    probe_fragments: int = 0
    # filtered search: predicate pushed through the probe, zone-map pruning
    # effect, and the selectivity-adaptive plan that was chosen
    filtered: bool = False
    filter_plan: str = ""  # e.g. "prefilter:2,pruned:1"
    shards_pruned: int = 0
    # (query, shard) probe fragments dropped by zone pruning BEFORE
    # coalescing — the per-query signal; shards_pruned is the per-predicate
    # union of whole shards
    fragments_pruned: int = 0
    row_groups_pruned: int = 0
    est_selectivity: float = 1.0
    # masked top-k kernel calls summed over the probed shards: with the
    # mask-plane executor path a coalesced fragment costs ONE dispatch per
    # shard — the unified kernel fuses exact and PQ-ADC flavors — however
    # many distinct predicates the batch carries
    kernel_dispatches: int = 0
    # MaskedBeam accounting, summed over the probed shards: query rows
    # answered by the predicate-aware traversal (big-shard selective
    # filters), and how many of those under-delivered and were re-answered
    # by the fused exact-masked fallback — the bench bounds the fallback
    # rate so a "beam win" can't silently be the fallback doing the work
    masked_beam_rows: int = 0
    masked_beam_fallbacks: int = 0
    # the probe-plan IR artifact (runtime/planner.py ProbePlan): the
    # per-(query, shard) op grid the coordinator planned, loggable and
    # round-trippable via to_json/from_json.  None on unplanned paths
    # (scan/centroid, unfiltered single probes) — but ALWAYS present when a
    # fresh tail was served: the tail adds exactly one ExactScan op per
    # unindexed row group, keyed by its synthetic negative id.
    plan: Optional[ProbePlan] = None
    # fresh-tail tier: rows appended since the index's base snapshot that
    # this probe served through tail ExactScan ops ...
    tail_rows: int = 0
    # ... and rows the probe could NOT see.  The tail tier makes this an
    # invariant 0; it is nonzero only with ``include_tail=False`` (the
    # pre-fix silent-drop behavior, kept reachable for regression tests).
    unindexed_rows: int = 0
    # the probed snapshot serves a stale index binding (an append/delete
    # landed after the index was built and no refresh has committed since)
    stale: bool = False
    # serving-tier trail: which executor served each fragment of this probe
    # ("probe:<shard>@<executor>" for Stage A / tail fragments,
    # "rerank@<executor>" for Stage B) — the audit trail for lease failover
    served_by: List[str] = field(default_factory=list)
    # degradation labels the serving tier applied before issuing this probe
    # (e.g. "shrink_k(x0.5)", "skip_tail"); empty = full-quality answer.
    # The coordinator never sets this — the micro-batcher stamps it so
    # degraded answers are labeled, not silent.
    degraded: Tuple[str, ...] = ()
    # cache provenance: "shard" when at least one Stage-A fragment was
    # answered from the coordinator's snapshot-keyed shard-probe cache,
    # "semantic" on the report a semantic-cache entry carries; None means
    # the answer was fully computed.  (cache_hits above stays the
    # executor-local blob-cache count — a different layer.)
    cache: Optional[str] = None
    # snapshot the probe resolved its index binding against (None on the
    # scan path) — the serving tier's semantic cache watermarks on it
    snapshot_id: Optional[int] = None
    # (query, shard) Stage-A fragments served from the shard-probe cache,
    # skipping mask evaluation and the kernel dispatch for that fragment
    shard_cache_hits: int = 0


@dataclass
class RefreshReport:
    puffin_path: str
    snapshot_id: int
    base_snapshot_id: int
    inserted: int
    tombstoned: int
    shards_refreshed: int
    shards_rebuilt: int
    shards_reused: int
    seconds: float
    noop: bool = False


class Coordinator:
    def __init__(
        self,
        catalog: RestCatalog,
        pool: ExecutorPool,
        *,
        enable_speculation: bool = False,
        max_attempts: int = 4,
        metrics: Optional["MetricsRegistry"] = None,
        probe_cache: Optional[ShardProbeCache] = None,
        device="cuda",
    ) -> None:
        self.catalog = catalog
        # Stage-0 training (k-means, PQ, partition packing) runs here
        self.device = resolve_device(device)
        self.store = catalog.store
        self.pool = pool
        # optional cross-batch Stage-A shard-probe cache (serving/cache.py);
        # None (the default) keeps every probe fully computed
        self.probe_cache = probe_cache
        # one serving-tier metrics registry shared with the scheduler and
        # its lease table: counters for re-dispatches, lease grants/expiries
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if self.probe_cache is not None and self.probe_cache.metrics is None:
            self.probe_cache.metrics = self.metrics
        self.scheduler = Scheduler(
            pool,
            enable_speculation=enable_speculation,
            max_attempts=max_attempts,
            metrics=self.metrics,
        )
        # serving-tier result caches subscribed for push invalidation: a
        # refresh/compaction commit moves their snapshot watermark at the
        # commit itself — the pull path (watermarking drained probe
        # reports) only fires after a probe, which would leave a window
        # where a cached whole answer for the old snapshot still serves
        self._result_caches: Dict[str, List[object]] = {}
        # decoded attribute zone maps, keyed by (immutable) puffin path —
        # filtered probes on the serving path must not re-decode the blob
        self._zonemap_cache: Dict[str, Optional[AttrZoneMap]] = {}
        # decoded fresh-tail manifests, keyed by (immutable) tail puffin path
        self._tail_cache: Dict[str, FreshTail] = {}

    # ---------------------------------------------------------- invalidation
    def register_result_cache(self, table_name: str, cache: object) -> None:
        """Subscribe a result cache (anything with ``observe_snapshot``) to
        commit-time invalidation for ``table_name``.  Idempotent."""
        subscribed = self._result_caches.setdefault(table_name, [])
        if not any(rc is cache for rc in subscribed):
            subscribed.append(cache)

    def unregister_result_cache(self, table_name: str, cache: object) -> None:
        subscribed = self._result_caches.get(table_name, [])
        self._result_caches[table_name] = [rc for rc in subscribed if rc is not cache]

    def _invalidate_caches(self, table_name: str, new_snapshot_id: int) -> None:
        """The commit is the invalidation token: drop shard-probe entries
        keyed by any older snapshot and move every subscribed result
        cache's watermark, so neither layer can serve a pre-commit answer."""
        if self.probe_cache is not None:
            self.probe_cache.invalidate(table_name, new_snapshot_id)
        for rc in self._result_caches.get(table_name, ()):
            rc.observe_snapshot(new_snapshot_id)

    # ------------------------------------------------------------------ build
    def create_index(self, table_name: str, cfg: IndexConfig) -> BuildReport:
        table = LakehouseTable(self.catalog, table_name)
        meta = table.metadata()
        snap = meta.current_snapshot()
        if snap is None:
            raise ValueError(f"table {table_name} has no snapshot")
        files = [f.path for f in table.current_files()]
        if not files:
            raise ValueError(f"table {table_name} has no data files")
        live = self.pool.live()
        num_shards = cfg.num_shards or max(1, len(live))

        # ---- Stage 0: sampling + centroid training (coordinator) --------
        t0 = time.time()
        sample = self._sample_vectors(table, files, cfg)
        k = num_shards * cfg.partitions_per_shard
        k = min(k, max(1, sample.shape[0] // 4))
        centroids, _ = train_kmeans(sample, k, iters=15, seed=0, device=self.device)
        shard_of_partition = self._pack_partitions(sample, centroids, num_shards)
        pq_codebook = None
        if cfg.pq_m:
            pq_codebook = train_pq(
                sample, m=cfg.pq_m, nbits=cfg.pq_nbits, metric=cfg.metric,
                device=self.device,
            ).codebook
        stage0 = time.time() - t0

        # ---- Stage 1: parallel shard build (executors) --------------------
        t1 = time.time()
        token = uuid.uuid4().hex[:8]
        out_prefix = f"{meta.location}/metadata/ann-{cfg.name}-snap-{snap.snapshot_id}-{token}"
        build_tasks: List[F.IndexBuildTaskInfo] = []
        if cfg.partition_mode == "centroid":
            exchanged = self._exchange(files, centroids, shard_of_partition, num_shards)
            for sid in range(num_shards):
                payload = exchanged.get(sid)
                if payload is None:
                    continue
                build_tasks.append(
                    F.IndexBuildTaskInfo(
                        task_id=f"build-{cfg.name}-{sid}",
                        shard_id=sid,
                        assigned_files=[],
                        partition_centroids=centroids,
                        shard_of_partition=shard_of_partition,
                        R=cfg.R,
                        L=cfg.L,
                        alpha=cfg.alpha,
                        metric=cfg.metric,
                        pq_m=cfg.pq_m,
                        pq_nbits=cfg.pq_nbits,
                        pq_codebook=pq_codebook,
                        include_vectors=cfg.include_vectors,
                        output_path=f"{out_prefix}-shard-{sid}.blob",
                        partition_mode=cfg.partition_mode,
                        build_passes=cfg.build_passes,
                        build_batch=cfg.build_batch,
                        exchanged=payload,
                    )
                )
        else:  # file mode: each shard owns a file subset, no exchange
            file_groups = [list(files[i::num_shards]) for i in range(num_shards)]
            for sid, group in enumerate(file_groups):
                if not group:
                    continue
                build_tasks.append(
                    F.IndexBuildTaskInfo(
                        task_id=f"build-{cfg.name}-{sid}",
                        shard_id=sid,
                        assigned_files=group,
                        partition_centroids=centroids,
                        shard_of_partition=shard_of_partition,
                        R=cfg.R,
                        L=cfg.L,
                        alpha=cfg.alpha,
                        metric=cfg.metric,
                        pq_m=cfg.pq_m,
                        pq_nbits=cfg.pq_nbits,
                        pq_codebook=pq_codebook,
                        include_vectors=cfg.include_vectors,
                        output_path=f"{out_prefix}-shard-{sid}.blob",
                        partition_mode="file",
                        build_passes=cfg.build_passes,
                        build_batch=cfg.build_batch,
                    )
                )
        results: List[F.IndexBuildResult] = self.scheduler.run_wave(build_tasks)
        stage1 = time.time() - t1

        # ---- Stage 2: assemble Puffin + commit (coordinator) -----------------
        t2 = time.time()
        centroid_index = build_centroid_index(table, metric=cfg.metric)
        zonemap = build_zonemap(self.store, files)
        if zonemap is not None:
            zonemap.shard_membership = {
                r.shard_id: r.rg_membership for r in results if r.rg_membership
            }
        puffin_path, total_bytes = self._assemble_puffin(
            meta,
            snap,
            cfg,
            centroids,
            shard_of_partition,
            results,
            centroid_index,
            files,
            out_prefix,
            zonemap=zonemap,
        )
        new_meta = self.catalog.set_statistics_file(
            table_name,
            puffin_path,
            expected_base_snapshot_id=snap.snapshot_id,
            extra_summary={
                "ann.index-name": cfg.name,
                "ann.base-snapshot-id": str(snap.snapshot_id),
                "ann.num-shards": str(len(results)),
            },
        )
        # CREATE INDEX commits a new snapshot too — same invalidation flow
        self._invalidate_caches(table_name, new_meta.current_snapshot_id)
        stage2 = time.time() - t2
        return BuildReport(
            puffin_path=puffin_path,
            snapshot_id=new_meta.current_snapshot_id,
            base_snapshot_id=snap.snapshot_id,
            num_shards=len(results),
            vector_count=sum(r.vector_count for r in results),
            total_bytes=total_bytes,
            stage0_seconds=stage0,
            stage1_seconds=stage1,
            stage2_seconds=stage2,
            shard_results=results,
        )

    # -- Stage-0 helpers ------------------------------------------------------
    def _sample_vectors(
        self, table: LakehouseTable, files: List[str], cfg: IndexConfig
    ) -> np.ndarray:
        rng = np.random.default_rng(0)
        order = rng.permutation(len(files))
        total_rows = 0
        parts: List[np.ndarray] = []
        for fi in order:
            reader = table.reader(files[fi])
            parts.append(reader.read_column("vec"))
            total_rows += parts[-1].shape[0]
            if total_rows >= cfg.min_sample / max(cfg.sample_rate, 1e-9) * cfg.sample_rate and len(
                parts
            ) >= max(1, int(0.1 * len(files))):
                break
        vecs = np.concatenate(parts)
        want = max(cfg.min_sample, int(cfg.sample_rate * vecs.shape[0]))
        if vecs.shape[0] > want:
            vecs = vecs[rng.choice(vecs.shape[0], want, replace=False)]
        return vecs

    def _pack_partitions(
        self, sample: np.ndarray, centroids: np.ndarray, num_shards: int
    ) -> np.ndarray:
        """Greedy bin-pack partitions onto shards by sampled mass."""
        from repro_torch.core.kmeans import assign

        part = assign(sample, centroids, device=self.device)
        counts = np.bincount(part, minlength=centroids.shape[0])
        shard_of = np.zeros(centroids.shape[0], np.uint32)
        loads = [(0, s) for s in range(num_shards)]
        heapq.heapify(loads)
        for p in np.argsort(-counts):
            load, s = heapq.heappop(loads)
            shard_of[p] = s
            heapq.heappush(loads, (load + int(counts[p]), s))
        return shard_of

    def _exchange(
        self,
        files: List[str],
        centroids: np.ndarray,
        shard_of_partition: np.ndarray,
        num_shards: int,
    ) -> Dict[int, tuple]:
        """Stage-1a all-to-all: executors scan their file subsets and group
        vectors by owner shard; the coordinator merges the groups."""
        live = self.pool.live()
        n_scan = max(1, len(live))
        scan_tasks = [
            F.ScanPartitionTaskInfo(
                task_id=f"scan-{i}",
                assigned_files=list(files[i::n_scan]),
                partition_centroids=centroids,
                shard_of_partition=shard_of_partition,
                num_shards=num_shards,
            )
            for i in range(n_scan)
            if files[i::n_scan]
        ]
        scan_results: List[F.ScanPartitionResult] = self.scheduler.run_wave(scan_tasks)
        merged: Dict[int, tuple] = {}
        for sid in range(num_shards):
            vec_parts, fidx_parts, rg_parts, ro_parts, paths = [], [], [], [], []
            for res in scan_results:
                if sid not in res.per_shard:
                    continue
                v, fi, rg, ro, p = res.per_shard[sid]
                base = len(paths)
                paths.extend(p)
                vec_parts.append(v)
                fidx_parts.append(fi.astype(np.uint32) + base)
                rg_parts.append(rg)
                ro_parts.append(ro)
            if vec_parts:
                merged[sid] = (
                    np.concatenate(vec_parts),
                    np.concatenate(fidx_parts),
                    np.concatenate(rg_parts),
                    np.concatenate(ro_parts),
                    paths,
                )
        return merged

    # -- Stage-2 helpers ----------------------------------------------------------
    def _assemble_puffin(
        self,
        meta: TableMetadata,
        snap: Snapshot,
        cfg: IndexConfig,
        centroids: np.ndarray,
        shard_of_partition: np.ndarray,
        results: List[F.IndexBuildResult],
        centroid_index: CentroidIndex,
        covered_files: List[str],
        out_prefix: str,
        tombstone_ratios: Optional[Dict[int, float]] = None,
        raw_shard_bytes: Optional[Dict[int, bytes]] = None,
        zonemap: Optional[AttrZoneMap] = None,
    ) -> Tuple[str, int]:
        writer = PuffinWriter(
            file_properties={
                "created-by": "repro-flockdb",
                "ann.index-name": cfg.name,
            }
        )
        ratios = tombstone_ratios or {}
        shards = [
            ShardInfo(
                shard_id=r.shard_id,
                blob_index=2 + i,  # 0 = routing, 1 = centroid index
                vector_count=r.vector_count,
                byte_size=r.byte_size,
                tombstone_ratio=ratios.get(r.shard_id, 0.0),
                executor_hint=r.executor_id,
            )
            for i, r in enumerate(results)
        ]
        routing = RoutingTable(
            base_snapshot_id=snap.snapshot_id,
            dims=centroids.shape[1],
            metric=cfg.metric,
            params={
                "R": str(cfg.R),
                "L": str(cfg.L),
                "alpha": str(cfg.alpha),
                "pq_m": str(cfg.pq_m),
                "pq_nbits": str(cfg.pq_nbits),
                "oversample": str(cfg.oversample),
                "include_vectors": str(cfg.include_vectors),
                "partition_mode": cfg.partition_mode,
            },
            shards=shards,
            covered_files=covered_files,
            partition_centroids=centroids,
            shard_of_partition=shard_of_partition,
        )
        writer.add_blob(
            encode_routing_blob(routing),
            type=ROUTING_BLOB_TYPE,
            snapshot_id=snap.snapshot_id,
            properties={"ann.index-name": cfg.name},
        )
        writer.add_blob(
            centroid_index.to_blob(),
            type=CENTROID_BLOB_TYPE,
            snapshot_id=snap.snapshot_id,
            # zstd when available, zlib otherwise — the footer records the
            # codec actually applied, so readers stay environment-agnostic
            compression=preferred_codec(),
            properties={
                "dimensions": str(centroid_index.dim),
                "metric": cfg.metric,
                "entry-count": str(centroid_index.num_files),
                "computed-against-snapshot": str(snap.snapshot_id),
            },
        )
        for r in results:
            if raw_shard_bytes and r.shard_id in raw_shard_bytes:
                payload = raw_shard_bytes[r.shard_id]
            else:
                payload = self.store.get(r.output_path)
            writer.add_blob(
                payload,
                type=SHARD_BLOB_TYPE,
                snapshot_id=snap.snapshot_id,
                properties={
                    "shard-id": str(r.shard_id),
                    "vector-count": str(r.vector_count),
                    "tombstone-ratio": f"{ratios.get(r.shard_id, 0.0):.6f}",
                },
            )
        if zonemap is not None:
            # appended AFTER the shard blobs so ShardInfo.blob_index stays
            # stable (0 = routing, 1 = centroid, 2.. = shards)
            writer.add_blob(
                encode_zonemap_blob(zonemap),
                type=ATTR_ZONEMAP_BLOB_TYPE,
                snapshot_id=snap.snapshot_id,
                properties={"columns": ",".join(sorted(zonemap.columns))},
            )
        data = writer.finish()
        puffin_path = f"{out_prefix}.puffin"
        self.store.put(puffin_path, data)
        # the standalone shard blobs are now redundant: orphaned + GC-able
        return puffin_path, len(data)

    # ------------------------------------------------------------------ probe
    def _resolve_index(
        self,
        table_name: str,
        snapshot_id: Optional[int] = None,
        as_of_ms: Optional[int] = None,
    ) -> Tuple[TableMetadata, Snapshot, str, PuffinReader]:
        meta = self.catalog.load_table(table_name)
        if as_of_ms is not None:
            snap = meta.snapshot_as_of(as_of_ms)
        elif snapshot_id is not None:
            snap = meta.snapshot_by_id(snapshot_id)
        else:
            snap = meta.current_snapshot()
        if snap is None:
            raise ValueError("no snapshot")
        # Resolution order: a freshly-bound index, else the stale binding
        # carried forward by append/delete commits (the index remains usable
        # but covers only the files live at its base snapshot — the paper's
        # freshness bound, §10 "update granularity is the snapshot").
        path = snap.statistics_file or snap.summary.get("ann.stale-statistics-file")
        if path is None:
            raise LookupError(f"snapshot {snap.snapshot_id} has no ANN index bound")
        reader = PuffinReader(self.store.stat(path).size, self.store.range_reader(path))
        return meta, snap, path, reader

    def _resolve_tail(self, snap: Snapshot) -> Optional[FreshTail]:
        """Fresh-tail manifest for ``snap``: non-None only when the snapshot
        serves a stale index binding (``statistics_file`` unset — a fresh
        index covers everything) and an append since the index's base
        snapshot recorded unindexed row groups.  Tail Puffin files are
        immutable, so the decode is cached per path."""
        if snap.statistics_file is not None:
            return None
        path = snap.summary.get("ann.fresh-tail-file")
        if path is None:
            return None
        tail = self._tail_cache.get(path)
        if tail is None:
            reader = PuffinReader(
                self.store.stat(path).size, self.store.range_reader(path)
            )
            tail = decode_fresh_tail_blob(reader.read_first(FRESH_TAIL_BLOB_TYPE))
            if len(self._tail_cache) >= 8:
                self._tail_cache.pop(next(iter(self._tail_cache)))
            self._tail_cache[path] = tail
        return tail if tail.entries else None

    def probe(
        self,
        table_name: str,
        queries: np.ndarray,
        k: int,
        *,
        strategy: str = "auto",
        n_probe: int = 16,
        snapshot_id: Optional[int] = None,
        as_of_ms: Optional[int] = None,
        use_pq: Optional[bool] = None,
        L: Optional[int] = None,
        filter: Optional[object] = None,
        include_tail: bool = True,
        scan_dtype: str = "f32",
    ) -> ProbeReport:
        """Vector top-k query.  ``strategy``: auto | diskann | centroid | scan.

        ``scan_dtype`` (``f32`` | ``bf16`` | ``int8``) selects the scoring
        precision of planner-emitted ExactScan ops; reduced-precision scans
        always restore full-precision distances through the gather-rerank
        guard (planner.quant_guard_pool), so only Stage-A scan bandwidth —
        not the returned distances — is quantized.

        ``filter`` pushes an attribute predicate (a
        :class:`repro_torch.runtime.predicates.Predicate` or a SQL WHERE fragment
        string) through the probe: results are the top-k among rows
        satisfying it.  ``strategy="scan"`` with a filter is the brute-force
        post-filter oracle.

        ``include_tail=False`` disables the fresh-tail tier: rows appended
        since the index's base snapshot are silently dropped (the pre-fix
        behavior) and surface as ``ProbeReport.unindexed_rows`` instead."""
        with spans.batch("probe.batch"):
            queries = np.atleast_2d(np.asarray(queries, np.float32))
            pred = self._coerce_filter(filter)
            self.store.metrics.reset()
            table = LakehouseTable(self.catalog, table_name)
            if strategy == "scan":
                # reads the snapshot's own file list — fresh by construction
                return self._probe_scan(table, queries, k, snapshot_id, pred=pred)
            with spans.span("probe.plan"):
                meta, snap, puffin_path, reader = self._resolve_index(
                    table_name, snapshot_id, as_of_ms
                )
                full_tail = self._resolve_tail(snap)
                tail = full_tail if include_tail else None
                routing = decode_routing_blob(reader.read_first(ROUTING_BLOB_TYPE))
                shard_blobs = reader.blobs_of_type(SHARD_BLOB_TYPE)
                strategy = self._choose_strategy(strategy, routing, shard_blobs)
            if strategy == "centroid":
                report = self._probe_centroid(
                    table, reader, queries, k, n_probe, pred=pred,
                    puffin_path=puffin_path, tail=tail,
                )
            else:
                report = self._probe_diskann(
                    table,
                    routing,
                    shard_blobs,
                    puffin_path,
                    queries,
                    k,
                    use_pq=use_pq,
                    L=L,
                    pred=pred,
                    zonemap=(
                        self._read_zonemap(reader, puffin_path) if pred is not None else None
                    ),
                    tail=tail,
                    scan_dtype=scan_dtype,
                )
            self._apply_tail_report(report, snap, full_tail, served=tail is not None)
            return report

    @staticmethod
    def _apply_tail_report(
        report: ProbeReport,
        snap: Snapshot,
        full_tail: Optional[FreshTail],
        served: bool,
    ) -> None:
        """Freshness accounting, uniform across index-backed probe paths:
        every appended-but-unindexed row is either served through the tail
        tier (``tail_rows``) or dropped (``unindexed_rows`` — nonzero only
        with ``include_tail=False``)."""
        report.stale = snap.statistics_file is None
        if full_tail is None:
            return
        if served:
            report.tail_rows = full_tail.total_rows
        else:
            report.unindexed_rows = full_tail.total_rows

    @staticmethod
    def _choose_strategy(strategy: str, routing: RoutingTable, shard_blobs) -> str:
        """Tiered placement (paper §3.3): large sharded indexes go to
        executors; otherwise coordinator-local centroid probing.  The
        decision is per-index, so one evaluation covers a whole batch."""
        if strategy != "auto":
            return strategy
        threshold = 100.0 * 1024 * 1024
        if shard_blobs and sum(b.length for b in shard_blobs) > 0:
            total = sum(b.length for b in shard_blobs)
            strategy = "diskann" if total > 0 else "centroid"
            # small graphs still probe distributed if present; centroid
            # path is chosen when only the centroid blob exists or the
            # index is tiny enough to fit the coordinator budget.
            if total <= threshold and not routing.shards:
                strategy = "centroid"
        else:
            strategy = "centroid"
        return strategy

    # -- filtered-search planning ------------------------------------------
    @staticmethod
    def _coerce_filter(filter: Optional[object]) -> Optional[Predicate]:
        if filter is None or isinstance(filter, Predicate):
            return filter
        if isinstance(filter, str):
            return parse_predicate(filter)
        raise TypeError(f"filter must be a Predicate or SQL fragment, got {type(filter)}")

    def _read_zonemap(
        self, reader: PuffinReader, puffin_path: Optional[str] = None
    ) -> Optional[AttrZoneMap]:
        """Decode the index's zone-map blob, cached per puffin path (index
        Puffin files are immutable, so the decoded map never goes stale)."""
        if puffin_path is not None and puffin_path in self._zonemap_cache:
            return self._zonemap_cache[puffin_path]
        metas = reader.blobs_of_type(ATTR_ZONEMAP_BLOB_TYPE)
        zm = decode_zonemap_blob(reader.read_blob(metas[0])) if metas else None
        if puffin_path is not None:
            if len(self._zonemap_cache) >= 8:
                self._zonemap_cache.pop(next(iter(self._zonemap_cache)))
            self._zonemap_cache[puffin_path] = zm
        return zm

    @staticmethod
    def _plan_summary(ops: Dict[int, PlanOp], pruned: List[int]) -> str:
        """Token:count summary of one predicate's per-shard ops, in the
        historical prefilter/mask/postfilter vocabulary."""
        counts: Dict[str, int] = {}
        for op in ops.values():
            tok = planner.op_token(op)
            counts[tok] = counts.get(tok, 0) + 1
        parts = [f"{m}:{c}" for m, c in sorted(counts.items())]
        if pruned:
            parts.append(f"pruned:{len(pruned)}")
        return ",".join(parts)

    @staticmethod
    def _tail_only_plan(
        tail: Optional[FreshTail], k: int, batch: int
    ) -> Optional[ProbePlan]:
        """Descriptive plan for the coordinator-local (centroid) path: the
        centroid rerank is exact over every routed row, so the only IR worth
        recording is the tail tier — one ExactScan per unindexed row group,
        same synthetic ids as the distributed path."""
        if tail is None:
            return None
        tail_ops = planner.plan_tail(
            [cnt for _, _, cnt in tail.row_group_list()], k=k, oversample=1
        )
        return ProbePlan(
            k=k,
            oversample=1,
            use_pq=False,
            ops=[dict(tail_ops) for _ in range(batch)],
            est_selectivity=1.0,
            pruned_shards=(),
        )

    def _refresh_zonemap(
        self, reader: PuffinReader, puffin_path: str, covered: List[str]
    ) -> Optional[AttrZoneMap]:
        """Zone map for a refreshed index: reuse the prior map's zones for
        files it already covers (data files are immutable) and scan only the
        files it has never seen."""
        prior = self._read_zonemap(reader, puffin_path)
        if prior is None:
            return build_zonemap(self.store, covered)
        missing = [fp for fp in covered if fp not in prior.zones]
        fresh = build_zonemap(self.store, missing) if missing else None
        columns = dict(prior.columns)
        zones = {fp: prior.zones[fp] for fp in covered if fp in prior.zones}
        if fresh is not None:
            columns.update(fresh.columns)
            zones.update(fresh.zones)
        if not columns:
            return None
        return AttrZoneMap(columns=columns, zones=zones)

    def _filtered_masks(
        self,
        table: LakehouseTable,
        files: Sequence[str],
        pred: Optional[Predicate],
        zonemap: Optional[AttrZoneMap] = None,
    ) -> Tuple[Dict[str, Dict[int, List[int]]], int]:
        """Coordinator-side row masks for the scan/centroid paths: per file
        and row group, the offsets passing ``pred`` (all offsets when no
        predicate).  Zone maps skip row groups that cannot match before any
        attribute column is read.  Returns (masks, row_groups_pruned)."""
        masks: Dict[str, Dict[int, List[int]]] = {}
        rg_pruned = 0
        for fp in files:
            r = table.reader(fp)
            zones = zonemap.zones.get(fp) if zonemap is not None else None
            groups: Dict[int, List[int]] = {}
            for rg in range(len(r.row_groups)):
                if pred is not None and zones is not None and rg < len(zones):
                    if not pred.zone_may_match(zones[rg]):
                        rg_pruned += 1
                        continue
                if pred is None:
                    groups[rg] = list(range(r.row_groups[rg]["num_rows"]))
                else:
                    offs = np.flatnonzero(row_group_mask(pred, r, rg))
                    if len(offs):
                        groups[rg] = [int(o) for o in offs]
            if groups:
                masks[fp] = groups
        return masks, rg_pruned

    def probe_batch(
        self,
        table_name: str,
        queries: np.ndarray,
        k: int,
        *,
        strategy: str = "auto",
        n_probe: int = 16,
        snapshot_id: Optional[int] = None,
        as_of_ms: Optional[int] = None,
        use_pq: Optional[bool] = None,
        L: Optional[int] = None,
        n_route: Optional[int] = None,
        filter: Optional[object] = None,
        include_tail: bool = True,
        oversample: Optional[int] = None,
        replay_plan: Optional[ProbePlan] = None,
        scan_dtype: str = "f32",
    ) -> ProbeReport:
        """Batched vector top-k over ``queries (B, dim)``.

        Semantics match ``[probe(q) for q in queries]`` exactly, but the
        whole batch moves through the pipeline together: routing and tiered
        placement are vectorized, the scheduler coalesces shard probes to at
        most one fragment per shard, executors answer all of a fragment's
        queries with batched kernels, and Stage B reads the union of the
        batch's candidate rows once (per-query ownership keeps results
        independent).  ``n_route`` optionally restricts each query to the
        shards owning its ``n_route`` nearest partitions (recall dial; the
        default probes every shard, preserving exact parity with ``probe``).

        ``oversample`` overrides the index's configured Stage-B rerank
        multiplier for this probe (the serving tier's DropOversample
        degradation step); ``None`` keeps the routing-table value.

        ``replay_plan`` replays a previously planned (possibly deserialized
        — ``ProbePlan.from_json``) per-(query, shard) op grid: the
        coordinator skips selectivity estimation and plan construction
        entirely and dispatches the plan's ops as-is.  The caller must pass
        the same ``filter`` the plan was built under (executors still need
        the predicates to build row masks); fresh-tail ops are re-planned
        against the CURRENT tail, since the tail may have grown or been
        compacted since the plan was captured.  Only the diskann strategy
        is plannable.

        Spans (``serving.metrics``, while its log is on): ``probe.batch``
        (the call, under a new batch id; it ends with the hits on the
        host), ``probe.plan`` (index resolution, the routing blob and the
        strategy; on the diskann path also the routing and the tasks at
        Stage A's start; host only), ``probe.stage_a`` (the shard wave,
        which ends when every executor's results are on the host), then
        ``probe.stage_b`` and ``probe.stage_c`` (``_rerank_and_merge``).
        ``ProbeReport.stage_*_seconds`` are the three stage timers'
        durations, whether the log is on or not."""
        with spans.batch("probe.batch"):
            queries = np.atleast_2d(np.asarray(queries, np.float32))
            B = queries.shape[0]
            preds = self._coerce_filters_batch(filter, B)
            self.store.metrics.reset()
            table = LakehouseTable(self.catalog, table_name)
            if replay_plan is not None and strategy in ("scan", "centroid"):
                raise ValueError(f"replay_plan is not supported for strategy={strategy!r}")
            if strategy == "scan":
                if preds is None or len(set(preds)) == 1:
                    report = self._probe_scan(
                        table, queries, k, snapshot_id, pred=preds[0] if preds else None
                    )
                else:
                    report = self._grouped_filtered(
                        lambda q, p: self._probe_scan(table, q, k, snapshot_id, pred=p),
                        queries,
                        preds,
                    )
                report.batch_size = B
                return report
            with spans.span("probe.plan"):
                meta, snap, puffin_path, reader = self._resolve_index(
                    table_name, snapshot_id, as_of_ms
                )
                full_tail = self._resolve_tail(snap)
                tail = full_tail if include_tail else None
                routing = decode_routing_blob(reader.read_first(ROUTING_BLOB_TYPE))
                shard_blobs = reader.blobs_of_type(SHARD_BLOB_TYPE)
                strategy = self._choose_strategy(strategy, routing, shard_blobs)
            if replay_plan is not None and strategy != "diskann":
                raise ValueError(f"replay_plan is not supported for strategy={strategy!r}")
            if strategy == "centroid":
                if preds is None or len(set(preds)) == 1:
                    report = self._probe_centroid_batch(
                        table, reader, queries, k, n_probe,
                        pred=preds[0] if preds else None, puffin_path=puffin_path,
                        tail=tail,
                    )
                else:
                    # per-group batches keep per-query file ownership, so mixed
                    # filters still return exactly the sequential probes' hits
                    report = self._grouped_filtered(
                        lambda q, p: self._probe_centroid_batch(
                            table, reader, q, k, n_probe, pred=p,
                            puffin_path=puffin_path, tail=tail,
                        ),
                        queries,
                        preds,
                    )
            else:
                report = self._probe_diskann_batch(
                    table,
                    routing,
                    reader,
                    puffin_path,
                    queries,
                    k,
                    use_pq=use_pq,
                    L=L,
                    n_route=n_route,
                    preds=preds,
                    zonemap=(
                        self._read_zonemap(reader, puffin_path)
                        if preds and replay_plan is None
                        else None
                    ),
                    tail=tail,
                    scan_dtype=scan_dtype,
                    oversample_override=oversample,
                    replay_plan=replay_plan,
                    cache_ctx=(
                        (table_name, snap.snapshot_id)
                        if self.probe_cache is not None
                        else None
                    ),
                )
            self._apply_tail_report(report, snap, full_tail, served=tail is not None)
            report.batch_size = B
            report.snapshot_id = snap.snapshot_id
            return report

    def _coerce_filters_batch(
        self, filter: Optional[object], batch_size: int
    ) -> Optional[List[Optional[Predicate]]]:
        """Normalize probe_batch's ``filter`` argument: a single predicate
        (or WHERE string) fans out to every query; a sequence is per-query,
        ``None`` entries meaning that query is unfiltered."""
        if filter is None:
            return None
        if isinstance(filter, (Predicate, str)):
            return [self._coerce_filter(filter)] * batch_size
        preds = [self._coerce_filter(f) for f in filter]
        if len(preds) != batch_size:
            raise ValueError(f"{len(preds)} filters for {batch_size} queries")
        return None if all(p is None for p in preds) else preds

    def _grouped_filtered(
        self,
        fn,
        queries: np.ndarray,
        preds: List[Optional[Predicate]],
    ) -> ProbeReport:
        """Stitch heterogeneous-filter batches on paths whose masks are
        coordinator-computed (scan/centroid): one sub-probe per distinct
        predicate, hits re-interleaved into batch order, I/O stats summed."""
        groups: Dict[Optional[Predicate], List[int]] = {}
        for qi, p in enumerate(preds):
            groups.setdefault(p, []).append(qi)
        hits: List[Optional[List[ProbeHit]]] = [None] * len(preds)
        out: Optional[ProbeReport] = None
        for p, rows in groups.items():
            rep = fn(queries[rows], p)
            for j, qi in enumerate(rows):
                hits[qi] = rep.hits[j]
            if out is None:
                out = rep
            else:
                out.files_scanned += rep.files_scanned
                out.stage_a_seconds += rep.stage_a_seconds
                out.stage_b_seconds += rep.stage_b_seconds
                out.stage_c_seconds += rep.stage_c_seconds
                out.shards_probed += rep.shards_probed
                out.probe_fragments += rep.probe_fragments
                out.shards_pruned += rep.shards_pruned
                out.fragments_pruned += rep.fragments_pruned
                out.row_groups_pruned += rep.row_groups_pruned
                out.kernel_dispatches += rep.kernel_dispatches
                out.masked_beam_rows += rep.masked_beam_rows
                out.masked_beam_fallbacks += rep.masked_beam_fallbacks
        assert out is not None
        out.hits = hits
        # per-group bytes_read snapshots are cumulative since the batch's
        # reset — the final snapshot is the batch total
        out.bytes_read = self.store.metrics.bytes_read
        out.filtered = any(p is not None for p in preds)
        return out

    def _probe_scan(
        self,
        table: LakehouseTable,
        queries: np.ndarray,
        k: int,
        snapshot_id=None,
        pred: Optional[Predicate] = None,
    ) -> ProbeReport:
        """No-index baseline (paper Table 2 column 1): full scan + exact.
        With ``pred`` this is the brute-force post-filter oracle: every
        passing row is exact-ranked, so the result is the true filtered
        top-k."""
        stage_b = spans.timed("probe.stage_b").start()
        files = [f.path for f in table.current_files(snapshot_id)]
        masks, _ = self._filtered_masks(table, files, pred)
        report = self._rerank_and_merge(table, masks, queries, k, "l2", stage_b)
        report.strategy = "scan"
        report.files_scanned = len(files)
        report.bytes_read = self.store.metrics.bytes_read
        report.filtered = pred is not None
        return report

    def _probe_centroid(
        self,
        table: LakehouseTable,
        reader: PuffinReader,
        queries: np.ndarray,
        k: int,
        n_probe: int,
        pred: Optional[Predicate] = None,
        puffin_path: Optional[str] = None,
        tail: Optional[FreshTail] = None,
    ) -> ProbeReport:
        """Coordinator-tier probe (paper Table 2 column 2): prune the file
        list with the centroid index, then exact-rerank only those files.
        With a predicate the masks keep only passing rows, and the zone map
        (when the index carries one) skips row groups that cannot match.
        Fresh-tail files (appended since the index's base snapshot — the
        centroid index has never seen them) join every query's file list."""
        stage_a = spans.timed("probe.stage_a").start()
        ci = CentroidIndex.from_blob(reader.read_first(CENTROID_BLOB_TYPE))
        pruned: List[str] = []
        per_query_files: List[List[str]] = []
        for q in queries:
            fl = ci.probe_topk(q, n_probe)
            per_query_files.append(fl)
            pruned.extend(fl)
        if tail is not None:
            pruned.extend(e.file_path for e in tail.entries)
        pruned = sorted(set(pruned))
        stage_a.stop()
        stage_b = spans.timed("probe.stage_b").start()
        zonemap = self._read_zonemap(reader, puffin_path) if pred is not None else None
        masks, rg_pruned = self._filtered_masks(table, pruned, pred, zonemap)
        report = self._rerank_and_merge(table, masks, queries, k, ci.metric, stage_b)
        report.strategy = "centroid"
        report.files_scanned = len(pruned)
        report.plan = self._tail_only_plan(tail, k, queries.shape[0])
        report.stage_a_seconds = stage_a.seconds
        report.bytes_read = self.store.metrics.bytes_read
        report.filtered = pred is not None
        report.row_groups_pruned = rg_pruned
        return report

    def _probe_centroid_batch(
        self,
        table: LakehouseTable,
        reader: PuffinReader,
        queries: np.ndarray,
        k: int,
        n_probe: int,
        pred: Optional[Predicate] = None,
        puffin_path: Optional[str] = None,
        tail: Optional[FreshTail] = None,
    ) -> ProbeReport:
        """Batched coordinator-tier probe: ONE vectorized centroid-routing
        pass produces every query's file list; the union of those files is
        read and reranked once, with per-file ownership keeping each query's
        result set identical to its sequential probe.  ``pred`` (shared by
        the whole batch on this path) restricts masks to passing rows.
        Fresh-tail files are owned by every query of the batch."""
        stage_a = spans.timed("probe.stage_a").start()
        ci = CentroidIndex.from_blob(reader.read_first(CENTROID_BLOB_TYPE))
        per_query_files = ci.probe_topk_batch(queries, n_probe)
        file_owners: Dict[str, set] = {}
        for qi, fl in enumerate(per_query_files):
            for fp in fl:
                file_owners.setdefault(fp, set()).add(qi)
        if tail is not None:
            everyone = set(range(queries.shape[0]))
            for e in tail.entries:
                file_owners.setdefault(e.file_path, set()).update(everyone)
        pruned = sorted(file_owners)
        stage_a.stop()
        stage_b = spans.timed("probe.stage_b").start()
        zonemap = self._read_zonemap(reader, puffin_path) if pred is not None else None
        masks, rg_pruned = self._filtered_masks(table, pruned, pred, zonemap)
        report = self._rerank_and_merge(
            table, masks, queries, k, ci.metric, stage_b, file_owners=file_owners
        )
        report.strategy = "centroid"
        report.files_scanned = len(pruned)
        report.plan = self._tail_only_plan(tail, k, queries.shape[0])
        report.stage_a_seconds = stage_a.seconds
        report.bytes_read = self.store.metrics.bytes_read
        report.filtered = pred is not None
        report.row_groups_pruned = rg_pruned
        return report

    def _probe_diskann(
        self,
        table: LakehouseTable,
        routing: RoutingTable,
        shard_blobs,
        puffin_path: str,
        queries: np.ndarray,
        k: int,
        *,
        use_pq: Optional[bool] = None,
        L: Optional[int] = None,
        pred: Optional[Predicate] = None,
        zonemap: Optional[AttrZoneMap] = None,
        tail: Optional[FreshTail] = None,
        scan_dtype: str = "f32",
    ) -> ProbeReport:
        """Three-stage distributed probe (paper §6, Figure 3).  With a
        predicate, the zone map first prunes shards whose member row groups
        cannot match, then every surviving shard searches under its
        selectivity-adaptive plan.  A fresh tail adds one ExactScan fragment
        per unindexed row group to the same Stage-A wave; its exact hits
        merge with the graph candidates under the shared sentinel contract."""
        oversample = int(routing.params.get("oversample", "4"))
        if use_pq is None:
            use_pq = int(routing.params.get("pq_m", "0")) > 0
        L_eff = L or int(routing.params.get("L", "100"))
        ops: Dict[int, PlanOp] = {}
        pruned: List[int] = []
        est_frac = 1.0
        plan: Optional[ProbePlan] = None
        if pred is not None:
            ops, pruned, est_frac = planner.plan_filtered(
                pred, zonemap, routing, k=k, oversample=oversample,
                use_pq=use_pq, scan_dtype=scan_dtype,
            )
        tail_list = tail.row_group_list() if tail is not None else []
        tail_ops: Dict[int, PlanOp] = (
            planner.plan_tail(
                [cnt for _, _, cnt in tail_list],
                k=k,
                oversample=oversample,
                est_frac=est_frac,
            )
            if tail_list
            else {}
        )
        if pred is not None or tail_ops:
            plan_row = dict(ops)
            plan_row.update({sid: planner.Skip() for sid in pruned})
            plan_row.update(tail_ops)
            plan = ProbePlan(
                k=k,
                oversample=oversample,
                use_pq=use_pq,
                ops=[plan_row],
                est_selectivity=est_frac,
                pruned_shards=tuple(pruned),
            )
        # ---- Stage A: parallel shard beam search -------------------------
        stage_a = spans.timed("probe.stage_a").start()
        plan_span = spans.span("probe.plan").start()
        blob_by_index = {i: b for i, b in enumerate(PuffinReader(
            self.store.stat(puffin_path).size, self.store.range_reader(puffin_path)
        ).blobs)}
        tasks = []
        for s in routing.shards:
            if pred is not None and s.shard_id not in ops:
                continue  # zone-pruned
            b = blob_by_index[s.blob_index]
            tasks.append(
                F.ProbeTaskInfo(
                    task_id=f"probe-{s.shard_id}",
                    cache_key=f"{puffin_path}#shard{s.shard_id}",
                    shard_id=s.shard_id,
                    puffin_path=puffin_path,
                    blob_offset=b.offset,
                    blob_length=b.length,
                    blob_codec=b.compression_codec,
                    queries=queries,
                    k=k,
                    L=L_eff,
                    use_pq=use_pq,
                    oversample=oversample,
                    predicate=pred,
                    plan_op=ops.get(s.shard_id),
                )
            )
        Q = queries.shape[0]
        tail_tasks = self._tail_tasks(
            tail_list,
            tail_ops,
            queries,
            np.arange(Q, dtype=np.int64),
            k=k,
            oversample=oversample,
            metric=routing.metric,
            filters=[pred] * Q if pred is not None else None,
        )
        plan_span.stop()
        results = self.scheduler.run_wave(tasks + tail_tasks)
        probe_results: List[F.ProbeResult] = results[: len(tasks)]
        tail_results: List[F.BatchProbeResult] = results[len(tasks):]
        stage_a.stop()
        # ---- merge + Stage B: exact rerank on row-group masks ---------------
        stage_b = spans.timed("probe.stage_b").start()
        keep = k * oversample
        merged: List[List[F.ProbeCandidate]] = []
        for qi in range(Q):
            cands: List[F.ProbeCandidate] = []
            for r in probe_results:
                cands.extend(r.candidates[qi])
            for r in tail_results:
                cands.extend(r.candidates.get(qi, []))
            cands.sort(key=lambda c: c.approx_distance)
            merged.append(cands[:keep])
        masks: Dict[str, Dict[int, set]] = {}
        for qi in range(Q):
            for c in merged[qi]:
                masks.setdefault(c.file_path, {}).setdefault(c.row_group, set()).add(
                    c.row_offset
                )
        masks_l = {
            fp: {rg: sorted(rows) for rg, rows in groups.items()}
            for fp, groups in masks.items()
        }
        report = self._rerank_and_merge(table, masks_l, queries, k, routing.metric, stage_b)
        report.strategy = "diskann"
        report.served_by = [
            f"probe:{r.shard_id}@{r.executor_id}" for r in results
        ] + report.served_by
        report.files_scanned = len(masks_l)
        report.stage_a_seconds = stage_a.seconds
        report.shards_probed = len(tasks)
        report.cache_hits = sum(1 for r in probe_results if r.cache_hit)
        report.kernel_dispatches = sum(r.kernel_dispatches for r in results)
        report.masked_beam_rows = sum(r.masked_beam_rows for r in results)
        report.masked_beam_fallbacks = sum(r.masked_beam_fallbacks for r in results)
        report.bytes_read = self.store.metrics.bytes_read
        if pred is not None:
            report.filtered = True
            report.filter_plan = self._plan_summary(ops, pruned)
            report.shards_pruned = len(pruned)
            report.fragments_pruned = len(pruned)  # one fragment per shard here
            report.est_selectivity = est_frac
        report.plan = plan
        return report

    @staticmethod
    def _tail_tasks(
        tail_list: List[Tuple[str, int, int]],
        tail_ops: Dict[int, PlanOp],
        queries: np.ndarray,
        query_index: np.ndarray,
        *,
        k: int,
        oversample: int,
        metric: str,
        filters: Optional[List[Optional[Predicate]]],
    ) -> List[F.TailScanTaskInfo]:
        """One Stage-A fragment per fresh-tail row group, carrying the whole
        query block (tail fragments pass through coalescing unmerged)."""
        B = queries.shape[0]
        tasks: List[F.TailScanTaskInfo] = []
        for i, (fp, rg, _cnt) in enumerate(tail_list):
            tid = -(i + 1)
            tasks.append(
                F.TailScanTaskInfo(
                    task_id=f"tail-{i}",
                    cache_key=fp,
                    file_path=fp,
                    row_group=rg,
                    tail_id=tid,
                    queries=queries,
                    query_index=query_index,
                    k=k,
                    oversample=oversample,
                    metric=metric,
                    filters=list(filters) if filters is not None else None,
                    plan_ops=[tail_ops[tid]] * B,
                )
            )
        return tasks

    def _route_queries(
        self, routing: RoutingTable, queries: np.ndarray, n_route: Optional[int]
    ) -> List[List[int]]:
        """Vectorized shard routing for a batch: per query, the shards to
        probe.  Default (``n_route`` unset) routes every query to every
        shard — exact parity with the sequential probe.  With ``n_route``,
        one batched distance pass against the partition centroids keeps only
        the shards owning each query's nearest partitions."""
        shard_ids = [s.shard_id for s in routing.shards]
        B = queries.shape[0]
        cents = routing.partition_centroids
        if n_route is None or cents is None or routing.shard_of_partition is None:
            return [list(shard_ids) for _ in range(B)]
        # (B, P) distances in one pass, under the index's own metric
        if routing.metric == "ip":
            d = -(queries @ cents.T)
        else:
            d = (
                np.sum(queries * queries, axis=1)[:, None]
                - 2.0 * queries @ cents.T
                + np.sum(cents * cents, axis=1)[None, :]
            )
        keep = min(n_route, cents.shape[0])
        nearest = np.argsort(d, axis=1)[:, :keep]  # (B, keep) partition ids
        owner = np.asarray(routing.shard_of_partition)
        available = set(shard_ids)
        out: List[List[int]] = []
        for qi in range(B):
            shards = {int(owner[p]) for p in nearest[qi]} & available
            # a query must probe at least one shard even if its nearest
            # partitions all map to shards that produced no blob
            out.append(sorted(shards) if shards else list(shard_ids))
        return out

    def _probe_diskann_batch(
        self,
        table: LakehouseTable,
        routing: RoutingTable,
        reader: PuffinReader,
        puffin_path: str,
        queries: np.ndarray,
        k: int,
        *,
        use_pq: Optional[bool] = None,
        L: Optional[int] = None,
        n_route: Optional[int] = None,
        preds: Optional[List[Optional[Predicate]]] = None,
        zonemap: Optional[AttrZoneMap] = None,
        tail: Optional[FreshTail] = None,
        scan_dtype: str = "f32",
        oversample_override: Optional[int] = None,
        replay_plan: Optional[ProbePlan] = None,
        cache_ctx: Optional[Tuple[str, int]] = None,
    ) -> ProbeReport:
        """Batched three-stage distributed probe.

        Stage A: per-(query, shard) fragments are handed to the scheduler,
        which coalesces them into ≤ one fragment per shard; each executor
        answers its fragment with one batched beam-search pass.  Stage B:
        the union of every query's surviving candidates is reranked in one
        wave with per-row ownership.  Stage C: per-query ordered merge.

        ``preds`` carries per-query predicates (None entries = unfiltered
        query).  Filtered and unfiltered queries share coalesced fragments;
        the zone map drops a (query, shard) fragment before dispatch when no
        member row group of that shard can match the query's predicate.

        With ``replay_plan`` the per-(query, shard) ops come from the
        caller's plan verbatim (planning is skipped entirely); tail ops
        (negative synthetic ids) are ignored and re-planned fresh."""
        if replay_plan is not None:
            if replay_plan.k != k:
                raise ValueError(
                    f"replay plan was built for k={replay_plan.k}, got k={k}"
                )
            if len(replay_plan.ops) != queries.shape[0]:
                raise ValueError(
                    f"replay plan covers {len(replay_plan.ops)} queries, "
                    f"got {queries.shape[0]}"
                )
            oversample = (
                replay_plan.oversample
                if oversample_override is None
                else oversample_override
            )
            use_pq = replay_plan.use_pq
        elif oversample_override is not None:
            oversample = max(1, int(oversample_override))
        else:
            oversample = int(routing.params.get("oversample", "4"))
        if use_pq is None:
            use_pq = int(routing.params.get("pq_m", "0")) > 0
        L_eff = L or int(routing.params.get("L", "100"))
        stage_a = spans.timed("probe.stage_a").start()
        plan_span = spans.span("probe.plan").start()
        # the already-open reader has the footer parsed — no re-read
        blob_by_index = dict(enumerate(reader.blobs))
        route = self._route_queries(routing, queries, n_route)
        B = queries.shape[0]
        # replay: the op grid is taken as-is (shard ops only — synthetic
        # negative tail ids are dropped; the tail is re-planned below)
        replay_ops: List[Dict[int, PlanOp]] = (
            [{sid: op for sid, op in row.items() if sid >= 0} for row in replay_plan.ops]
            if replay_plan is not None
            else []
        )
        # one plan per distinct predicate; shared across its queries
        plans: Dict[Predicate, Tuple[Dict[int, PlanOp], List[int], float]] = {}
        if preds and replay_plan is None:
            for p in preds:
                if p is not None and p not in plans:
                    plans[p] = planner.plan_filtered(
                        p, zonemap, routing,
                        k=k, oversample=oversample, use_pq=use_pq,
                        scan_dtype=scan_dtype,
                    )
        # pre-pass: which shards end up with MIXED fragments (filtered and
        # unfiltered queries coalesced together)?  An unfiltered query on a
        # mixed shard needs a planner op of its own — a shared beam, or a
        # size-capped all-ones exact row on small shards — instead of the
        # old uncapped O(N·D) all-ones scan.
        shard_filtered: Dict[int, bool] = {}
        shard_unfiltered: Dict[int, bool] = {}
        if replay_plan is None:
            for s in routing.shards:
                for qi in range(B):
                    if s.shard_id not in route[qi]:
                        continue
                    pred = preds[qi] if preds else None
                    if pred is None:
                        shard_unfiltered[s.shard_id] = True
                    elif s.shard_id in plans[pred][0]:
                        shard_filtered[s.shard_id] = True
        fragments_pruned = 0
        ops_grid: List[Dict[int, PlanOp]] = [dict() for _ in range(B)]
        tasks: List[F.BatchProbeTaskInfo] = []
        # cross-batch shard-probe cache (serving/cache.py): keys carry the
        # snapshot id, predicate, search params, plan op, and the exact
        # query bytes, so a hit replays the identical Stage-A fragment
        cache = self.probe_cache if cache_ctx is not None else None
        q_digests: List[bytes] = (
            [query_digest(queries[qi]) for qi in range(B)] if cache is not None else []
        )
        cached: Dict[Tuple[int, int], List[F.ProbeCandidate]] = {}
        cache_puts: List[Tuple[tuple, int, int]] = []  # (key, qi, shard_id)
        for s in routing.shards:
            b = blob_by_index[s.blob_index]
            mixed = shard_filtered.get(s.shard_id, False) and shard_unfiltered.get(
                s.shard_id, False
            )
            for qi in range(B):
                if s.shard_id not in route[qi]:
                    continue
                pred = preds[qi] if preds else None
                op: Optional[PlanOp] = None
                if replay_plan is not None:
                    op = replay_ops[qi].get(s.shard_id)
                    if isinstance(op, planner.Skip):
                        fragments_pruned += 1
                        ops_grid[qi][s.shard_id] = op
                        continue  # the replayed plan pruned this fragment
                elif pred is not None:
                    shard_ops, _pruned, _frac = plans[pred]
                    if s.shard_id not in shard_ops:
                        fragments_pruned += 1
                        ops_grid[qi][s.shard_id] = planner.Skip()
                        continue  # zone-pruned for this query's predicate
                    op = shard_ops[s.shard_id]
                elif plans:
                    op = planner.plan_unfiltered(
                        s.vector_count, mixed=mixed, k=k, oversample=oversample
                    )
                if op is not None:
                    ops_grid[qi][s.shard_id] = op
                if cache is not None:
                    ckey = (
                        cache_ctx[0],
                        cache_ctx[1],
                        s.shard_id,
                        pred,
                        (k, L_eff, use_pq, oversample),
                        op,
                        q_digests[qi],
                    )
                    ent = cache.get(ckey)
                    if ent is not None:
                        # Stage-A hit: skip mask evaluation and the kernel
                        # dispatch for this fragment; the cached candidates
                        # re-merge below in this shard's routing slot
                        cached[(qi, s.shard_id)] = ent.candidates
                        continue
                    cache_puts.append((ckey, qi, s.shard_id))
                tasks.append(
                    F.BatchProbeTaskInfo(
                        task_id=f"probe-{s.shard_id}-q{qi}",
                        cache_key=f"{puffin_path}#shard{s.shard_id}",
                        shard_id=s.shard_id,
                        puffin_path=puffin_path,
                        blob_offset=b.offset,
                        blob_length=b.length,
                        blob_codec=b.compression_codec,
                        queries=queries[qi : qi + 1],
                        query_index=np.array([qi], np.int64),
                        k=k,
                        L=L_eff,
                        use_pq=use_pq,
                        oversample=oversample,
                        filters=[pred] if pred is not None else None,
                        plan_ops=[op] if op is not None else None,
                    )
                )
        # fresh-tail fragments: every query scans every tail row group (tail
        # rows are outside the routing table, so n_route cannot skip them)
        tail_list = tail.row_group_list() if tail is not None else []
        tail_ops: Dict[int, PlanOp] = (
            planner.plan_tail(
                [cnt for _, _, cnt in tail_list], k=k, oversample=oversample
            )
            if tail_list
            else {}
        )
        for qi in range(B):
            ops_grid[qi].update(tail_ops)
        tail_tasks = self._tail_tasks(
            tail_list,
            tail_ops,
            queries,
            np.arange(B, dtype=np.int64),
            k=k,
            oversample=oversample,
            metric=routing.metric,
            filters=preds,
        )
        plan_span.stop()
        results: List[F.BatchProbeResult] = self.scheduler.run_coalesced_wave(
            tasks + tail_tasks
        )
        # coalescing preserves first-appearance order, so the tail fragments
        # (appended last, never merged) are the trailing results
        n_shard_results = len(results) - len(tail_tasks)
        probe_results = results[:n_shard_results]
        tail_results = results[n_shard_results:]
        by_shard = {r.shard_id: r for r in probe_results}
        if cache is not None:
            for ckey, qi, sid in cache_puts:
                r = by_shard.get(sid)
                if r is not None:
                    cache.put(
                        ckey,
                        r.candidates.get(qi, []),
                        table_name=cache_ctx[0],
                        snapshot_id=cache_ctx[1],
                        served_by=r.executor_id,
                    )
        stage_a.stop()
        # ---- merge + Stage B: exact rerank with per-row ownership ----------
        stage_b = spans.timed("probe.stage_b").start()
        keep = k * oversample
        merged: List[List[F.ProbeCandidate]] = []
        for qi in range(B):
            cands: List[F.ProbeCandidate] = []
            # routing order (== uncached result order): a cache hit drops
            # its candidates into exactly the slot the live fragment would
            # have filled, so the stable sort below ties-break identically
            # and the final hits are bit-identical to the uncached path
            for s in routing.shards:
                hit = cached.get((qi, s.shard_id))
                if hit is not None:
                    cands.extend(hit)
                else:
                    r = by_shard.get(s.shard_id)
                    if r is not None:
                        cands.extend(r.candidates.get(qi, []))
            for r in tail_results:  # tail fragments merge last, as dispatched
                cands.extend(r.candidates.get(qi, []))
            cands.sort(key=lambda c: c.approx_distance)
            merged.append(cands[:keep])
        masks: Dict[str, Dict[int, set]] = {}
        row_owners: Dict[str, Dict[int, Dict[int, set]]] = {}
        for qi in range(B):
            for c in merged[qi]:
                masks.setdefault(c.file_path, {}).setdefault(c.row_group, set()).add(
                    c.row_offset
                )
                row_owners.setdefault(c.file_path, {}).setdefault(
                    c.row_group, {}
                ).setdefault(c.row_offset, set()).add(qi)
        masks_l = {
            fp: {rg: sorted(rows) for rg, rows in groups.items()}
            for fp, groups in masks.items()
        }
        report = self._rerank_and_merge(
            table, masks_l, queries, k, routing.metric, stage_b, row_owners=row_owners
        )
        report.strategy = "diskann"
        report.served_by = [
            f"probe:{r.shard_id}@{r.executor_id}" for r in results
        ] + report.served_by
        report.files_scanned = len(masks_l)
        report.stage_a_seconds = stage_a.seconds
        report.shards_probed = len(probe_results)
        report.probe_fragments = len(probe_results)
        report.cache_hits = sum(1 for r in probe_results if r.cache_hit)
        report.shard_cache_hits = len(cached)
        if cached:
            report.cache = "shard"
        report.kernel_dispatches = sum(r.kernel_dispatches for r in results)
        report.masked_beam_rows = sum(r.masked_beam_rows for r in results)
        report.masked_beam_fallbacks = sum(r.masked_beam_fallbacks for r in results)
        report.bytes_read = self.store.metrics.bytes_read
        all_pruned: set = set()
        if plans:
            report.filtered = True
            all_pruned = {sid for _, pruned, _ in plans.values() for sid in pruned}
            report.shards_pruned = len(all_pruned)
            report.fragments_pruned = fragments_pruned
            report.filter_plan = ";".join(
                self._plan_summary(ops, pruned) for ops, pruned, _ in plans.values()
            )
            report.est_selectivity = float(
                np.mean([frac for _, _, frac in plans.values()])
            )
        elif replay_plan is not None:
            report.filtered = bool(preds)
            all_pruned = set(replay_plan.pruned_shards)
            report.shards_pruned = len(all_pruned)
            report.fragments_pruned = fragments_pruned
            report.filter_plan = "replay"
            report.est_selectivity = replay_plan.est_selectivity
        if plans or tail_tasks or replay_plan is not None:
            report.plan = ProbePlan(
                k=k,
                oversample=oversample,
                use_pq=use_pq,
                ops=ops_grid,
                est_selectivity=report.est_selectivity,
                pruned_shards=tuple(sorted(all_pruned)),
            )
        return report

    def _rerank_and_merge(
        self,
        table: LakehouseTable,
        masks: Dict[str, Dict[int, List[int]]],
        queries: np.ndarray,
        k: int,
        metric: str,
        stage_b: "spans.Span",
        file_owners: Optional[Dict[str, set]] = None,
        row_owners: Optional[Dict[str, Dict[int, Dict[int, set]]]] = None,
    ) -> ProbeReport:
        """Stage B (parallel rerank) + Stage C (ordered merge).

        ``stage_b`` is the caller's started Stage-B timer (``probe.stage_b``:
        its candidate merge, then this rerank wave, which ends at each
        executor's ``.cpu()``); it stops when the wave is back, and Stage C
        (``probe.stage_c``, host only) is timed from there.  The report's
        ``stage_b_seconds`` / ``stage_c_seconds`` are the two spans'.

        ``file_owners`` / ``row_owners`` carry batched-probe ownership: each
        query's Stage-C merge sees only the rows it routed to, even though
        the union of the batch's rows is read and scored once."""
        live = self.pool.live()
        n_exec = max(1, len(live))
        file_list = sorted(masks.keys())
        groups = [file_list[i::n_exec] for i in range(n_exec)]
        tasks = []
        for gi, group in enumerate(groups):
            if not group:
                continue
            tasks.append(
                F.RerankTaskInfo(
                    task_id=f"rerank-{gi}",
                    cache_key=group[0],
                    masks={fp: masks[fp] for fp in group},
                    queries=queries,
                    metric=metric,
                    keep=k,
                    file_owners=(
                        {fp: file_owners[fp] for fp in group if fp in file_owners}
                        if file_owners
                        else None
                    ),
                    row_owners=(
                        {fp: row_owners[fp] for fp in group if fp in row_owners}
                        if row_owners
                        else None
                    ),
                )
            )
        try:
            results: List[F.RerankResult] = self.scheduler.run_wave(tasks) if tasks else []
        finally:
            stage_b.stop()
        # Stage C: streaming loser-tree merge (here: heap merge per query)
        with spans.timed("probe.stage_c") as stage_c:
            Q = queries.shape[0]
            hits: List[List[ProbeHit]] = []
            for qi in range(Q):
                rows = []
                for r in results:
                    rows.extend(r.rows[qi])
                best = heapq.nsmallest(k, rows, key=lambda x: x.distance)
                hits.append(
                    [ProbeHit(b.file_path, b.row_group, b.row_offset, b.distance) for b in best]
                )
        return ProbeReport(
            hits=hits,
            strategy="",
            files_scanned=0,
            bytes_read=0,
            stage_b_seconds=stage_b.seconds,
            stage_c_seconds=stage_c.seconds,
            served_by=[f"rerank@{r.executor_id}" for r in results],
        )

    # ------------------------------------------------------------------ refresh
    def refresh_index(self, table_name: str, index_name: str) -> RefreshReport:
        """REFRESH INDEX (paper §7): manifest diff → greedy insert + lazy
        tombstones → selective shard rebuild → metadata-only commit."""
        t_start = time.time()
        meta, snap, puffin_path, reader = self._resolve_index(table_name)
        routing = decode_routing_blob(reader.read_first(ROUTING_BLOB_TYPE))
        base_id = routing.base_snapshot_id
        # The index must be refreshed against the *current* data snapshot.
        diff = diff_snapshots(self.store, meta, base_id, snap.snapshot_id)
        if diff.is_empty:
            return RefreshReport(
                puffin_path=puffin_path,
                snapshot_id=snap.snapshot_id,
                base_snapshot_id=base_id,
                inserted=0,
                tombstoned=0,
                shards_refreshed=0,
                shards_rebuilt=0,
                shards_reused=len(routing.shards),
                seconds=time.time() - t_start,
                noop=True,
            )
        added = [f.path for f in diff.added]
        removed = [f.path for f in diff.deleted]
        blob_metas = reader.blobs
        token = uuid.uuid4().hex[:8]
        out_prefix = (
            f"{meta.location}/metadata/ann-{index_name}-snap-{snap.snapshot_id}-{token}"
        )
        tasks = []
        for s in routing.shards:
            b = blob_metas[s.blob_index]
            tasks.append(
                F.RefreshTaskInfo(
                    task_id=f"refresh-{s.shard_id}",
                    cache_key=f"{puffin_path}#shard{s.shard_id}",
                    shard_id=s.shard_id,
                    puffin_path=puffin_path,
                    blob_offset=b.offset,
                    blob_length=b.length,
                    blob_codec=b.compression_codec,
                    added_files=added,
                    removed_files=removed,
                    partition_centroids=routing.partition_centroids,
                    shard_of_partition=routing.shard_of_partition,
                    output_path=f"{out_prefix}-shard-{s.shard_id}.blob",
                    include_vectors=routing.params.get("include_vectors", "True")
                    == "True",
                )
            )
        results: List[F.RefreshResult] = self.scheduler.run_wave(tasks)
        # rebuild any shard past the tombstone threshold (paper §7.3: only
        # that shard, at the next maintenance window — we do it inline)
        rebuilt = 0
        final: List[F.IndexBuildResult] = []
        ratios: Dict[int, float] = {}
        cfg = IndexConfig(
            name=index_name,
            R=int(routing.params["R"]),
            L=int(routing.params["L"]),
            alpha=float(routing.params["alpha"]),
            metric=routing.metric,
            pq_m=int(routing.params.get("pq_m", "0")),
            pq_nbits=int(routing.params.get("pq_nbits", "8")),
            include_vectors=routing.params.get("include_vectors", "True") == "True",
            partition_mode=routing.params.get("partition_mode", "centroid"),
        )
        for r in results:
            if r.tombstone_ratio > TOMBSTONE_REBUILD_THRESHOLD:
                rb = self._rebuild_shard(r, cfg, routing, out_prefix)
                final.append(rb)
                ratios[rb.shard_id] = 0.0
                rebuilt += 1
            else:
                final.append(
                    F.IndexBuildResult(
                        shard_id=r.shard_id,
                        output_path=r.output_path,
                        vector_count=r.vector_count,
                        byte_size=r.byte_size,
                        executor_id=r.executor_id,
                        build_seconds=r.refresh_seconds,
                        rg_membership=r.rg_membership,
                    )
                )
                ratios[r.shard_id] = r.tombstone_ratio
        table = LakehouseTable(self.catalog, table_name)
        centroid_index = build_centroid_index(table, metric=routing.metric)
        covered = [f.path for f in table.current_files()]
        # the zone map is rebuilt against the refresh target snapshot, with
        # shard membership from the refreshed (live-row) location maps —
        # data files are immutable, so zones carry over from the previous
        # index and only files the old map never saw are scanned (refresh
        # attribute I/O scales with the append delta, not the table)
        zonemap = self._refresh_zonemap(reader, puffin_path, covered)
        if zonemap is not None:
            zonemap.shard_membership = {
                r.shard_id: r.rg_membership for r in final if r.rg_membership
            }
        # snapshot to bind against is the CURRENT one (the diff target)
        puffin_new, total_bytes = self._assemble_puffin(
            meta,
            snap,
            cfg,
            routing.partition_centroids,
            routing.shard_of_partition,
            final,
            centroid_index,
            covered,
            out_prefix,
            tombstone_ratios=ratios,
            zonemap=zonemap,
        )
        new_meta = self.catalog.set_statistics_file(
            table_name,
            puffin_new,
            expected_base_snapshot_id=snap.snapshot_id,
            extra_summary={
                "ann.index-name": index_name,
                "ann.base-snapshot-id": str(snap.snapshot_id),
                "ann.num-shards": str(len(final)),
                "ann.refreshed-from": str(base_id),
            },
        )
        self._invalidate_caches(table_name, new_meta.current_snapshot_id)
        return RefreshReport(
            puffin_path=puffin_new,
            snapshot_id=new_meta.current_snapshot_id,
            base_snapshot_id=snap.snapshot_id,
            inserted=sum(r.inserted for r in results),
            tombstoned=sum(r.tombstoned for r in results),
            shards_refreshed=len(results),
            shards_rebuilt=rebuilt,
            shards_reused=0,
            seconds=time.time() - t_start,
        )

    def compact_tail(
        self,
        table_name: str,
        index_name: str,
        *,
        threshold_rows: int = TAIL_COMPACT_THRESHOLD_ROWS,
        force: bool = False,
    ) -> Optional[RefreshReport]:
        """Fold the fresh tail into the Vamana shards once it crosses the
        size threshold (the background compaction policy).  Delegates to
        :meth:`refresh_index` — the manifest diff already covers the tail's
        files, and the refresh commit binds a new ``statistics-file``
        snapshot summary, which implicitly resets the tail (time travel to
        the pre-compaction snapshot still sees — and serves — its tail;
        orphaned tail Puffins are reaped by the ordinary GC).  Returns None
        when there is no tail or it is still below ``threshold_rows``."""
        meta = self.catalog.load_table(table_name)
        snap = meta.current_snapshot()
        if snap is None:
            return None
        tail = self._resolve_tail(snap)
        if tail is None:
            return None
        if not force and tail.total_rows < threshold_rows:
            return None
        return self.refresh_index(table_name, index_name)

    def _rebuild_shard(
        self,
        refresh_result: F.RefreshResult,
        cfg: IndexConfig,
        routing: RoutingTable,
        out_prefix: str,
    ) -> F.IndexBuildResult:
        """Full rebuild of a single over-tombstoned shard from live vectors."""
        from repro_torch.core.blobs import decode_shard_blob

        raw = self.store.get(refresh_result.output_path)
        graph, locmap = decode_shard_blob(raw, device=self.device)
        live_ids = np.flatnonzero(~graph.tombstones[: graph.n])
        vectors = graph.vectors[live_ids]
        pq_codebook = graph.pq.codebook if graph.pq is not None else None
        task = F.IndexBuildTaskInfo(
            task_id=f"rebuild-{refresh_result.shard_id}",
            shard_id=refresh_result.shard_id,
            partition_centroids=routing.partition_centroids,
            shard_of_partition=routing.shard_of_partition,
            R=cfg.R,
            L=cfg.L,
            alpha=cfg.alpha,
            metric=cfg.metric,
            pq_m=cfg.pq_m,
            pq_nbits=cfg.pq_nbits,
            pq_codebook=pq_codebook,
            include_vectors=cfg.include_vectors,
            output_path=f"{out_prefix}-shard-{refresh_result.shard_id}-rebuilt.blob",
            exchanged=(
                vectors,
                locmap.file_idx[live_ids],
                locmap.row_group[live_ids],
                locmap.row_offset[live_ids],
                list(locmap.file_paths),
            ),
        )
        [result] = self.scheduler.run_wave([task])
        return result
