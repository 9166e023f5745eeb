"""PlanFragment / TaskInfo structs (paper §3.1, §5, §6).

``IndexBuildTaskInfo`` rides alongside the engine's ordinary WriteTaskInfo —
here they are the task vocabulary the scheduler dispatches.  Payloads carry
numpy arrays directly (the in-process stand-in for Arrow IPC)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


@dataclass
class TaskBase:
    task_id: str
    attempt: int = 0
    # scheduler placement hint: executors caching this key are preferred
    cache_key: Optional[str] = None


# -- build (paper §5) ---------------------------------------------------------


@dataclass
class IndexBuildTaskInfo(TaskBase):
    shard_id: int = 0
    assigned_files: List[str] = field(default_factory=list)
    # Stage-0 broadcast: partition centroids + which shard owns each partition
    partition_centroids: Optional[np.ndarray] = None  # (P, D)
    shard_of_partition: Optional[np.ndarray] = None  # (P,)
    # algorithm parameters
    R: int = 64
    L: int = 100
    alpha: float = 1.2
    metric: str = "l2"
    pq_m: int = 0  # 0 => no PQ
    pq_nbits: int = 8
    pq_codebook: Optional[np.ndarray] = None  # (m, K, dsub) broadcast from Stage 0
    include_vectors: bool = True
    # destination object for the serialized shard blob
    output_path: str = ""
    partition_mode: str = "centroid"  # centroid | file
    build_passes: int = 2
    build_batch: int = 128
    # pre-exchanged payload (centroid-mode all-to-all):
    # (vectors, file_idx, row_group, row_offset, file_paths)
    exchanged: Optional[tuple] = None


@dataclass
class IndexBuildResult:
    shard_id: int
    output_path: str
    vector_count: int
    byte_size: int
    executor_id: str
    build_seconds: float
    # per-partition vector counts (routing-table population, paper §5 Stage 1)
    partition_counts: Optional[np.ndarray] = None
    # (file_path, row_group) pairs this shard's vectors came from — the
    # zone-map membership that lets the coordinator prune whole shards on
    # attribute predicates
    rg_membership: Optional[List[Tuple[str, int]]] = None


@dataclass
class ScanPartitionTaskInfo(TaskBase):
    """Pre-build exchange: scan assigned files, group vectors by owner shard."""

    assigned_files: List[str] = field(default_factory=list)
    partition_centroids: Optional[np.ndarray] = None
    shard_of_partition: Optional[np.ndarray] = None
    num_shards: int = 0


@dataclass
class ScanPartitionResult:
    executor_id: str
    # per-shard: (vectors, file_idx, row_group, row_offset, file_paths)
    per_shard: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, List[str]]] = field(
        default_factory=dict
    )


# -- probe (paper §6) ------------------------------------------------------------


@dataclass
class ProbeTaskInfo(TaskBase):
    shard_id: int = 0
    puffin_path: str = ""
    blob_offset: int = 0
    blob_length: int = 0
    blob_codec: Optional[str] = None
    queries: Optional[np.ndarray] = None  # (Q, D)
    k: int = 10
    L: int = 100
    use_pq: bool = True
    oversample: int = 4
    # filtered search: predicate tree applied to every query of this task,
    # with the planner's per-shard plan op (runtime/planner.py IR; None
    # falls back to planner.default_filtered_op — the mid-band mask plan)
    predicate: Optional[object] = None
    plan_op: Optional[object] = None


@dataclass
class ProbeCandidate:
    file_path: str
    row_group: int
    row_offset: int
    approx_distance: float
    vec_id: int
    shard_id: int


@dataclass
class ProbeResult:
    shard_id: int
    executor_id: str
    # per query: list of candidates
    candidates: List[List[ProbeCandidate]] = field(default_factory=list)
    cache_hit: bool = False
    # masked top-k kernel calls this task issued (observability for the
    # heterogeneous-filter coalescing win; 0 on pure beam paths)
    kernel_dispatches: int = 0
    # MaskedBeam accounting: rows answered by the predicate-aware
    # traversal, and how many of those under-delivered and were
    # re-answered by the fused exact-masked fallback
    masked_beam_rows: int = 0
    masked_beam_fallbacks: int = 0


@dataclass
class BatchProbeTaskInfo(TaskBase):
    """Coalesced shard probe (batched pipeline): ONE fragment per shard
    carrying every batch query routed to it, instead of one fragment per
    (query, shard).  ``query_index`` maps each row of ``queries`` back to its
    position in the coordinator's batch so results merge per query."""

    shard_id: int = 0
    puffin_path: str = ""
    blob_offset: int = 0
    blob_length: int = 0
    blob_codec: Optional[str] = None
    queries: Optional[np.ndarray] = None  # (B_sub, D)
    query_index: Optional[np.ndarray] = None  # (B_sub,) positions in the batch
    k: int = 10
    L: int = 100
    use_pq: bool = True
    oversample: int = 4
    # per-query predicates, row-aligned with ``queries`` (None entry = that
    # query is unfiltered).  ``filters`` being None means the whole fragment
    # is unfiltered.  Per-query masks survive fragment coalescing: merged
    # fragments concatenate these lists alongside the query block.  The
    # executor answers every kernel-planned query of the merged fragment
    # with ONE masked-kernel call per shard — a (Q, N) mask plane (dedup'd
    # to unique predicate rows), fusing exact and PQ-ADC flavors into the
    # same dispatch when the batch mixes them — so the coalesce key
    # deliberately ignores predicates: fragments are NEVER split per
    # predicate group, however heterogeneous the batch.
    filters: Optional[List[Optional[object]]] = None
    # row-aligned planner ops (runtime/planner.py PlanOp; None entry =
    # planner default for that row: Beam for unfiltered rows,
    # default_filtered_op for filtered ones)
    plan_ops: Optional[List[Optional[object]]] = None

    def coalesce_key(self) -> tuple:
        """Fragments with equal keys search the same shard blob with the
        same parameters and may be merged into one dispatch."""
        return (
            self.puffin_path,
            self.shard_id,
            self.blob_offset,
            self.k,
            self.L,
            self.use_pq,
            self.oversample,
        )


@dataclass
class TailScanTaskInfo(TaskBase):
    """Fresh-tail tier (appended-but-unindexed rows): ONE fragment per tail
    row group carrying every query routed to it.  Tail rows have no graph
    and no PQ codes, so the executor scores them with the masked exact
    kernel — same (+inf, -1) sentinel contract as shard probes — and
    returns a :class:`BatchProbeResult` keyed by ``tail_id`` (negative, so
    tail candidates never collide with shard ids in the merge)."""

    file_path: str = ""
    row_group: int = 0
    tail_id: int = -1  # synthetic plan-grid id (-1, -2, ... in tail order)
    queries: Optional[np.ndarray] = None  # (B_sub, D)
    query_index: Optional[np.ndarray] = None  # (B_sub,) positions in the batch
    k: int = 10
    oversample: int = 4
    metric: str = "l2"
    # row-aligned per-query predicates / planner ops (same semantics as
    # BatchProbeTaskInfo); None list entry = unfiltered / planner default
    filters: Optional[List[Optional[object]]] = None
    plan_ops: Optional[List[Optional[object]]] = None


@dataclass
class BatchProbeResult:
    shard_id: int
    executor_id: str
    # original batch position -> candidates for that query
    candidates: Dict[int, List[ProbeCandidate]] = field(default_factory=dict)
    cache_hit: bool = False
    # masked top-k kernel calls this fragment cost: 1 per scoring flavor on
    # the mask-plane path, vs one per distinct predicate on the legacy
    # group loop — the coordinator sums these into
    # ``ProbeReport.kernel_dispatches`` and the bench gates on the drop
    kernel_dispatches: int = 0
    # MaskedBeam accounting (summed into the matching ProbeReport fields):
    # rows answered by the predicate-aware traversal, and how many of
    # those under-delivered into the fused exact-masked fallback
    masked_beam_rows: int = 0
    masked_beam_fallbacks: int = 0


def coalesce_batch_probes(tasks: Sequence[object]) -> List[object]:
    """Merge :class:`BatchProbeTaskInfo` fragments sharing a coalesce key
    into one fragment whose query block is the concatenation of the group's
    queries.  Non-batchable tasks pass through unchanged; output order is the
    order of first appearance (so shard-ordered input stays shard-ordered)."""
    groups: Dict[tuple, List[BatchProbeTaskInfo]] = {}
    order: List[tuple] = []  # ("task", obj) | ("group", key)
    for t in tasks:
        if isinstance(t, BatchProbeTaskInfo):
            key = t.coalesce_key()
            if key not in groups:
                groups[key] = []
                order.append(("group", key))
            groups[key].append(t)
        else:
            order.append(("task", t))
    out: List[object] = []
    for kind, item in order:
        if kind == "task":
            out.append(item)
            continue
        group = groups[item]
        if len(group) == 1:
            out.append(group[0])
            continue
        first = group[0]
        # per-query filters and plan ops ride along with their query rows; a
        # group with any filtered/planned member materializes aligned lists
        filters = None
        plan_ops = None
        if any(g.filters for g in group):
            filters = []
            for g in group:
                nq = g.queries.shape[0]
                filters.extend(g.filters if g.filters else [None] * nq)
        if any(g.plan_ops for g in group):
            plan_ops = []
            for g in group:
                nq = g.queries.shape[0]
                plan_ops.extend(g.plan_ops if g.plan_ops else [None] * nq)
        out.append(
            replace(
                first,
                task_id=f"{first.task_id}x{len(group)}",
                queries=np.concatenate([g.queries for g in group]),
                query_index=np.concatenate(
                    [np.asarray(g.query_index, np.int64) for g in group]
                ),
                filters=filters,
                plan_ops=plan_ops,
            )
        )
    return out


@dataclass
class RerankTaskInfo(TaskBase):
    # file -> row_group -> row offsets
    masks: Dict[str, Dict[int, List[int]]] = field(default_factory=dict)
    queries: Optional[np.ndarray] = None
    metric: str = "l2"
    # Batched-probe ownership: which batch queries may receive each row.
    # ``file_owners[fp]`` grants every row of ``fp`` to a query subset
    # (centroid routing); ``row_owners[fp][rg][off]`` grants a single row
    # (per-query DiskANN candidates).  Both None => every query owns every
    # row (single-query probes and full scans — the pre-batching semantics).
    file_owners: Optional[Dict[str, Set[int]]] = None
    row_owners: Optional[Dict[str, Dict[int, Dict[int, Set[int]]]]] = None
    # Stage C keeps each query's k nearest rows, so the executor returns
    # only its ``keep`` (= k) nearest owned rows per query, in ascending
    # distance (ties in row order).  The merged top-k is the same: a dropped
    # row has ``keep`` rows of the same result ahead of it.
    keep: int = field(kw_only=True)


@dataclass
class RerankRow:
    file_path: str
    row_group: int
    row_offset: int
    distance: float


@dataclass
class RerankResult:
    executor_id: str
    # per query: list of reranked rows
    rows: List[List[RerankRow]] = field(default_factory=list)


# -- refresh (paper §7) -------------------------------------------------------------


@dataclass
class RefreshTaskInfo(TaskBase):
    shard_id: int = 0
    puffin_path: str = ""
    blob_offset: int = 0
    blob_length: int = 0
    blob_codec: Optional[str] = None
    added_files: List[str] = field(default_factory=list)
    removed_files: List[str] = field(default_factory=list)
    partition_centroids: Optional[np.ndarray] = None
    shard_of_partition: Optional[np.ndarray] = None
    output_path: str = ""
    include_vectors: bool = True


@dataclass
class RefreshResult:
    shard_id: int
    output_path: str
    executor_id: str
    inserted: int
    tombstoned: int
    vector_count: int
    byte_size: int
    tombstone_ratio: float
    refresh_seconds: float = 0.0
    # refreshed (file, row_group) membership over LIVE rows, for the
    # rebuilt zone map's shard-pruning table
    rg_membership: Optional[List[Tuple[str, int]]] = None
