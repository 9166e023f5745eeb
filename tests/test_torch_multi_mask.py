"""The reference's ``tests/test_multi_mask.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU.

Per-query mask planes: heterogeneous-filter batches in ONE kernel call.

The acceptance contract: a coalesced fragment whose queries all land on
kernel-backed plans (prefilter / mask / unfiltered-in-a-mixed-fragment)
issues exactly ONE masked-kernel dispatch per shard regardless of how many
distinct predicates the batch carries — counted via
``Executor.masked_kernel_dispatches`` / ``ProbeReport.kernel_dispatches``
— with per-query results identical to the legacy per-predicate-group loop
(``Executor.force_group_loop=True`` re-enables it for comparison).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from repro_torch.runtime import fragments as F  # noqa: E402
from repro_torch.runtime import planner  # noqa: E402
from _torch_cpu import make_local_cluster  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig  # noqa: E402
from repro_torch.serving.serve_loop import ProbeMicroBatcher  # noqa: E402

DIM = 16


def _locs(hits):
    return [(h.file_path, h.row_group, h.row_offset) for h in hits]


def _locs_d(hits):
    return [(h.file_path, h.row_group, h.row_offset, h.distance) for h in hits]


def _reset_dispatch_counters(c):
    for ex in c.executors:
        ex.masked_kernel_dispatches = 0


def _set_group_loop(c, flag: bool):
    for ex in c.executors:
        ex.force_group_loop = flag


def _queries(X, n, seed):
    rng = np.random.default_rng(seed)
    return X[rng.choice(len(X), n)] + 0.05 * rng.normal(size=(n, DIM)).astype(
        np.float32
    )


@pytest.fixture(scope="module")
def plane_cluster(tmp_path_factory):
    """Full-precision (no PQ) index: every kernel-backed plan takes the
    exact flavor, so an all-kernel fragment is exactly one dispatch."""
    rng = np.random.default_rng(0)
    c = make_local_cluster(str(tmp_path_factory.mktemp("plane")), num_executors=2)
    t = LakehouseTable(c.catalog, "emb")
    t.create(dim=DIM)
    centers = rng.normal(size=(8, DIM))
    X = np.concatenate(
        [ctr + rng.normal(size=(150, DIM)) for ctr in centers]
    ).astype(np.float32)
    price = rng.integers(0, 100, size=len(X)).astype(np.int64)
    t.append_vectors(
        X, num_files=4, rows_per_group=100, attributes={"price": price}
    )
    rep = c.coordinator.create_index(
        "emb",
        IndexConfig(name="idx", R=16, L=48, partitions_per_shard=2, build_passes=1),
    )
    return c, t, X, price, rep


@pytest.fixture(scope="module")
def pq_plane_cluster(tmp_path_factory):
    """PQ index with shards big enough that mid-selectivity mask plans take
    the ADC flavor (match_count > max(4·k_eff, 64))."""
    rng = np.random.default_rng(1)
    c = make_local_cluster(str(tmp_path_factory.mktemp("pqplane")), num_executors=2)
    t = LakehouseTable(c.catalog, "emb")
    t.create(dim=DIM)
    centers = rng.normal(size=(6, DIM))
    X = np.concatenate(
        [ctr + rng.normal(size=(220, DIM)) for ctr in centers]
    ).astype(np.float32)
    price = rng.integers(0, 100, size=len(X)).astype(np.int64)
    t.append_vectors(
        X, num_files=4, rows_per_group=110, attributes={"price": price}
    )
    rep = c.coordinator.create_index(
        "emb",
        IndexConfig(
            name="idx", R=16, L=48, pq_m=8, pq_nbits=8,
            partitions_per_shard=2, build_passes=1,
        ),
    )
    return c, t, X, price, rep


HETERO_FILTERS = [f"price < {5 + 9 * i}" for i in range(8)]  # est 0.05 .. 0.68


def test_hetero_batch_is_one_dispatch_per_shard(plane_cluster):
    """8 distinct predicates in one batch: the mask-plane path answers each
    coalesced fragment with exactly ONE kernel call, where the per-group
    loop pays one call per distinct predicate — and the hits (including
    distances) are identical between the two paths and exact vs the
    brute-force oracle."""
    c, t, X, price, rep = plane_cluster
    Q = _queries(X, 8, seed=3)
    assert len(set(HETERO_FILTERS)) == 8
    # warm: masks computed and cached on first touch (both paths share them)
    c.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=HETERO_FILTERS)

    _reset_dispatch_counters(c)
    br = c.coordinator.probe_batch(
        "emb", Q, 10, strategy="diskann", filter=HETERO_FILTERS
    )
    assert br.probe_fragments >= 1
    assert br.kernel_dispatches == br.probe_fragments  # ONE call per shard
    assert sum(ex.masked_kernel_dispatches for ex in c.executors) == br.kernel_dispatches

    _set_group_loop(c, True)
    try:
        _reset_dispatch_counters(c)
        bg = c.coordinator.probe_batch(
            "emb", Q, 10, strategy="diskann", filter=HETERO_FILTERS
        )
    finally:
        _set_group_loop(c, False)
    # legacy path: one kernel call per distinct predicate per shard
    assert bg.kernel_dispatches == len(HETERO_FILTERS) * bg.probe_fragments
    assert bg.kernel_dispatches > br.kernel_dispatches
    for a, b in zip(br.hits, bg.hits):
        assert _locs_d(a) == _locs_d(b)  # byte-identical to the group loop
    # every plan is an exact kernel scan, so hits match the oracle exactly
    oracle = c.coordinator.probe_batch(
        "emb", Q, 10, strategy="scan", filter=HETERO_FILTERS
    )
    for a, b in zip(oracle.hits, br.hits):
        assert _locs(a) == _locs(b)


def test_hetero_pq_batch_is_one_dispatch_per_shard(pq_plane_cluster):
    """On a PQ index, mid-selectivity mask plans all take the ADC flavor:
    still one multi-mask kernel call per shard, and byte-identical to the
    per-group path (per-query pool truncation keeps the rerank pools the
    same)."""
    c, t, X, price, rep = pq_plane_cluster
    Q = _queries(X, 8, seed=5)
    filters = [f"price < {30 + 5 * i}" for i in range(8)]  # est 0.30 .. 0.65
    c.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=filters)

    _reset_dispatch_counters(c)
    br = c.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=filters)
    assert br.kernel_dispatches == br.probe_fragments
    assert "mask" in br.filter_plan

    _set_group_loop(c, True)
    try:
        bg = c.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=filters)
    finally:
        _set_group_loop(c, False)
    assert bg.kernel_dispatches == len(set(filters)) * bg.probe_fragments
    for a, b in zip(br.hits, bg.hits):
        assert _locs_d(a) == _locs_d(b)


def test_mixed_kernel_and_postfilter_batch_matches_sequential(plane_cluster):
    """A batch mixing unfiltered, mask-planned, and postfilter-planned
    queries: kernel rows ride the plane, the beam group loop survives only
    for the postfilter queries — and every query returns exactly what its
    sequential probe returns."""
    c, t, X, price, rep = plane_cluster
    Q = _queries(X, 5, seed=7)
    filters = [None, "price < 30", "price < 95", "price < 48", None]
    br = c.coordinator.probe_batch(
        "emb", Q, 5, strategy="diskann", filter=filters, L=256
    )
    assert "postfilter" in br.filter_plan
    seq = [
        c.coordinator.probe(
            "emb", Q[i], 5, strategy="diskann", filter=filters[i], L=256
        ).hits[0]
        for i in range(len(Q))
    ]
    for a, b in zip(seq, br.hits):
        assert _locs(a) == _locs(b)


def test_single_probe_report_counts_dispatches(plane_cluster):
    c, t, X, price, rep = plane_cluster
    got = c.coordinator.probe("emb", X[0], 5, strategy="diskann", filter="price < 30")
    assert got.kernel_dispatches >= 1
    unf = c.coordinator.probe("emb", X[0], 5, strategy="diskann")
    assert unf.kernel_dispatches == 0  # pure beam path


def test_coalesced_fragment_keeps_hetero_filters_together(plane_cluster):
    """Fragment layer: the coalesce key ignores predicates, so per-(query,
    shard) fragments with 8 distinct predicates still merge to ≤ one
    fragment per shard and the merged fragment carries the aligned filter
    list."""
    c, t, X, price, rep = plane_cluster
    Q = _queries(X, 8, seed=9)
    tasks = [
        F.BatchProbeTaskInfo(
            task_id=f"t{qi}",
            shard_id=0,
            puffin_path="p",
            blob_offset=0,
            blob_length=1,
            queries=Q[qi : qi + 1],
            query_index=np.array([qi], np.int64),
            filters=[HETERO_FILTERS[qi]],
            plan_ops=[planner.default_filtered_op(10, 4, use_pq=False)],
        )
        for qi in range(8)
    ]
    merged = F.coalesce_batch_probes(tasks)
    assert len(merged) == 1
    assert merged[0].filters == HETERO_FILTERS
    assert merged[0].queries.shape == (8, DIM)
    assert len(merged[0].plan_ops) == 8  # row-aligned ops ride the merge


def test_micro_batcher_hetero_submissions_share_kernel_calls(plane_cluster):
    """Serving: concurrent submissions with distinct predicates no longer
    need filter-homogeneous batches — the drained batch costs one kernel
    call per shard, surfaced via stats.kernel_dispatches."""
    c, t, X, price, rep = plane_cluster
    # warm the masks so the measured batch is steady-state
    c.coordinator.probe_batch(
        "emb", X[:4], 5, strategy="diskann", filter=HETERO_FILTERS[:4]
    )
    with ProbeMicroBatcher(c.coordinator, "emb", max_batch=8, max_wait_s=0.1) as mb:
        futs = [
            mb.submit(X[i], k=5, filter=HETERO_FILTERS[i]) for i in range(4)
        ]
        got = [f.result() for f in futs]
    assert mb.stats.filtered_queries == 4
    assert 0 < mb.stats.kernel_dispatches <= mb.stats.batches * rep.num_shards
    for i, hits in enumerate(got):
        expect = c.coordinator.probe("emb", X[i], 5, filter=HETERO_FILTERS[i]).hits[0]
        assert _locs(expect) == _locs(hits)
