"""The reference's ``tests/test_freshness.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU.

The fresh-tail tier: appended rows are searchable WITHOUT a rebuild.

The stale-read window this closes: `append_vectors` → `probe` used to
silently drop every row committed after the index's base snapshot until
someone ran `refresh_index`.  Now the append commit records the new row
groups in a ``repro.fresh-tail-v1`` Puffin blob, the planner emits one
``ExactScan`` op per unindexed row group (synthetic negative ids), the
executors score them through the same masked kernels (predicates and
tombstones included), and the hits merge with the graph candidates — at
exact-oracle parity for the tail rows.

Lifecycle coverage: append → probe parity (filtered + unfiltered, single
+ batch), the plan artifact, the ``include_tail=False`` silent-drop
regression, k > live-rows sentinel hygiene, a fully-deleted tail,
compaction thresholds, time travel, and orphan-file GC of superseded
tail Puffins.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.iceberg.gc import expire_and_collect  # noqa: E402
from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from _torch_cpu import make_local_cluster  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig  # noqa: E402

DIM = 16
CFG = dict(R=12, L=24, partitions_per_shard=2, build_passes=1, build_batch=128)


def _build(tmp_path, rng, *, n=480, attrs=False, num_executors=2):
    """Table + index over ``n`` base rows; returns (cluster, table, X, rep)."""
    c = make_local_cluster(str(tmp_path), num_executors=num_executors)
    t = LakehouseTable(c.catalog, "docs")
    t.create(dim=DIM)
    X = rng.normal(size=(n, DIM)).astype(np.float32)
    kw = {}
    if attrs:
        kw["attributes"] = {"cat": rng.integers(0, 4, size=n).astype(np.int64)}
    t.append_vectors(X, num_files=4, rows_per_group=64, **kw)
    rep = c.coordinator.create_index("docs", IndexConfig(name="idx", **CFG))
    return c, t, X, rep


def _append_tail(t, rng, n_tail, *, attrs=False, rows_per_group=64, loc=3.0):
    Y = rng.normal(loc=loc, size=(n_tail, DIM)).astype(np.float32)
    kw = {}
    if attrs:
        kw["attributes"] = {"cat": rng.integers(0, 4, size=n_tail).astype(np.int64)}
    t.append_vectors(Y, num_files=1, rows_per_group=rows_per_group,
                     file_prefix="tail", **kw)
    return Y


def _locs(hits):
    return {(h.file_path, h.row_group, h.row_offset) for h in hits}


def _recall(report, oracle):
    scores = [
        len(_locs(h) & _locs(o)) / max(len(_locs(o)), 1)
        for h, o in zip(report.hits, oracle.hits)
    ]
    return float(np.mean(scores))


def test_append_then_probe_serves_tail_without_refresh(tmp_path):
    """The tentpole: probe immediately after append (NO refresh) returns
    the appended rows at exact-oracle parity, the report carries the
    freshness accounting, and the plan has exactly one op per tail row
    group.  ``include_tail=False`` reproduces the pre-fix silent drop."""
    rng = np.random.default_rng(7)
    c, t, X, rep = _build(tmp_path, rng)
    Y = _append_tail(t, rng, 150)  # 150 rows / 64 per group = 3 row groups

    # queries dead-center on tail rows: the oracle's top hits live there
    Q = Y[:6] + 0.01 * rng.normal(size=(6, DIM)).astype(np.float32)
    oracle = c.coordinator.probe("docs", Q, 5, strategy="scan")
    pr = c.coordinator.probe("docs", Q, 5, strategy="diskann")

    assert pr.stale is True          # index binding is carried-forward
    assert pr.tail_rows == 150       # ... but the tail tier served them
    assert pr.unindexed_rows == 0    # the invariant: nothing dropped
    assert _recall(pr, oracle) == 1.0
    # every oracle hit in a tail file is present — the tail path is exact
    for h_pr, h_or in zip(pr.hits, oracle.hits):
        tail_truth = {loc for loc in _locs(h_or) if "tail" in loc[0]}
        assert tail_truth and tail_truth <= _locs(h_pr)

    # the plan artifact: one ExactScan per tail row group, negative ids
    assert pr.plan is not None
    for row in pr.plan.ops:
        assert sorted(sid for sid in row if sid < 0) == [-3, -2, -1]

    # batch path agrees
    prb = c.coordinator.probe_batch("docs", Q, 5, strategy="diskann")
    assert prb.tail_rows == 150 and prb.unindexed_rows == 0
    assert _recall(prb, oracle) == 1.0
    for row in prb.plan.ops:
        assert len([sid for sid in row if sid < 0]) == 3

    # regression: the pre-fix behavior drops the tail AND now says so
    pr_off = c.coordinator.probe(
        "docs", Q, 5, strategy="diskann", include_tail=False
    )
    assert pr_off.unindexed_rows == 150 and pr_off.tail_rows == 0
    assert pr_off.stale is True
    assert not any("tail" in h.file_path for hits in pr_off.hits for h in hits)
    assert _recall(pr_off, oracle) < 0.5  # the silent stale-read window

    # time travel: the pre-append snapshot never sees tail rows
    pr_old = c.coordinator.probe("docs", Q, 5, snapshot_id=rep.snapshot_id)
    assert pr_old.tail_rows == 0 and pr_old.unindexed_rows == 0
    assert not any("tail" in h.file_path for hits in pr_old.hits for h in hits)


def test_filtered_probe_covers_tail(tmp_path):
    """Predicates push into the tail scans through the same masked-kernel
    path: filtered probes stay at oracle parity with a tail present, and
    a zero-match predicate over the tail is clean (sentinel hygiene)."""
    rng = np.random.default_rng(11)
    c, t, X, rep = _build(tmp_path, rng, attrs=True)
    Y = _append_tail(t, rng, 120, attrs=True)
    Q = Y[:5] + 0.01 * rng.normal(size=(5, DIM)).astype(np.float32)

    for where in ("cat = 1", "cat >= 2"):
        oracle = c.coordinator.probe("docs", Q, 5, strategy="scan", filter=where)
        pr = c.coordinator.probe("docs", Q, 5, strategy="diskann", filter=where)
        assert pr.unindexed_rows == 0 and pr.tail_rows == 120
        assert _recall(pr, oracle) == 1.0

    # heterogeneous per-query filters through the batch path
    filters = ["cat = 0", None, "cat = 3", "cat >= 1", None]
    oracle = c.coordinator.probe_batch("docs", Q, 5, strategy="scan", filter=filters)
    prb = c.coordinator.probe_batch("docs", Q, 5, strategy="diskann", filter=filters)
    assert prb.unindexed_rows == 0
    assert _recall(prb, oracle) == 1.0

    # zero matches anywhere: no sentinel garbage leaks into hits
    pr0 = c.coordinator.probe("docs", Q, 5, strategy="diskann", filter="cat < 0")
    assert all(len(h) == 0 for h in pr0.hits)


def test_k_exceeds_live_rows_and_fully_deleted_tail(tmp_path):
    """Edge cases: k larger than the live row count must not surface
    (+inf, -1) kernel sentinels, and a tail whose only file is deleted
    must vanish from both the plan and the hits."""
    rng = np.random.default_rng(13)
    c, t, X, rep = _build(tmp_path, rng, n=240)
    Y = _append_tail(t, rng, 60)

    pr = c.coordinator.probe("docs", Y[:2], 1000, strategy="diskann")
    for hits in pr.hits:
        assert 0 < len(hits) <= len(X) + len(Y)
        assert len(_locs(hits)) == len(hits)  # no duplicate slots
        assert all(np.isfinite(h.distance) and h.row_offset >= 0 for h in hits)
        # the tail is scanned exactly: all 60 tail rows are reachable
        assert sum("tail" in h.file_path for h in hits) == 60
    prb = c.coordinator.probe_batch("docs", Y[:2], 1000, strategy="diskann")
    for hits in prb.hits:
        assert all(np.isfinite(h.distance) and h.row_offset >= 0 for h in hits)
        assert sum("tail" in h.file_path for h in hits) == 60

    # delete the tail's only file: the tier must drop it entirely
    doomed = [f.path for f in t.current_files() if "tail" in f.path]
    assert doomed
    t.delete_files(doomed)
    pr2 = c.coordinator.probe("docs", Y[:2], 5, strategy="diskann")
    assert pr2.tail_rows == 0 and pr2.unindexed_rows == 0
    assert not any("tail" in h.file_path for hits in pr2.hits for h in hits)


def test_compact_tail_threshold_and_fold(tmp_path):
    """The background compaction policy: below the row threshold the tail
    is left alone (probes keep serving it); crossing it (or forcing)
    folds the tail into the shards via the ordinary refresh commit,
    after which the binding is fresh and the tail is reset."""
    rng = np.random.default_rng(17)
    c, t, X, rep = _build(tmp_path, rng)
    # in-distribution tail: greedy insert wires such rows into the graph at
    # full recall (an isolated far-off cluster is a known insert-quality
    # limit of refresh_index itself, independent of the tail tier)
    Y = _append_tail(t, rng, 100, loc=0.0)

    assert c.coordinator.compact_tail("docs", "idx", threshold_rows=4096) is None
    assert c.coordinator.probe("docs", Y[:2], 5).tail_rows == 100  # untouched

    rr = c.coordinator.compact_tail("docs", "idx", threshold_rows=64)
    assert rr is not None and rr.inserted == 100
    snap = c.catalog.load_table("docs").current_snapshot()
    assert snap.statistics_file == rr.puffin_path
    assert snap.summary.get("ann.fresh-tail-file") is None

    Q = Y[:4] + 0.01 * rng.normal(size=(4, DIM)).astype(np.float32)
    pr = c.coordinator.probe("docs", Q, 5, strategy="diskann")
    assert pr.stale is False and pr.tail_rows == 0 and pr.unindexed_rows == 0
    oracle = c.coordinator.probe("docs", Q, 5, strategy="scan")
    assert _recall(pr, oracle) == 1.0  # folded rows now served by the graph

    # no tail → compaction is a no-op even when forced
    assert c.coordinator.compact_tail("docs", "idx", force=True) is None


def test_gc_reaps_orphaned_tail_puffins(tmp_path):
    """Tail Puffins follow the same lifecycle as index Puffins: referenced
    while any retained snapshot binds them (time travel keeps working),
    orphaned — and deletable — once those snapshots expire."""
    rng = np.random.default_rng(19)
    c, t, X, rep = _build(tmp_path, rng)
    _append_tail(t, rng, 90)
    tail_path = c.catalog.load_table("docs").current_snapshot().summary[
        "ann.fresh-tail-file"
    ]
    rr = c.coordinator.compact_tail("docs", "idx", force=True)
    assert rr is not None

    # append snapshot still retained → its tail blob is NOT an orphan
    meta = c.catalog.load_table("docs")
    keep_all = expire_and_collect(c.store, meta, keep_last=len(meta.snapshots))
    assert tail_path not in keep_all

    # expire everything but the compaction snapshot → tail blob orphaned
    orphans = expire_and_collect(
        c.store, meta, keep_last=1, delete=True, catalog=c.catalog,
        table_name="docs",
    )
    assert tail_path in orphans
    assert rr.puffin_path not in orphans
    with pytest.raises(Exception):
        c.store.stat(tail_path)  # actually deleted
    # the live index still probes after the sweep
    pr = c.coordinator.probe("docs", X[:2], 5, strategy="diskann")
    assert all(len(h) == 5 for h in pr.hits)
