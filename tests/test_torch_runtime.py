"""The reference's ``tests/test_runtime.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU.

Distributed runtime: build/probe/refresh protocols + fault tolerance.

These are the paper's §5–§7 protocols end-to-end, plus the scale-out
machinery from DESIGN.md §6: executor failure reassignment, straggler
speculation, elasticity, concurrent-refresh arbitration, tombstone-driven
shard rebuild.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import brute_force_topk, built_cluster  # noqa: E402,F401
from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig  # noqa: E402
from conftest import BUILT_CFG as CFG, clustered_vectors  # noqa: E402

# ``built_cluster``: the port's twin of conftest's, one per module


def _recall(table, X, hits_lists, truth_ids):
    vecs_all, locs_all = table.scan_vectors()
    truth_locs = [
        {(locs_all[i].file_path, locs_all[i].row_group_id, locs_all[i].row_offset) for i in row}
        for row in truth_ids
    ]
    scores = []
    for hits, truth in zip(hits_lists, truth_locs):
        got = {(h.file_path, h.row_group, h.row_offset) for h in hits}
        scores.append(len(got & truth) / len(truth))
    return float(np.mean(scores))


def test_build_covers_all_vectors(built_cluster):
    c, t, X, centers, rep = built_cluster
    assert rep.vector_count == len(X)
    assert rep.num_shards == 3
    assert c.store.exists(rep.puffin_path)


def test_probe_strategies_and_recall(built_cluster):
    c, t, X, centers, rep = built_cluster
    rng = np.random.default_rng(1)
    Q = X[rng.choice(len(X), 12)]
    _, truth = brute_force_topk(X, Q, 10)
    pr_scan = c.coordinator.probe("emb", Q, 10, strategy="scan")
    assert _recall(t, X, pr_scan.hits, truth) == 1.0
    pr_dk = c.coordinator.probe("emb", Q, 10, strategy="diskann")
    assert _recall(t, X, pr_dk.hits, truth) >= 0.85
    pr_cent = c.coordinator.probe("emb", Q, 10, strategy="centroid", n_probe=4)
    assert _recall(t, X, pr_cent.hits, truth) >= 0.8
    # warm-cache index path reads less object-store data than the scan path
    # (cold probes pay the one-time shard-blob download, amortized at scale
    # — paper Table 2's warm column; measured at scale in bench_query_paths)
    pr_warm = c.coordinator.probe("emb", Q, 10, strategy="diskann")
    assert pr_warm.bytes_read < pr_scan.bytes_read


def test_probe_cache_warm(built_cluster):
    c, t, X, centers, rep = built_cluster
    Q = X[:4]
    c.coordinator.probe("emb", Q, 5, strategy="diskann")
    pr = c.coordinator.probe("emb", Q, 5, strategy="diskann")
    assert pr.cache_hits == pr.shards_probed  # L1/SSD cache hit on all shards


def test_executor_failure_reassignment(tmp_path):
    from _torch_cpu import make_local_cluster

    rng = np.random.default_rng(2)
    c = make_local_cluster(str(tmp_path), num_executors=3, max_attempts=5)
    t = LakehouseTable(c.catalog, "emb")
    t.create(dim=16)
    X, _ = clustered_vectors(rng, n_clusters=8, per_cluster=60, dim=16)
    t.append_vectors(X, num_files=6)
    # one executor dies mid-wave: its fragments must be reassigned
    c.executors[1].fail_next(1)
    rep = c.coordinator.create_index("emb", IndexConfig(name="idx", **CFG))
    assert rep.vector_count == len(X)
    assert c.coordinator.scheduler.stats.reassigned >= 1


def test_dead_executor_probe_survives(built_cluster):
    c, t, X, centers, rep = built_cluster
    # a heartbeat-dead executor is excluded proactively; the probe succeeds
    c.executors[0].kill()
    try:
        pr = c.coordinator.probe("emb", X[:2], 5, strategy="diskann")
        assert len(pr.hits) == 2
    finally:
        c.executors[0].revive()
    # mid-flight failures (dispatched then died) are reassigned: make every
    # executor fail its next task — all first attempts die, retries succeed
    before = c.coordinator.scheduler.stats.reassigned
    for ex in c.executors:
        ex.fail_next(1)
    pr = c.coordinator.probe("emb", X[:2], 5, strategy="diskann")
    assert len(pr.hits) == 2
    assert c.coordinator.scheduler.stats.reassigned > before


def test_straggler_speculation(tmp_path):
    from _torch_cpu import make_local_cluster

    rng = np.random.default_rng(3)
    c = make_local_cluster(str(tmp_path), num_executors=3, enable_speculation=True)
    c.coordinator.scheduler.speculation_factor = 2.0
    t = LakehouseTable(c.catalog, "emb")
    t.create(dim=16)
    X, _ = clustered_vectors(rng, n_clusters=8, per_cluster=60, dim=16)
    t.append_vectors(X, num_files=6)
    c.coordinator.create_index("emb", IndexConfig(name="idx", **CFG))
    # warm up first (caches) so the wave's median latency is
    # small; then a 2 s straggler is far beyond speculation_factor × median
    c.coordinator.probe("emb", X[:2], 5, strategy="diskann")
    c.executors[2].delay_next(2.0)
    pr = c.coordinator.probe("emb", X[:2], 5, strategy="diskann")
    assert len(pr.hits) == 2
    assert c.coordinator.scheduler.stats.speculative >= 1


def test_elastic_scale_out_and_in(built_cluster):
    c, t, X, centers, rep = built_cluster
    ex = c.add_executor()  # new empty-cache executor joins
    pr = c.coordinator.probe("emb", X[:2], 5, strategy="diskann")
    assert len(pr.hits) == 2
    c.remove_executor(ex.executor_id)
    pr = c.coordinator.probe("emb", X[:2], 5, strategy="diskann")
    assert len(pr.hits) == 2


def test_refresh_insert_and_tombstone(built_cluster):
    c, t, X, centers, rep = built_cluster
    rng = np.random.default_rng(4)
    Y = (centers[3] + rng.normal(size=(150, 32))).astype(np.float32)
    t.append_vectors(Y, num_files=1, file_prefix="delta")
    doomed = t.current_files()[0].path
    t.delete_files([doomed])
    rr = c.coordinator.refresh_index("emb", "idx")
    assert rr.inserted == 150
    assert rr.tombstoned > 0
    # new vectors findable; deleted file gone
    Q = Y[:6]
    pr = c.coordinator.probe("emb", Q, 8, strategy="diskann")
    flat = [h for hits in pr.hits for h in hits]
    assert any("delta" in h.file_path for h in flat)
    assert not any(h.file_path == doomed for h in flat)
    # no-op refresh detected
    rr2 = c.coordinator.refresh_index("emb", "idx")
    assert rr2.noop


def test_tombstone_threshold_triggers_shard_rebuild(tmp_path):
    from _torch_cpu import make_local_cluster

    rng = np.random.default_rng(5)
    c = make_local_cluster(str(tmp_path), num_executors=2)
    t = LakehouseTable(c.catalog, "emb")
    t.create(dim=16)
    X, _ = clustered_vectors(rng, n_clusters=4, per_cluster=120, dim=16)
    t.append_vectors(X, num_files=4)
    # R/L as in CFG (the reference's choice, kept)
    c.coordinator.create_index("emb", IndexConfig(name="idx", R=16, L=32,
                                                  partitions_per_shard=2, build_passes=1))
    # delete half the files -> some shard crosses the 20% tombstone ratio
    files = [f.path for f in t.current_files()]
    t.delete_files(files[:2])
    rr = c.coordinator.refresh_index("emb", "idx")
    assert rr.tombstoned > 0
    assert rr.shards_rebuilt >= 1
    # post-rebuild probe still correct on remaining data
    vecs, locs = t.scan_vectors()
    pr = c.coordinator.probe("emb", vecs[:4], 5, strategy="diskann")
    assert all(len(h) == 5 for h in pr.hits)


def test_time_travel_probe(built_cluster):
    c, t, X, centers, rep = built_cluster
    pr = c.coordinator.probe("emb", X[:2], 5, snapshot_id=rep.snapshot_id)
    assert len(pr.hits) == 2
