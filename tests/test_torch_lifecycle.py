"""The reference's ``tests/test_system.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU (``test_torch_system.py``
holds the two packages against each other).

End-to-end system behaviour: the paper's full lifecycle in one scenario.

Create table → ingest embeddings → CREATE INDEX (3-stage distributed build
into a Puffin file, snapshot-bound) → probe (tiered strategies) → append +
delete data → REFRESH INDEX (manifest diff, greedy insert, tombstones,
metadata-only commit) → time travel to the old index → orphan GC of the
superseded Puffin.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.blobs import ROUTING_BLOB_TYPE, SHARD_BLOB_TYPE, decode_routing_blob  # noqa: E402
from _torch_cpu import brute_force_topk  # noqa: E402
from repro_torch.iceberg.gc import expire_and_collect  # noqa: E402
from repro_torch.iceberg.puffin import PuffinReader  # noqa: E402
from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from _torch_cpu import make_local_cluster  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig  # noqa: E402
from conftest import clustered_vectors  # noqa: E402


def test_full_lifecycle(tmp_path):
    rng = np.random.default_rng(0)
    c = make_local_cluster(str(tmp_path), num_executors=3)
    t = LakehouseTable(c.catalog, "docs")
    t.create(dim=24)
    X, centers = clustered_vectors(rng, n_clusters=12, per_cluster=90, dim=24)
    t.append_vectors(X, num_files=6, rows_per_group=128)

    # -- CREATE INDEX ------------------------------------------------------
    rep = c.coordinator.create_index(
        "docs", IndexConfig(name="docs_vec", R=16, L=32, pq_m=12, pq_nbits=8,
                            partitions_per_shard=2, build_passes=1)
    )
    assert rep.vector_count == len(X)
    # the Puffin file is bound to the snapshot
    meta = c.catalog.load_table("docs")
    assert meta.current_snapshot().statistics_file == rep.puffin_path
    # the file is a valid Puffin with routing + centroid + shard blobs
    reader = PuffinReader(
        c.store.stat(rep.puffin_path).size, c.store.range_reader(rep.puffin_path)
    )
    routing = decode_routing_blob(reader.read_first(ROUTING_BLOB_TYPE))
    assert routing.num_shards == rep.num_shards
    assert routing.base_snapshot_id == rep.base_snapshot_id
    assert len(reader.blobs_of_type(SHARD_BLOB_TYPE)) == rep.num_shards

    # -- probe --------------------------------------------------------------
    Q = X[rng.choice(len(X), 10)]
    _, truth = brute_force_topk(X, Q, 5)
    pr = c.coordinator.probe("docs", Q, 5, strategy="diskann")
    assert len(pr.hits) == 10 and all(len(h) == 5 for h in pr.hits)
    # warm-cache probe: shard blobs served from executor caches, so the
    # object store sees only footer/routing + rerank row groups.  (The
    # probe-vs-scan byte ratio of paper Table 2 is measured at scale in
    # benchmarks/bench_query_paths.py — at this toy size rerank row groups
    # approach the whole table.)
    pr_warm = c.coordinator.probe("docs", Q, 5, strategy="diskann")
    assert pr_warm.bytes_read < pr.bytes_read
    assert pr_warm.cache_hits == pr_warm.shards_probed

    # -- data churn + REFRESH ------------------------------------------------
    Y = (centers[0] + rng.normal(size=(160, 24))).astype(np.float32)
    t.append_vectors(Y, num_files=2, file_prefix="new")
    doomed = t.current_files()[0].path
    t.delete_files([doomed])
    rr = c.coordinator.refresh_index("docs", "docs_vec")
    assert rr.inserted == 160 and rr.tombstoned > 0
    meta = c.catalog.load_table("docs")
    assert meta.current_snapshot().statistics_file == rr.puffin_path
    assert rr.puffin_path != rep.puffin_path  # new object, old superseded

    # refreshed index serves the new data and hides the deleted file
    pr2 = c.coordinator.probe("docs", Y[:5], 5, strategy="diskann")
    flat = [h for hits in pr2.hits for h in hits]
    assert any("new" in h.file_path for h in flat)
    assert not any(h.file_path == doomed for h in flat)

    # -- time travel: the old snapshot still probes the old index -----------
    pr_old = c.coordinator.probe("docs", Q, 5, snapshot_id=rep.snapshot_id)
    assert len(pr_old.hits) == 10

    # -- GC: expiring old snapshots orphans the superseded Puffin -----------
    orphans = expire_and_collect(c.store, c.catalog.load_table("docs"), keep_last=1, delete=False)
    assert rep.puffin_path in orphans
    assert rr.puffin_path not in orphans


def test_refresh_then_committed_expire_collects_old_puffin(tmp_path):
    """Regression (refresh_index ↔ gc interplay): after a REFRESH commit the
    superseded index Puffin must be collectible — and actually deletable —
    via a *committed* expiration.  The uncommitted form left the catalog
    serving expired snapshots whose backing objects were gone (time travel
    crashed with NoSuchKey after delete=True)."""
    rng = np.random.default_rng(2)
    c = make_local_cluster(str(tmp_path), num_executors=2)
    t = LakehouseTable(c.catalog, "docs")
    t.create(dim=8)
    X = rng.normal(size=(400, 8)).astype(np.float32)
    t.append_vectors(X, num_files=3, rows_per_group=64)
    rep = c.coordinator.create_index(
        "docs", IndexConfig(name="v", R=12, L=24, partitions_per_shard=2, build_passes=1)
    )
    t.append_vectors(rng.normal(size=(100, 8)).astype(np.float32), num_files=1)
    rr = c.coordinator.refresh_index("docs", "v")
    assert rr.puffin_path != rep.puffin_path

    # committed expiration: the catalog's served metadata agrees with storage
    orphans = expire_and_collect(
        c.store, c.catalog.load_table("docs"), keep_last=1, delete=True,
        catalog=c.catalog, table_name="docs",
    )
    assert rep.puffin_path in orphans       # superseded index reaped
    assert rr.puffin_path not in orphans    # live index untouched
    meta = c.catalog.load_table("docs")
    assert len(meta.snapshots) == 1         # expiration is visible to readers
    assert meta.current_snapshot().statistics_file == rr.puffin_path

    # the refreshed index still probes after the sweep deleted the orphans
    pr = c.coordinator.probe("docs", X[:3], 5, strategy="diskann")
    assert all(len(h) == 5 for h in pr.hits)
