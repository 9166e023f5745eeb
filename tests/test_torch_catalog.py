"""The reference's ``tests/test_catalog.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU.

Catalog semantics: optimistic concurrency, snapshots, diff, GC, time travel.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import tmp_store  # noqa: E402,F401
from repro_torch.iceberg.catalog import CommitConflict, RestCatalog  # noqa: E402
from repro_torch.iceberg.diff import diff_snapshots  # noqa: E402
from repro_torch.iceberg.gc import collect_orphans, expire_and_collect  # noqa: E402
from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402


@pytest.fixture()
def table(tmp_store):
    cat = RestCatalog(tmp_store)
    t = LakehouseTable(cat, "t")
    t.create(dim=8)
    return t


def _vecs(n, d=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_append_and_scan(table):
    table.append_vectors(_vecs(100), num_files=4)
    vecs, locs = table.scan_vectors()
    assert vecs.shape == (100, 8)
    assert len({l.file_path for l in locs}) == 4


def test_snapshot_chain_and_time_travel(table):
    m1 = table.append_vectors(_vecs(10))
    m2 = table.append_vectors(_vecs(10, seed=1))
    assert m2.current_snapshot().parent_snapshot_id == m1.current_snapshot_id
    old = m2.snapshot_by_id(m1.current_snapshot_id)
    as_of = m2.snapshot_as_of(old.timestamp_ms)
    assert as_of.snapshot_id in (m1.current_snapshot_id, m2.current_snapshot_id)


def test_diff_added_deleted(table):
    m1 = table.append_vectors(_vecs(100), num_files=2)
    s1 = m1.current_snapshot_id
    table.append_vectors(_vecs(50, seed=1), num_files=1)
    doomed = table.current_files()[0].path
    m3 = table.delete_files([doomed])
    d = diff_snapshots(table.store, m3, s1, m3.current_snapshot_id)
    assert len(d.added) == 1
    assert len(d.deleted) == 1
    assert d.deleted[0].path == doomed
    assert len(d.existing) == 1


def test_commit_conflict_and_retry(tmp_store):
    cat = RestCatalog(tmp_store)
    t = LakehouseTable(cat, "x")
    t.create(dim=8)
    base = cat.load_table("x")

    def add_prop(key):
        def mutate(meta):
            meta.properties[key] = "1"
            return meta

        return mutate

    cat.commit("x", base, add_prop("a"))
    # second commit against the SAME stale base must conflict
    with pytest.raises(CommitConflict):
        cat.commit("x", base, add_prop("b"))
    # retry path rebases
    cat.commit_with_retries("x", add_prop("b"))
    final = cat.load_table("x")
    assert final.properties == {"a": "1", "b": "1"}


def test_concurrent_committers_one_wins_per_round(tmp_store):
    cat = RestCatalog(tmp_store)
    t = LakehouseTable(cat, "y")
    t.create(dim=8)
    errors = []

    def worker(i):
        try:
            cat.commit_with_retries(
                "y", lambda m: (m.properties.__setitem__(f"k{i}", "v"), m)[1]
            )
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    [th.start() for th in threads]
    [th.join() for th in threads]
    assert not errors
    final = cat.load_table("y")
    assert len(final.properties) == 8
    # every thread's write must have landed despite the race (conflicts are
    # timing-dependent; the deterministic conflict path is tested above)
    assert final.version == 8


def test_statistics_file_binding_and_staleness(table):
    m1 = table.append_vectors(_vecs(10))
    table.store.put("warehouse/t/metadata/idx.puffin", b"fake")
    m2 = table.catalog.set_statistics_file(
        "t", "warehouse/t/metadata/idx.puffin",
        expected_base_snapshot_id=m1.current_snapshot_id,
    )
    assert m2.current_snapshot().statistics_file == "warehouse/t/metadata/idx.puffin"
    # appending carries the binding forward as stale (twice!)
    table.append_vectors(_vecs(5, seed=2))
    m4 = table.append_vectors(_vecs(5, seed=3))
    assert m4.current_snapshot().statistics_file is None
    assert (
        m4.current_snapshot().summary["ann.stale-statistics-file"]
        == "warehouse/t/metadata/idx.puffin"
    )


def test_stale_base_guard(table):
    m1 = table.append_vectors(_vecs(10))
    table.append_vectors(_vecs(10, seed=1))  # table advances
    table.store.put("warehouse/t/metadata/idx2.puffin", b"fake")
    with pytest.raises(CommitConflict):
        table.catalog.set_statistics_file(
            "t", "warehouse/t/metadata/idx2.puffin",
            expected_base_snapshot_id=m1.current_snapshot_id,  # stale base
        )


def test_orphan_gc(table):
    table.append_vectors(_vecs(50), num_files=2)
    # an uncommitted leftover (e.g. crashed index build)
    table.store.put("warehouse/t/metadata/leftover-shard.blob", b"junk")
    orphans = collect_orphans(table.store, table.metadata())
    assert orphans == ["warehouse/t/metadata/leftover-shard.blob"]
    # expiring old snapshots orphans their unique files
    table.append_vectors(_vecs(10, seed=1))
    meta = table.metadata()
    orphans = expire_and_collect(table.store, meta, keep_last=1, delete=True)
    for key in orphans:
        assert not table.store.exists(key)
    # table still readable at the retained snapshot
    vecs, _ = table.scan_vectors()
    assert vecs.shape[0] == 60


def test_snapshot_as_of_edge_cases():
    """Time-travel edges: before the first snapshot raises; an exact
    boundary timestamp is inclusive; equal timestamps break ties by
    sequence number (the later commit wins)."""
    from repro_torch.iceberg.snapshot import Snapshot, TableMetadata

    snaps = [
        Snapshot(1, None, 1, 1000, "ml1", "append"),
        Snapshot(2, 1, 2, 2000, "ml2", "append"),
    ]
    meta = TableMetadata("u", "loc", {}, 0, 2, snaps)
    with pytest.raises(KeyError):
        meta.snapshot_as_of(999)
    assert meta.snapshot_as_of(1000).snapshot_id == 1  # exact boundary
    assert meta.snapshot_as_of(1999).snapshot_id == 1
    assert meta.snapshot_as_of(2000).snapshot_id == 2
    assert meta.snapshot_as_of(10**15).snapshot_id == 2
    # same-millisecond commits: sequence number breaks the tie
    meta.snapshots.append(Snapshot(3, 2, 3, 2000, "ml3", "append"))
    assert meta.snapshot_as_of(2000).snapshot_id == 3


def test_catalog_expire_snapshots_commit(table):
    table.append_vectors(_vecs(30), num_files=1)
    table.append_vectors(_vecs(30, seed=1), num_files=1)
    table.append_vectors(_vecs(30, seed=2), num_files=1)
    before = table.metadata()
    assert len(before.snapshots) == 3
    meta = table.catalog.expire_snapshots("t", keep_last=2)
    assert len(meta.snapshots) == 2
    assert meta.version == before.version + 1  # a real metadata commit
    # the expiration is what every reader now sees
    assert len(table.catalog.load_table("t").snapshots) == 2
    with pytest.raises(ValueError):
        table.catalog.expire_snapshots("t", keep_last=0)
