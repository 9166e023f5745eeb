"""The slice as a whole: an index built by one package is probed by the other.

- ``repro`` builds an index; ``repro_torch`` (on the CPU) probes the same
  catalog with ``strategy="diskann"`` and returns the same hits: the same
  row locations in the same order, distances within 1e-5 of |q|^2 + |x|^2
  (Stage B scores with the expanded form, and torch and XLA multiply in
  another order, so small distances carry that much absolute error).
- ``repro_torch`` builds an index; ``repro`` probes it with recall@10 of at
  least 0.9 against brute force.
- The port never loads ``jax`` or ``repro`` (through a filtered
  ``probe_batch`` too), and its entry points refuse to run on a missing
  card instead of falling back to the CPU.
- Filtered, batched and fresh-tail probes (the second half of this file):
  on catalogs ``repro`` built, the port gives the reference's hits, plans
  and dispatch counters, and its unified, split-flavor and group-loop
  paths agree bit for bit.
- Quantized ExactScans (``scan_dtype`` bf16 / int8) give the reference's
  hits and counters.
- Refresh (the last part): ``insert_batch`` on the reference's graph gives
  its adjacency row for row; on copies of one catalog the two packages
  refresh (insert, tombstone, shard rebuild, ``compact_tail``) to the same
  counts and hits; an index refreshed by either package probes in the
  other; and the reference's refresh tests, ported, hold for the port.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import clustered_vectors  # noqa: E402
from repro.lakehouse.table import LakehouseTable as RefTable  # noqa: E402
from repro.runtime.cluster import make_local_cluster as ref_cluster  # noqa: E402
from repro.runtime.coordinator import IndexConfig as RefConfig  # noqa: E402
from repro_torch.core.vamana import brute_force_topk  # noqa: E402
from repro_torch.lakehouse.table import LakehouseTable as PortTable  # noqa: E402
from repro_torch.runtime.cluster import make_local_cluster as port_cluster  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig as PortConfig  # noqa: E402
from repro_torch.runtime.planner import ProbePlan as PortPlan  # noqa: E402

DIM = 16
CFG = dict(name="idx", R=12, L=24, pq_m=4, partitions_per_shard=2, build_passes=1, build_batch=128)
ROWS_PER_GROUP = 128
SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(0)
    X, _ = clustered_vectors(rng, n_clusters=8, per_cluster=150, dim=DIM)
    Q = X[rng.choice(len(X), 24, replace=False)] + 0.05 * rng.normal(size=(24, DIM)).astype(np.float32)
    return X, Q


def _ingest(table_cls, cluster, X):
    t = table_cls(cluster.catalog, "emb")
    t.create(dim=DIM)
    t.append_vectors(X, num_files=6, rows_per_group=ROWS_PER_GROUP)
    return t


def _locs(report):
    return [[(h.file_path, h.row_group, h.row_offset) for h in hits] for hits in report.hits]


def _row_index(table, hits, rows_per_group=ROWS_PER_GROUP):
    starts, base = {}, 0
    for f in table.current_files():
        starts[f.path] = base
        base += f.record_count
    return np.array(
        [[starts[h.file_path] + h.row_group * rows_per_group + h.row_offset for h in hs]
         for hs in hits]
    )


@pytest.fixture(scope="module")
def ref_built(tmp_path_factory, dataset):
    X, _ = dataset
    root = str(tmp_path_factory.mktemp("ref_built"))
    c = ref_cluster(root, num_executors=3)
    _ingest(RefTable, c, X)
    c.coordinator.create_index("emb", RefConfig(**CFG))
    return root, c


def test_port_probes_reference_index_with_equal_hits(ref_built, dataset):
    X, Q = dataset
    root, ref = ref_built
    port = port_cluster(root, num_executors=3, device="cpu")
    want = ref.coordinator.probe("emb", Q, 5, strategy="diskann")
    got = port.coordinator.probe("emb", Q, 5, strategy="diskann")
    assert got.strategy == "diskann" and got.shards_probed == want.shards_probed
    for qi, (g, w) in enumerate(zip(_locs(got), _locs(want))):
        assert g == w, (
            f"first split at query {qi}: {Q[qi].tolist()}\n port {g}\n reference {w}"
        )
    scale = 1e-5 * (float(np.max(np.sum(Q * Q, 1))) + float(np.max(np.sum(X * X, 1))))
    gd = np.array([[h.distance for h in hs] for hs in got.hits])
    wd = np.array([[h.distance for h in hs] for hs in want.hits])
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=scale)


def test_reference_probes_port_index(tmp_path, dataset):
    X, Q = dataset
    root = str(tmp_path)
    port = port_cluster(root, num_executors=3, device="cpu")
    table = _ingest(PortTable, port, X)
    rep = port.coordinator.create_index("emb", PortConfig(**CFG))
    assert rep.vector_count == len(X) and rep.num_shards == 3
    ref = ref_cluster(root, num_executors=3)
    report = ref.coordinator.probe("emb", Q, 10, strategy="diskann")
    _, truth = brute_force_topk(X, Q, 10, device="cpu")
    got = _row_index(table, report.hits)
    recall = np.mean([len(set(g) & set(t)) / 10 for g, t in zip(got, truth)])
    assert recall >= 0.9
    # and the port answers its own index with the same rows
    own = port.coordinator.probe("emb", Q, 10, strategy="diskann")
    assert _locs(own) == _locs(report)


def test_probe_leaves_jax_and_repro_unloaded(tmp_path):
    code = f"""
import sys, numpy as np
from repro_torch.lakehouse.table import LakehouseTable
from repro_torch.runtime.cluster import make_local_cluster
from repro_torch.runtime.coordinator import IndexConfig
rng = np.random.default_rng(0)
X = rng.normal(size=(600, 8)).astype(np.float32)
price = rng.integers(0, 100, size=600).astype(np.int64)
c = make_local_cluster({str(tmp_path)!r}, num_executors=2, device="cpu")
t = LakehouseTable(c.catalog, "emb"); t.create(dim=8)
t.append_vectors(X, num_files=2, attributes={{"price": price}})
c.coordinator.create_index("emb", IndexConfig(name="i", R=8, L=16, pq_m=2, build_passes=1))
r = c.coordinator.probe("emb", X[:3], 4, strategy="diskann")
assert [len(h) for h in r.hits] == [4, 4, 4]
r = c.coordinator.probe_batch("emb", X[:4], 4, strategy="diskann",
                              filter=["price < 5", "price < 50", None, "price < 90"])
assert [len(h) for h in r.hits] == [4, 4, 4, 4], r.hits
assert r.kernel_dispatches > 0
for dt in ("bf16", "int8"):
    r = c.coordinator.probe_batch("emb", X[:3], 4, strategy="diskann", filter="price < 5",
                                  scan_dtype=dt)
    assert [len(h) for h in r.hits] == [4, 4, 4], r.hits
t.append_vectors(rng.normal(size=(90, 8)).astype(np.float32), num_files=1,
                 attributes={{"price": np.arange(90, dtype=np.int64)}})
t.delete_files([t.current_files()[0].path])
rr = c.coordinator.refresh_index("emb", "i")
assert rr.inserted == 90 and rr.tombstoned > 0, rr
r = c.coordinator.probe("emb", X[:3], 4, strategy="diskann")
assert [len(h) for h in r.hits] == [4, 4, 4]
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout


@pytest.mark.parametrize("entry", ["cluster", "executor", "graph", "kmeans"])
def test_entry_points_refuse_missing_cuda(tmp_path, entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.core.kmeans import train_kmeans
    from repro_torch.core.vamana import VamanaGraph, VamanaParams
    from repro_torch.lakehouse.objectstore import ObjectStore
    from repro_torch.runtime.executor import Executor

    calls = {
        "cluster": lambda: port_cluster(str(tmp_path)),
        "executor": lambda: Executor("ex", ObjectStore(str(tmp_path / "s3")), str(tmp_path / "c")),
        "graph": lambda: VamanaGraph(np.zeros((4, 2), np.float32), np.zeros((4, 2), np.int32),
                                     4, 0, VamanaParams(R=2, L=4)),
        "kmeans": lambda: train_kmeans(np.zeros((8, 2), np.float32), 2),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def _copy_catalog(root, dst):
    """A second copy of a catalog's object store (caches are disposable)."""
    shutil.copytree(os.path.join(root, "s3"), os.path.join(str(dst), "s3"))
    return str(dst)


def _same_refresh(got, want):
    for f in ("inserted", "tombstoned", "shards_refreshed", "shards_rebuilt", "shards_reused",
              "noop"):
        assert getattr(got, f) == getattr(want, f), f


def test_refresh_matches_reference(tmp_path, dataset):
    """On two copies of a catalog ``repro`` built, appended to and deleted
    from, each package refreshes its own copy: the same counts, and the
    refreshed indexes answer with the same hits."""
    X, Q = dataset
    root = str(tmp_path / "ref")
    ref = ref_cluster(root, num_executors=3)
    table = _ingest(RefTable, ref, X[:600])
    ref.coordinator.create_index("emb", RefConfig(**CFG))
    table.append_vectors(X[600:700], num_files=1, rows_per_group=ROWS_PER_GROUP)
    table.delete_files([table.current_files()[1].path])
    port = port_cluster(_copy_catalog(root, tmp_path / "port"), num_executors=3, device="cpu")
    want = ref.coordinator.refresh_index("emb", "idx")
    got = port.coordinator.refresh_index("emb", "idx")
    _same_refresh(got, want)
    assert got.inserted == 100 and got.tombstoned == 100 and got.shards_rebuilt == 0
    w = ref.coordinator.probe("emb", Q, 5, strategy="diskann")
    g = port.coordinator.probe("emb", Q, 5, strategy="diskann")
    assert _locs(g) == _locs(w)
    assert port.coordinator.refresh_index("emb", "idx").noop


# -- filtered, batched and fresh-tail probes ---------------------------------------

def _hit_locs(hits):
    return [(h.file_path, h.row_group, h.row_offset) for h in hits]


def _locs_d(hits):
    return [(h.file_path, h.row_group, h.row_offset, h.distance) for h in hits]


def _assert_same(got, want, X, Q):
    assert len(got.hits) == len(want.hits)
    for qi, (g, w) in enumerate(zip(got.hits, want.hits)):
        assert _hit_locs(g) == _hit_locs(w), (
            f"query {qi}\n port {_hit_locs(g)}\n reference {_hit_locs(w)}"
        )
    scale = 1e-5 * (float(np.max(np.sum(Q * Q, 1))) + float(np.max(np.sum(X * X, 1))))
    for g, w in zip(got.hits, want.hits):
        np.testing.assert_allclose(
            [h.distance for h in g], [h.distance for h in w], rtol=1e-5, atol=scale
        )
    assert got.filter_plan == want.filter_plan
    if want.plan is not None:
        assert got.plan.summary() == want.plan.summary()
        assert got.plan.to_json() == want.plan.to_json()
    assert got.kernel_dispatches == want.kernel_dispatches
    assert got.masked_beam_rows == want.masked_beam_rows
    assert got.masked_beam_fallbacks == want.masked_beam_fallbacks
    assert got.tail_rows == want.tail_rows
    assert got.unindexed_rows == want.unindexed_rows


def _queries(X, n, seed):
    rng = np.random.default_rng(seed)
    picks = X[rng.choice(len(X), n)]
    return (picks + 0.05 * rng.normal(size=picks.shape)).astype(np.float32)


# -- mixed: small PQ shards ------------------------------------------------------

@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    rng = np.random.default_rng(2)
    root = str(tmp_path_factory.mktemp("mixed"))
    ref = ref_cluster(root, num_executors=2)
    t = RefTable(ref.catalog, "emb")
    t.create(dim=DIM)
    centers = rng.normal(size=(6, DIM))
    X = np.concatenate([c + rng.normal(size=(220, DIM)) for c in centers]).astype(np.float32)
    price = rng.integers(0, 100, size=len(X)).astype(np.int64)
    t.append_vectors(X, num_files=4, rows_per_group=110, attributes={"price": price})
    ref.coordinator.create_index(
        "emb",
        RefConfig(name="idx", R=16, L=48, pq_m=8, pq_nbits=8, partitions_per_shard=2,
                  build_passes=1),
    )
    port = port_cluster(root, num_executors=2, device="cpu")
    return ref, port, X


@pytest.mark.parametrize(
    "where,band", [("price < 2", "prefilter"), ("price < 60", "mask"), ("price < 95", "postfilter")]
)
def test_filtered_probe_bands_match_reference(mixed, where, band):
    ref, port, X = mixed
    Q = _queries(X, 6, seed=3)
    want = ref.coordinator.probe("emb", Q, 10, strategy="diskann", filter=where)
    got = port.coordinator.probe("emb", Q, 10, strategy="diskann", filter=where)
    assert band in want.filter_plan, want.filter_plan
    _assert_same(got, want, X, Q)


# alternating tight (exact flavor) and wide (ADC flavor) predicates, all distinct
MIXED_FILTERS = [
    f"price < {2 + i // 2}" if i % 2 == 0 else f"price < {55 + 5 * (i // 2)}" for i in range(8)
]


def _set(cluster, name, flag):
    for ex in cluster.executors:
        setattr(ex, name, flag)


def test_mixed_flavor_batch_matches_reference_and_paths_agree(mixed):
    ref, port, X = mixed
    Q = _queries(X, 8, seed=4)
    want = ref.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=MIXED_FILTERS)
    got = port.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=MIXED_FILTERS)
    flavors = {type(got.plan.op_for(qi, s)).__name__ for qi in range(8) for s in got.plan.ops[qi]}
    assert {"ExactScan", "PQScan"} <= flavors
    assert got.kernel_dispatches == got.probe_fragments  # one unified call per shard
    _assert_same(got, want, X, Q)
    for flag, per_fragment in (("force_split_flavors", 2), ("force_group_loop", len(MIXED_FILTERS))):
        _set(port, flag, True)
        try:
            other = port.coordinator.probe_batch(
                "emb", Q, 10, strategy="diskann", filter=MIXED_FILTERS
            )
        finally:
            _set(port, flag, False)
        assert other.kernel_dispatches == per_fragment * other.probe_fragments
        for a, b in zip(got.hits, other.hits):
            assert _locs_d(a) == _locs_d(b), flag  # bit-identical, distances included


def test_heterogeneous_batch_with_unfiltered_rows_matches_reference(mixed):
    """Distinct predicates on one flavor (the dedup'd exact plane), plus
    unfiltered queries riding the fragment as all-ones rows."""
    ref, port, X = mixed
    Q = _queries(X, 6, seed=5)
    filters = ["price < 3", "price < 4", None, "price < 3", "price < 5", None]
    want = ref.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=filters)
    got = port.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=filters)
    _assert_same(got, want, X, Q)


def test_unfiltered_probe_batch_matches_reference(mixed):
    ref, port, X = mixed
    Q = _queries(X, 10, seed=6)
    want = ref.coordinator.probe_batch("emb", Q, 10, strategy="diskann")
    got = port.coordinator.probe_batch("emb", Q, 10, strategy="diskann")
    _assert_same(got, want, X, Q)
    # and equals sequential probe() calls
    seq = [port.coordinator.probe("emb", q, 10, strategy="diskann").hits[0] for q in Q[:3]]
    assert [_hit_locs(h) for h in seq] == [_hit_locs(h) for h in got.hits[:3]]


def _rerank_calls(cluster):
    return sum(ex.rerank_kernel_dispatches for ex in cluster.executors)


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantized_scan_dtype_matches_reference(mixed, dtype):
    """ExactScan rows scanned in bf16 / int8 at ``quant_guard_pool(k)``,
    then the full-precision guard: the reference's hits (exact f32
    distances), plans, scan dispatches and guard reranks, for a single
    predicate and for a batch mixing ExactScan and PQScan rows."""
    ref, port, X = mixed
    Q = _queries(X, 8, seed=21)
    for call in (
        lambda c: c.coordinator.probe("emb", Q[:4], 10, strategy="diskann", filter="price < 2",
                                      scan_dtype=dtype),
        lambda c: c.coordinator.probe_batch("emb", Q, 10, strategy="diskann",
                                            filter=MIXED_FILTERS, scan_dtype=dtype),
    ):
        r0, p0 = _rerank_calls(ref), _rerank_calls(port)
        want, got = call(ref), call(port)
        assert got.plan.to_json() == want.plan.to_json()
        assert any(getattr(op, "dtype", None) == dtype for ops in got.plan.ops for op in ops.values())
        _assert_same(got, want, X, Q)
        assert _rerank_calls(port) - p0 == _rerank_calls(ref) - r0 > 0


# -- bigshard: one shard above EXACT_SCAN_MAX_ROWS --------------------------------

@pytest.fixture(scope="module")
def bigshard(tmp_path_factory):
    rng = np.random.default_rng(17)
    root = str(tmp_path_factory.mktemp("bigshard"))
    ref = ref_cluster(root, num_executors=2)
    t = RefTable(ref.catalog, "emb")
    t.create(dim=DIM)
    centers = rng.normal(size=(10, DIM)) * 3.0
    X = np.concatenate([c + rng.normal(size=(500, DIM)) for c in centers]).astype(np.float32)
    price = rng.integers(0, 100, size=len(X)).astype(np.int64)
    t.append_vectors(X, num_files=4, rows_per_group=250, attributes={"price": price})
    ref.coordinator.create_index(
        "emb",
        RefConfig(name="idx", num_shards=1, R=16, L=48, partitions_per_shard=4, build_passes=1),
    )
    port = port_cluster(root, num_executors=2, device="cpu")
    return ref, port, X


@pytest.mark.parametrize("where", ["price < 50", "price < 10", "price < 1", "price < 90"])
def test_bigshard_filtered_probe_matches_reference(bigshard, where):
    """MaskedBeam (0.5, 0.1), its collapse to ExactScan (0.01) and
    PostfilterBeam (0.9) on one 5,000-row shard."""
    ref, port, X = bigshard
    Q = _queries(X, 8, seed=7)
    want = ref.coordinator.probe("emb", Q, 10, strategy="diskann", filter=where)
    got = port.coordinator.probe("emb", Q, 10, strategy="diskann", filter=where)
    _assert_same(got, want, X, Q)


def test_bigshard_heterogeneous_batch_matches_reference(bigshard):
    """MaskedBeam rows pooled by width, ExactScan rows on the dedup'd plane
    and beam rows, in one fragment; the L override forces a starved
    traversal so the fused fallback fires too."""
    ref, port, X = bigshard
    Q = _queries(X, 8, seed=8)
    filters = ["price < 1", "price < 2", "price < 10", "price < 30", None, "price < 95",
               "price < 10", "price < 1"]
    for L in (None, 4):
        want = ref.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=filters, L=L)
        got = port.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=filters, L=L)
        assert got.masked_beam_rows > 0
        _assert_same(got, want, X, Q)


def test_replayed_plan_matches_reference(bigshard):
    ref, port, X = bigshard
    Q = _queries(X, 4, seed=9)
    filters = ["price < 10", "price < 2", "price < 10", "price < 40"]
    plan = ref.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=filters).plan
    want = ref.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=filters,
                                       replay_plan=plan)
    # the plan crosses between the packages as its JSON form
    got = port.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=filters,
                                       replay_plan=PortPlan.from_json(plan.to_json()))
    _assert_same(got, want, X, Q)


# -- tail: rows appended after the build -------------------------------------------

@pytest.fixture(scope="module")
def tail(tmp_path_factory):
    rng = np.random.default_rng(11)
    root = str(tmp_path_factory.mktemp("tail"))
    ref = ref_cluster(root, num_executors=2)
    t = RefTable(ref.catalog, "docs")
    t.create(dim=DIM)
    X = rng.normal(size=(480, DIM)).astype(np.float32)
    t.append_vectors(X, num_files=4, rows_per_group=64,
                     attributes={"cat": rng.integers(0, 4, size=480).astype(np.int64)})
    ref.coordinator.create_index(
        "docs", RefConfig(name="idx", R=12, L=24, partitions_per_shard=2, build_passes=1,
                          build_batch=128),
    )
    Y = rng.normal(loc=3.0, size=(150, DIM)).astype(np.float32)
    t.append_vectors(Y, num_files=1, rows_per_group=64, file_prefix="tail",
                     attributes={"cat": rng.integers(0, 4, size=150).astype(np.int64)})
    port = port_cluster(root, num_executors=2, device="cpu")
    return ref, port, np.concatenate([X, Y]), Y


def test_tail_probe_matches_reference(tail):
    ref, port, X, Y = tail
    Q = np.concatenate([_queries(Y, 4, seed=12), _queries(X[:480], 2, seed=13)])
    want = ref.coordinator.probe("docs", Q, 10, strategy="diskann")
    got = port.coordinator.probe("docs", Q, 10, strategy="diskann")
    assert got.tail_rows == 150 and got.unindexed_rows == 0
    _assert_same(got, want, X, Q)


@pytest.mark.parametrize("filters", [
    ["cat = 1", "cat < 2", None, "cat = 1", "cat = 3"],
    "cat = 2",
], ids=["heterogeneous", "shared"])
def test_tail_filtered_batch_matches_reference(tail, filters):
    ref, port, X, Y = tail
    Q = _queries(Y, 5, seed=14)
    want = ref.coordinator.probe_batch("docs", Q, 10, strategy="diskann", filter=filters)
    got = port.coordinator.probe_batch("docs", Q, 10, strategy="diskann", filter=filters)
    assert got.tail_rows == 150
    _assert_same(got, want, X, Q)


# -- refresh ---------------------------------------------------------------------

def test_refresh_insert_and_tombstone(tmp_path):
    """A port-built index: append near one cluster, delete a file, refresh.
    The new rows are found, the deleted file's rows never come back, and a
    second refresh is a no-op."""
    rng = np.random.default_rng(4)
    c = port_cluster(str(tmp_path), num_executors=2, device="cpu")
    t = PortTable(c.catalog, "emb")
    t.create(dim=DIM)
    X, centers = clustered_vectors(rng, n_clusters=6, per_cluster=100, dim=DIM)
    t.append_vectors(X, num_files=4, rows_per_group=ROWS_PER_GROUP)
    c.coordinator.create_index(
        "emb", PortConfig(name="idx", R=16, L=32, partitions_per_shard=2, build_passes=1)
    )
    Y = (centers[3] + rng.normal(size=(150, DIM))).astype(np.float32)
    t.append_vectors(Y, num_files=1, file_prefix="delta")
    doomed = t.current_files()[0]
    t.delete_files([doomed.path])
    rr = c.coordinator.refresh_index("emb", "idx")
    assert rr.inserted == 150 and rr.tombstoned == doomed.record_count
    pr = c.coordinator.probe("emb", Y[:6], 8, strategy="diskann")
    flat = [h for hits in pr.hits for h in hits]
    assert any("delta" in h.file_path for h in flat)
    assert not any(h.file_path == doomed.path for h in flat)
    assert c.coordinator.refresh_index("emb", "idx").noop


@pytest.mark.parametrize("pq", [False, True])
def test_insert_batch_matches_reference_adjacency(pq):
    """Greedy insert of 150 points (batches 64, 64, 22) into the
    reference's own graph: the port's adjacency equals the reference's row
    for row, and so do n, the vectors and the PQ codes."""
    from repro.core import vamana as jv
    from repro_torch.core import vamana as tv

    rng = np.random.default_rng(31)
    X, _ = clustered_vectors(rng, n_clusters=6, per_cluster=100, dim=DIM)
    Y = (X[rng.choice(len(X), 150)] + 0.1 * rng.normal(size=(150, DIM))).astype(np.float32)
    params = dict(R=16, L=32, alpha=1.2)
    g = jv.build_vamana(X, jv.VamanaParams(**params), passes=1, batch=64, seed=3,
                        with_pq=pq, pq_m=4)
    port = tv.graph_from_arrays(
        g.vectors, g.adjacency, g.n, g.medoid, tv.VamanaParams(**params),
        g.pq if pq else None, g.pq_codes, tombstones=g.tombstones, device="cpu",
    )
    want = g.insert_batch(Y)
    got = port.insert_batch(Y)
    np.testing.assert_array_equal(got, want)
    assert port.n == g.n == len(X) + len(Y)
    np.testing.assert_array_equal(port.vectors[: port.n], g.vectors[: g.n])
    np.testing.assert_array_equal(port.adjacency[: port.n], g.adjacency[: g.n])
    if pq:
        np.testing.assert_array_equal(port.pq_codes[: port.n], g.pq_codes[: g.n])
    # the grown graph searches like the reference's (device copies rebuilt)
    Q = Y[:8] + 0.01
    np.testing.assert_array_equal(port.search(Q, 5)[1], g.search(Q, 5)[1])


def test_tombstone_threshold_triggers_shard_rebuild(tmp_path):
    """Half the files deleted: a shard passes the 0.20 tombstone ratio and
    is rebuilt from its live rows, in both packages alike (the rebuild
    is a fresh build, held by recall, not bit for bit)."""
    rng = np.random.default_rng(5)
    root = str(tmp_path / "ref")
    ref = ref_cluster(root, num_executors=2)
    t = RefTable(ref.catalog, "emb")
    t.create(dim=DIM)
    X, _ = clustered_vectors(rng, n_clusters=4, per_cluster=120, dim=DIM)
    t.append_vectors(X, num_files=4, rows_per_group=ROWS_PER_GROUP)
    ref.coordinator.create_index(
        "emb", RefConfig(name="idx", R=16, L=32, partitions_per_shard=2, build_passes=1)
    )
    t.delete_files([f.path for f in t.current_files()][:2])
    port = port_cluster(_copy_catalog(root, tmp_path / "port"), num_executors=2, device="cpu")
    want = ref.coordinator.refresh_index("emb", "idx")
    got = port.coordinator.refresh_index("emb", "idx")
    _same_refresh(got, want)
    assert got.tombstoned > 0 and got.shards_rebuilt >= 1
    live = X[240:]  # the rows of the two files left
    _, truth = brute_force_topk(live, live[:12], 5, device="cpu")
    pr = port.coordinator.probe("emb", live[:12], 5, strategy="diskann")
    got_rows = _row_index(PortTable(port.catalog, "emb"), pr.hits)
    assert np.mean([len(set(a) & set(b)) / 5 for a, b in zip(got_rows, truth)]) >= 0.9


def test_refresh_then_committed_expire_collects_old_puffin(tmp_path):
    from repro_torch.iceberg.gc import expire_and_collect

    rng = np.random.default_rng(2)
    c = port_cluster(str(tmp_path), num_executors=2, device="cpu")
    t = PortTable(c.catalog, "docs")
    t.create(dim=8)
    X = rng.normal(size=(400, 8)).astype(np.float32)
    t.append_vectors(X, num_files=3, rows_per_group=64)
    rep = c.coordinator.create_index(
        "docs", PortConfig(name="v", R=12, L=24, partitions_per_shard=2, build_passes=1)
    )
    t.append_vectors(rng.normal(size=(100, 8)).astype(np.float32), num_files=1)
    rr = c.coordinator.refresh_index("docs", "v")
    assert rr.puffin_path != rep.puffin_path and rr.inserted == 100
    orphans = expire_and_collect(
        c.store, c.catalog.load_table("docs"), keep_last=1, delete=True,
        catalog=c.catalog, table_name="docs",
    )
    assert rep.puffin_path in orphans
    assert rr.puffin_path not in orphans
    meta = c.catalog.load_table("docs")
    assert len(meta.snapshots) == 1
    assert meta.current_snapshot().statistics_file == rr.puffin_path
    pr = c.coordinator.probe("docs", X[:3], 5, strategy="diskann")
    assert all(len(h) == 5 for h in pr.hits)


def test_compact_tail_threshold_and_fold(tmp_path):
    """Below the threshold the tail stays; past it ``compact_tail`` folds
    it into the shards through the refresh, in both packages alike, and
    the folded rows are served by the graph."""
    rng = np.random.default_rng(17)
    root = str(tmp_path / "ref")
    ref = ref_cluster(root, num_executors=2)
    t = RefTable(ref.catalog, "docs")
    t.create(dim=DIM)
    X = rng.normal(size=(480, DIM)).astype(np.float32)
    t.append_vectors(X, num_files=4, rows_per_group=64)
    ref.coordinator.create_index(
        "docs", RefConfig(name="idx", R=12, L=24, partitions_per_shard=2, build_passes=1,
                          build_batch=128),
    )
    Y = rng.normal(size=(100, DIM)).astype(np.float32)
    t.append_vectors(Y, num_files=1, rows_per_group=64, file_prefix="tail")
    port = port_cluster(_copy_catalog(root, tmp_path / "port"), num_executors=2, device="cpu")
    c = port.coordinator
    assert c.compact_tail("docs", "idx", threshold_rows=4096) is None
    assert c.probe("docs", Y[:2], 5).tail_rows == 100
    want = ref.coordinator.compact_tail("docs", "idx", threshold_rows=64)
    got = c.compact_tail("docs", "idx", threshold_rows=64)
    _same_refresh(got, want)
    assert got.inserted == 100
    snap = port.catalog.load_table("docs").current_snapshot()
    assert snap.statistics_file == got.puffin_path
    assert snap.summary.get("ann.fresh-tail-file") is None
    Q = Y[:4] + 0.01 * rng.normal(size=(4, DIM)).astype(np.float32)
    pr = c.probe("docs", Q, 5, strategy="diskann")
    assert pr.stale is False and pr.tail_rows == 0 and pr.unindexed_rows == 0
    assert _locs(pr) == _locs(ref.coordinator.probe("docs", Q, 5, strategy="diskann"))
    _, truth = brute_force_topk(np.concatenate([X, Y]), Q, 5, device="cpu")
    got_rows = _row_index(PortTable(port.catalog, "docs"), pr.hits, rows_per_group=64)
    assert [set(r) for r in got_rows] == [set(r) for r in truth]  # folded rows served
    assert c.compact_tail("docs", "idx", force=True) is None


def _filtered_catalog(tmp_path, name, seed, n_files):
    rng = np.random.default_rng(seed)
    root = str(tmp_path / name)
    ref = ref_cluster(root, num_executors=2)
    t = RefTable(ref.catalog, "emb")
    t.create(dim=DIM)
    X = rng.normal(size=(80 * 2 * n_files, DIM)).astype(np.float32)
    price = rng.integers(0, 100, size=len(X)).astype(np.int64)
    t.append_vectors(X, num_files=n_files, rows_per_group=80, attributes={"price": price})
    ref.coordinator.create_index(
        "emb", RefConfig(name="idx", R=12, L=32, partitions_per_shard=2, build_passes=1)
    )
    return root, rng, X


def test_filtered_survives_refresh(tmp_path):
    """Append + refresh rebuilds the zone map: filtered probes over the
    refreshed index cover the new rows, as the reference's do."""
    root, rng, X = _filtered_catalog(tmp_path, "ref", 9, 3)
    port = port_cluster(root, num_executors=2, device="cpu")
    t = PortTable(port.catalog, "emb")
    X_new = (X[:80] + 0.02 * rng.normal(size=(80, DIM))).astype(np.float32)
    t.append_vectors(X_new, num_files=1, rows_per_group=80,
                     attributes={"price": np.full(80, 200, np.int64)})
    ref_root = _copy_catalog(root, tmp_path / "ref2")
    rr = port.coordinator.refresh_index("emb", "idx")
    assert rr.inserted == 80
    where = "price >= 150"  # only the appended rows pass
    got = port.coordinator.probe("emb", X_new[:3], 5, strategy="diskann", filter=where)
    ref = ref_cluster(ref_root, num_executors=2)
    ref.coordinator.refresh_index("emb", "idx")
    want = ref.coordinator.probe("emb", X_new[:3], 5, strategy="diskann", filter=where)
    _assert_same(got, want, np.concatenate([X, X_new]), X_new[:3])
    assert all(len(h) == 5 and all("data-00003" in x.file_path for x in h) for h in got.hits)


def test_mask_cache_invalidated_on_refresh(tmp_path):
    """Build, filtered probe, append + refresh, the same filtered probe:
    pre-refresh masks (and their device copies) do not survive, and a
    time-travel probe of the old snapshot re-decodes the old blob."""
    root, rng, X = _filtered_catalog(tmp_path, "one", 77, 2)
    c = port_cluster(root, num_executors=1, device="cpu")  # one executor: caches reused
    t = PortTable(c.catalog, "emb")
    where = "price < 30"
    old_snap = c.catalog.load_table("emb").current_snapshot().snapshot_id
    first = c.coordinator.probe("emb", X[:1], 8, strategy="diskann", filter=where, L=128)
    ex = c.executors[0]
    assert ex._mask_cache and ex._live_cache
    X_new = (X[:60] + 0.01 * rng.normal(size=(60, DIM))).astype(np.float32)
    t.append_vectors(X_new, num_files=1, rows_per_group=80,
                     attributes={"price": np.full(60, 5, np.int64)})
    before = {id(m) for m in ex._mask_cache.values()} | {id(m) for m in ex._live_cache.values()}
    rr = c.coordinator.refresh_index("emb", "idx")
    assert rr.inserted == 60
    assert not ex._mask_cache and not ex._live_cache
    assert not before & set(ex._dev_masks)
    got = c.coordinator.probe("emb", X[:1], 8, strategy="diskann", filter=where, L=128)
    # X_new[0] duplicates X[0] up to 0.01 noise: the refreshed probe finds it
    assert any("data-00002" in h.file_path for h in got.hits[0])
    back = c.coordinator.probe("emb", X[:1], 8, strategy="diskann", filter=where,
                               snapshot_id=old_snap, L=128)
    assert _hit_locs(back.hits[0]) == _hit_locs(first.hits[0])


def test_multi_engine_refresh_both_ways(tmp_path, dataset):
    """An index ``repro`` built and the port refreshed decodes and probes in
    ``repro``; an index the port built and ``repro`` refreshed decodes and
    probes in the port.  Each engine answers the other's refresh with the
    rows the refreshing engine returns itself."""
    X, Q = dataset
    for built_by, refreshed_by in (("ref", "port"), ("port", "ref")):
        root = str(tmp_path / built_by)
        make = {"ref": lambda: ref_cluster(root, num_executors=3),
                "port": lambda: port_cluster(root, num_executors=3, device="cpu")}
        tables = {"ref": RefTable, "port": PortTable}
        configs = {"ref": RefConfig, "port": PortConfig}
        b = make[built_by]()
        table = _ingest(tables[built_by], b, X[:600])
        b.coordinator.create_index("emb", configs[built_by](**CFG))
        table.append_vectors(X[600:700], num_files=1, rows_per_group=ROWS_PER_GROUP)
        table.delete_files([table.current_files()[0].path])
        r = make[refreshed_by]()
        rr = r.coordinator.refresh_index("emb", "idx")
        assert rr.inserted == 100 and rr.tombstoned == 100
        other = make[built_by]()
        own = r.coordinator.probe("emb", Q, 10, strategy="diskann")
        seen = other.coordinator.probe("emb", Q, 10, strategy="diskann")
        assert _locs(seen) == _locs(own), (built_by, refreshed_by)
        _, truth = brute_force_topk(X[100:700], Q, 10, device="cpu")
        got = _row_index(tables[built_by](b.catalog, "emb"), seen.hits)
        assert np.mean([len(set(a) & set(t)) / 10 for a, t in zip(got, truth)]) >= 0.9
