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
"""

import os
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


def _row_index(table, hits):
    starts, base = {}, 0
    for f in table.current_files():
        starts[f.path] = base
        base += f.record_count
    return np.array(
        [[starts[h.file_path] + h.row_group * ROWS_PER_GROUP + h.row_offset for h in hs] for hs in hits]
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


def test_unported_paths_name_their_roadmap_item(tmp_path, dataset):
    """The refresh is not ported yet: it raises naming its ROADMAP item
    (its own copy of the catalog, so the shared fixture stays unrefreshed)."""
    X, _ = dataset
    root = str(tmp_path)
    ref = ref_cluster(root, num_executors=3)
    table = _ingest(RefTable, ref, X[:600])
    ref.coordinator.create_index("emb", RefConfig(**CFG))
    table.append_vectors(X[600:700], num_files=1, rows_per_group=ROWS_PER_GROUP)
    port = port_cluster(root, num_executors=3, device="cpu")
    with pytest.raises(RuntimeError, match="ROADMAP Queue 1"):
        port.coordinator.refresh_index("emb", "idx")


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


def test_quantized_scan_dtype_raises_naming_its_item(mixed):
    """No f32 scan in the quantized kernels' place: the executors'
    NotImplementedError reaches the caller through the scheduler."""
    _, port, X = mixed
    with pytest.raises(RuntimeError, match="NotImplementedError.*Queue 1, item 7"):
        port.coordinator.probe("emb", X[:2], 10, strategy="diskann", filter="price < 2",
                               scan_dtype="int8")


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
