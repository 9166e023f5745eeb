"""The slice as a whole: an index built by one package is probed by the other.

- ``repro`` builds an index; ``repro_torch`` (on the CPU) probes the same
  catalog with ``strategy="diskann"`` and returns the same hits: the same
  row locations in the same order, distances within 1e-5 of |q|^2 + |x|^2
  (Stage B scores with the expanded form, and torch and XLA multiply in
  another order, so small distances carry that much absolute error).
- ``repro_torch`` builds an index; ``repro`` probes it with recall@10 of at
  least 0.9 against brute force.
- The port never loads ``jax`` or ``repro``, and its entry points refuse to
  run on a missing card instead of falling back to the CPU.
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
c = make_local_cluster({str(tmp_path)!r}, num_executors=2, device="cpu")
t = LakehouseTable(c.catalog, "emb"); t.create(dim=8); t.append_vectors(X, num_files=2)
c.coordinator.create_index("emb", IndexConfig(name="i", R=8, L=16, pq_m=2, build_passes=1))
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


def test_unported_paths_name_their_roadmap_item(ref_built, dataset):
    root, _ = ref_built
    _, Q = dataset
    port = port_cluster(root, num_executors=3, device="cpu")
    with pytest.raises(RuntimeError, match="ROADMAP Queue 1"):
        port.coordinator.probe_batch("emb", Q[:4], 5, strategy="diskann")
