"""The reference's ``tests/test_centroid.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU.

Centroid index: exact threshold pruning (paper §4.1) + lean-blob serving.

The ``max_distance`` bound makes threshold pruning *exact*: a file whose
centroid distance minus its radius exceeds the threshold can never contain a
match.  The hypothesis test drives that invariant over random corpora.
"""

import numpy as np
from hypothesis import given, settings, strategies as st

import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import tmp_store  # noqa: E402,F401
from repro_torch.core.centroid_index import CentroidIndex, build_centroid_index  # noqa: E402
from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig  # noqa: E402
from conftest import clustered_vectors  # noqa: E402


@settings(max_examples=15, deadline=None)
@given(
    n_files=st.integers(2, 8),
    rows=st.integers(5, 60),
    dim=st.integers(2, 12),
    thresh=st.floats(0.1, 5.0),
    seed=st.integers(0, 1000),
)
def test_property_threshold_pruning_is_exact(n_files, rows, dim, thresh, seed):
    rng = np.random.default_rng(seed)
    files = [rng.normal(size=(rows, dim)).astype(np.float32) * rng.uniform(0.2, 2)
             for _ in range(n_files)]
    cents = np.stack([f.mean(axis=0) for f in files])
    radii = np.asarray(
        [np.sqrt(((f - f.mean(0)) ** 2).sum(1).max()) for f in files], np.float32
    )
    ci = CentroidIndex(cents, radii, [f"f{i}" for i in range(n_files)])
    q = rng.normal(size=dim).astype(np.float32)
    kept = set(ci.probe_threshold(q, thresh))
    # every vector within the threshold must live in a kept file
    for i, f in enumerate(files):
        d = np.sqrt(((f - q) ** 2).sum(1))
        if (d <= thresh).any():
            assert f"f{i}" in kept, (i, d.min(), thresh)


def test_topk_probe_orders_by_centroid_distance(rng):
    X, centers = clustered_vectors(rng, n_clusters=6, per_cluster=50, dim=8)
    cents = centers
    ci = CentroidIndex(
        cents, np.ones(6, np.float32), [f"f{i}" for i in range(6)]
    )
    got = ci.probe_topk(centers[2], 2)
    assert got[0] == "f2"


def test_blob_roundtrip_preserves_pruning(tmp_store, rng):
    from repro_torch.iceberg.catalog import RestCatalog

    cat = RestCatalog(tmp_store)
    t = LakehouseTable(cat, "v")
    t.create(dim=8)
    X, _ = clustered_vectors(rng, n_clusters=4, per_cluster=64, dim=8)
    t.append_vectors(X, num_files=4, rows_per_group=64)
    ci = build_centroid_index(t)
    ci2 = CentroidIndex.from_blob(ci.to_blob())
    q = X[0]
    assert ci.probe_threshold(q, 1.5) == ci2.probe_threshold(q, 1.5)
    assert ci.probe_topk(q, 3) == ci2.probe_topk(q, 3)


def test_lean_blob_end_to_end_probe(tmp_path):
    """include_vectors=False: executors re-fetch vectors from Parquet (§4.3)."""
    from _torch_cpu import make_local_cluster
    from _torch_cpu import brute_force_topk

    rng = np.random.default_rng(0)
    c = make_local_cluster(str(tmp_path), num_executors=2)
    t = LakehouseTable(c.catalog, "emb")
    t.create(dim=16)
    X, _ = clustered_vectors(rng, n_clusters=8, per_cluster=100, dim=16)
    t.append_vectors(X, num_files=4, rows_per_group=128)
    rep = c.coordinator.create_index(
        "emb",
        IndexConfig(name="idx", R=16, L=32, include_vectors=False,
                    partitions_per_shard=2, build_passes=1),
    )
    # lean blobs are much smaller than the data they index
    assert rep.total_bytes < X.nbytes
    Q = X[:8]
    _, truth = brute_force_topk(X, Q, 5)
    pr = c.coordinator.probe("emb", Q, 5, strategy="diskann", L=64)
    vecs_all, locs_all = t.scan_vectors()
    tl = [{(locs_all[i].file_path, locs_all[i].row_group_id, locs_all[i].row_offset)
           for i in row} for row in truth]
    rec = np.mean([
        len({(h.file_path, h.row_group, h.row_offset) for h in hits} & s) / len(s)
        for hits, s in zip(pr.hits, tl)
    ])
    assert rec >= 0.85, rec
