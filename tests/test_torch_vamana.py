"""The reference's ``tests/test_vamana.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU.  The robust-prune property
calls the port's ``_robust_prune`` on torch tensors where the reference
passes jax arrays.

Vamana graph: build invariants, recall, insert, tombstones, serialization.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from _torch_cpu import decode_shard_blob  # noqa: E402
from repro_torch.core.blobs import ShardLocationMap, encode_shard_blob  # noqa: E402
from _torch_cpu import encode, train_pq  # noqa: E402
from repro_torch.core.vamana import VamanaParams, _robust_prune, recall_at_k  # noqa: E402
from _torch_cpu import brute_force_topk, build_vamana  # noqa: E402
from conftest import clustered_vectors  # noqa: E402


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(0)
    X, _ = clustered_vectors(rng, n_clusters=16, per_cluster=100, dim=32)
    g = build_vamana(X, VamanaParams(R=24, L=48), seed=0, passes=2, batch=128)
    Q = X[rng.choice(len(X), 24)] + 0.1 * rng.normal(size=(24, 32)).astype(np.float32)
    return X, g, Q


def test_degree_bound(built):
    X, g, _ = built
    assert g.degrees().max() <= g.params.R


def test_no_self_loops_no_dups(built):
    X, g, _ = built
    for i in range(0, g.n, 97):
        row = g.adjacency[i]
        row = row[row >= 0]
        assert i not in row
        assert len(set(row.tolist())) == len(row)
    # all neighbor ids are valid
    assert g.adjacency[: g.n].max() < g.n


def test_reachability_from_medoid(built):
    """Beam search must reach (almost) every node — graph connectivity."""
    X, g, _ = built
    # BFS from medoid over the directed graph
    seen = np.zeros(g.n, bool)
    frontier = [g.medoid]
    seen[g.medoid] = True
    while frontier:
        nxt = []
        for u in frontier:
            for v in g.adjacency[u]:
                if v >= 0 and not seen[v]:
                    seen[v] = True
                    nxt.append(int(v))
        frontier = nxt
    assert seen.mean() > 0.99


def test_recall_vs_bruteforce(built):
    X, g, Q = built
    _, truth = brute_force_topk(X, Q, 10)
    _, got = g.search(Q, 10)
    assert recall_at_k(got, truth) >= 0.9


def test_pq_search_with_rerank(built):
    X, g, Q = built
    pq = train_pq(X, m=16, nbits=8, iters=6)
    g.attach_pq(pq, encode(pq, X))
    _, truth = brute_force_topk(X, Q, 10)
    _, got = g.search_pq(Q, 10)
    assert recall_at_k(got, truth) >= 0.75


def test_insert_then_search(built):
    X, g, Q = built
    rng = np.random.default_rng(5)
    target = Q[0]
    new = (target[None, :] + 0.01 * rng.normal(size=(20, 32))).astype(np.float32)
    ids = g.insert_batch(new)
    d, i = g.search(target[None, :], 10, L=96)
    overlap = set(i[0].tolist()) & set(ids.tolist())
    assert len(overlap) >= 5  # near-duplicates of the query must surface


def test_tombstones_filtered_but_traversable(built):
    X, g, Q = built
    _, before = g.search(Q[:4], 10)
    doomed = np.unique(before.ravel())[:10]
    g.tombstone(doomed)
    d, after = g.search(Q[:4], 10)
    assert not (set(after.ravel().tolist()) & set(doomed.tolist()))
    assert np.isfinite(d).all()  # still returns k live results
    g.tombstones[:] = False  # restore for other tests


def test_blob_roundtrip(built):
    X, g, Q = built
    n = g.n
    loc = ShardLocationMap(
        ["f/a.vpq", "f/b.vpq"],
        (np.arange(n) % 2).astype(np.uint32),
        (np.arange(n) % 5).astype(np.uint32),
        (np.arange(n) % 777).astype(np.uint32),
    )
    blob = encode_shard_blob(g, loc, include_vectors=True)
    g2, loc2 = decode_shard_blob(blob)
    np.testing.assert_array_equal(g2.adjacency[:n], g.adjacency[:n])
    np.testing.assert_allclose(g2.vectors[:n], g.vectors[:n])
    assert g2.medoid == g.medoid and g2.n == n
    assert loc2.lookup(123) == loc.lookup(123)
    # lean blob + override
    lean = encode_shard_blob(g, loc, include_vectors=False)
    assert len(lean) < len(blob) / 2
    g3, _ = decode_shard_blob(lean, vectors_override=g.vectors[:n])
    np.testing.assert_allclose(g3.vectors[:n], g.vectors[:n])
    # search results identical after roundtrip
    _, i1 = g.search(Q[:4], 5)
    _, i2 = g2.search(Q[:4], 5)
    np.testing.assert_array_equal(i1, i2)


# ---------------------------------------------------------------------------
# robust prune properties
# ---------------------------------------------------------------------------

@settings(max_examples=15, deadline=None)
@given(
    n=st.integers(10, 120),
    d=st.integers(2, 16),
    R=st.integers(2, 16),
    alpha=st.floats(1.0, 2.0),
)
def test_property_robust_prune(n, d, R, alpha):
    rng = np.random.default_rng(n * 13 + d)
    vectors = rng.normal(size=(n, d)).astype(np.float32)
    cand = np.arange(1, n, dtype=np.int32)
    out = _robust_prune(
        torch.as_tensor(vectors),
        torch.as_tensor(vectors[:1]),
        torch.as_tensor(cand[None, :]),
        n,
        R,
        float(alpha),
        "l2",
    )
    out = out.numpy()[0]
    picked = out[out >= 0]
    # degree bound
    assert len(picked) <= R
    # no duplicates
    assert len(set(picked.tolist())) == len(picked)
    # the overall nearest candidate is always kept
    d_p = np.sum((vectors[cand] - vectors[0]) ** 2, axis=1)
    nearest = cand[np.argmin(d_p)]
    assert nearest in picked
    # α-RNG property: every pruned candidate either has an α-witness among
    # the kept neighbors, or the degree budget R was exhausted first
    kept = set(picked.tolist())
    if len(picked) < R:
        for c in cand:
            if int(c) in kept:
                continue
            d_pc = np.sum((vectors[c] - vectors[0]) ** 2)
            ok = any(
                alpha * np.sum((vectors[c] - vectors[p]) ** 2) <= d_pc + 1e-3
                for p in picked
            )
            assert ok, f"candidate {c} pruned without an α-witness"
