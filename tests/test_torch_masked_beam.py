"""The reference's ``tests/test_masked_beam.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU.

Masked beam search: predicate-aware Vamana traversal.

Graph-level contract of ``VamanaGraph.search_masked`` — traversal expands
*through* masked nodes but admits only mask-passing ones, with the
``(+inf, -1)`` sentinel tail on under-delivery — plus the cluster-level
acceptance: on a shard too large for a masked linear scan
(> EXACT_SCAN_MAX_ROWS), filtered probes route to the ``MaskedBeam`` plan
op and hit exact-oracle-parity recall across a selectivity sweep, and the
fused exact-masked fallback still fires when the beam under-delivers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.vamana import VamanaGraph, VamanaParams  # noqa: E402
from _torch_cpu import build_vamana  # noqa: E402
from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from _torch_cpu import make_local_cluster  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig  # noqa: E402
from repro_torch.runtime.planner import MaskedBeam  # noqa: E402

DIM = 16


# ---------------------------------------------------------------------------
# graph-level unit tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(8, DIM)) * 3.0
    X = np.concatenate(
        [c + rng.normal(size=(150, DIM)) for c in centers]
    ).astype(np.float32)
    g = build_vamana(
        X, VamanaParams(R=16, L=32), passes=2, batch=128, with_pq=True, pq_m=4
    )
    return g, X


def _masked_oracle_ids(X, q, mask, k):
    d = np.sum((X - q) ** 2, axis=1)
    d = np.where(mask[: len(X)], d, np.inf)
    order = np.argsort(d)[:k]
    return order[np.isfinite(d[order])]


def _recall(got_ids, oracle_ids):
    if len(oracle_ids) == 0:
        return 1.0
    return len(set(got_ids[got_ids >= 0]) & set(oracle_ids)) / len(oracle_ids)


@pytest.mark.parametrize("frac", [0.5, 0.1])
def test_search_masked_recall_vs_masked_oracle(graph, frac):
    g, X = graph
    rng = np.random.default_rng(7)
    mask = rng.random(g.n) < frac
    Q = X[rng.choice(len(X), 32)] + 0.05 * rng.normal(size=(32, DIM)).astype(
        np.float32
    )
    dists, ids = g.search_masked(Q, 10, mask, L=64)
    recalls = [
        _recall(ids[i], _masked_oracle_ids(X, Q[i], mask, 10)) for i in range(32)
    ]
    assert np.mean(recalls) >= 0.9, np.mean(recalls)
    # every admitted id passes the mask; sentinel slots are (-1, +inf)
    finite = np.isfinite(dists)
    assert mask[ids[finite]].all()
    assert (ids[~finite] == -1).all()
    # rows come back ascending on the finite prefix
    for row in np.where(finite, dists, np.inf):
        assert (np.diff(row) >= 0).all()


def test_search_masked_zero_admissible_is_all_sentinels(graph):
    g, X = graph
    dists, ids = g.search_masked(X[:4], 10, np.zeros(g.n, bool), L=64)
    assert np.isinf(dists).all() and (ids == -1).all()


def test_search_masked_underdelivery_keeps_sentinel_tail(graph):
    """Fewer admissible nodes than k: finite slots hold only admissible ids
    and the tail stays (+inf, -1) — the contract the executor's fused
    exact-masked fallback keys on."""
    g, X = graph
    mask = np.zeros(g.n, bool)
    admissible = [5, 400, 900]
    mask[admissible] = True
    dists, ids = g.search_masked(X[:8], 10, mask, L=64)
    finite = np.isfinite(dists)
    assert finite.sum(axis=1).max() <= len(admissible)
    assert set(ids[finite].tolist()) <= set(admissible)
    assert (ids[~finite] == -1).all()


def test_search_masked_batch_invariance(graph):
    """Rows are independent: slicing the query block into odd batches must
    not change a single result — the parity pin between sequential probes
    and coalesced fragments."""
    g, X = graph
    rng = np.random.default_rng(9)
    mask = rng.random(g.n) < 0.3
    Q = X[rng.choice(len(X), 21)]
    d64, i64 = g.search_masked(Q, 10, mask, L=64, batch=64)
    d5, i5 = g.search_masked(Q, 10, mask, L=64, batch=5)
    np.testing.assert_array_equal(i64, i5)
    np.testing.assert_array_equal(d64, d5)


def test_search_masked_per_query_masks(graph):
    """mask_idx routes each query to its own mask row."""
    g, X = graph
    rng = np.random.default_rng(11)
    masks = np.stack([rng.random(g.n) < 0.4, rng.random(g.n) < 0.4])
    Q = X[:10]
    idx = np.arange(10) % 2
    _, ids = g.search_masked(Q, 10, masks, mask_idx=idx, L=64)
    for i in range(10):
        got = ids[i][ids[i] >= 0]
        assert masks[idx[i]][got].all()


def test_search_masked_pq_path_reranks_full_precision(graph):
    """ADC traversal + host rerank: admitted ids obey the mask and recall
    stays near the full-precision path."""
    g, X = graph
    rng = np.random.default_rng(13)
    mask = rng.random(g.n) < 0.5
    Q = X[rng.choice(len(X), 16)] + 0.05 * rng.normal(size=(16, DIM)).astype(
        np.float32
    )
    dists, ids = g.search_masked(Q, 10, mask, L=64, use_pq=True)
    finite = np.isfinite(dists)
    assert mask[ids[finite]].all()
    recalls = [
        _recall(ids[i], _masked_oracle_ids(X, Q[i], mask, 10)) for i in range(16)
    ]
    assert np.mean(recalls) >= 0.9, np.mean(recalls)
    # reranked distances are exact L2, not ADC approximations
    safe = np.clip(ids, 0, len(X) - 1)
    exact = np.sum((X[safe] - Q[:, None, :]) ** 2, axis=-1)
    np.testing.assert_allclose(
        np.where(finite, dists, 0.0), np.where(finite, exact, 0.0), rtol=1e-4
    )


def test_search_masked_respects_tombstones_via_mask(graph):
    """The caller folds tombstones into the mask (admissible = predicate
    AND NOT tombstoned) — a tombstoned id must never be admitted."""
    g, X = graph
    mask = np.ones(g.n, bool)
    dead = np.arange(0, g.n, 3)
    mask[dead] = False
    _, ids = g.search_masked(X[:8], 10, mask, L=64)
    got = ids[ids >= 0]
    assert not np.isin(got, dead).any()


# ---------------------------------------------------------------------------
# cluster-level: the MaskedBeam plan op on a big shard
# ---------------------------------------------------------------------------


def _locs(hits):
    return [(h.file_path, h.row_group, h.row_offset) for h in hits]


N_BIG = 5000  # > planner.EXACT_SCAN_MAX_ROWS: masked linear scans are out


@pytest.fixture(scope="module")
def bigshard_cluster(tmp_path_factory):
    """ONE shard above EXACT_SCAN_MAX_ROWS — the regime the MaskedBeam band
    exists for — with a uniform int attribute for selectivity control."""
    rng = np.random.default_rng(17)
    c = make_local_cluster(str(tmp_path_factory.mktemp("mbeam")), num_executors=2)
    t = LakehouseTable(c.catalog, "emb")
    t.create(dim=DIM)
    centers = rng.normal(size=(10, DIM)) * 3.0
    X = np.concatenate(
        [ctr + rng.normal(size=(N_BIG // 10, DIM)) for ctr in centers]
    ).astype(np.float32)
    price = rng.integers(0, 100, size=len(X)).astype(np.int64)
    t.append_vectors(X, num_files=4, rows_per_group=250, attributes={"price": price})
    c.coordinator.create_index(
        "emb",
        IndexConfig(
            name="idx", num_shards=1, R=16, L=48,
            partitions_per_shard=4, build_passes=1,
        ),
    )
    return c, t, X, price


def _queries(X, n, seed):
    rng = np.random.default_rng(seed)
    picks = X[rng.choice(len(X), n)]
    return (picks + 0.05 * rng.normal(size=picks.shape)).astype(np.float32)


# (predicate, expected true fraction, expected to stay MaskedBeam at the
# executor): ~0.01 collapses to the exact scan in resolve — its passing set
# fits planner.SMALL_MATCH — but the *plan* is still mbeam-band evidence
SWEEP = [
    ("price < 50", 0.5, True),
    ("price < 10", 0.1, True),
    ("price < 1", 0.01, False),
]


@pytest.mark.parametrize("where,frac,stays_mbeam", SWEEP, ids=["0.5", "0.1", "0.01"])
def test_masked_beam_selectivity_sweep(bigshard_cluster, where, frac, stays_mbeam):
    c, t, X, price = bigshard_cluster
    true_frac = float((price < int(where.split("<")[1])).mean())
    assert true_frac == pytest.approx(frac, abs=0.05)
    Q = _queries(X, 16, seed=int(frac * 100))
    oracle = c.coordinator.probe_batch("emb", Q, 10, strategy="scan", filter=where)
    got = c.coordinator.probe_batch(
        "emb", Q, 10, strategy="diskann", filter=where, L=256
    )
    # the big shard bands to MaskedBeam at every swept selectivity
    assert "mbeam" in got.filter_plan, got.filter_plan
    for row in got.plan.ops:
        assert all(isinstance(op, MaskedBeam) for op in row.values())
    recalls = [
        len(set(_locs(a)) & set(_locs(b))) / max(len(_locs(a)), 1)
        for a, b in zip(oracle.hits, got.hits)
    ]
    assert np.mean(recalls) >= 0.95, (where, np.mean(recalls))
    if stays_mbeam:
        # rows were answered by the traversal, not a scan; the beam pass
        # itself is not a masked-kernel dispatch — only fused fallbacks are
        assert got.masked_beam_rows == len(Q)
        assert got.masked_beam_fallbacks <= len(Q)
        assert got.kernel_dispatches <= got.probe_fragments
    else:
        # resolve collapsed the tiny passing set to the exact scan: full
        # parity, and no traversal rows to account
        assert got.masked_beam_rows == 0
        for a, b in zip(oracle.hits, got.hits):
            assert _locs(a) == _locs(b)


def test_masked_beam_probe_matches_batch(bigshard_cluster):
    """Sequential single probes and the coalesced batch interpret the same
    resolved op — identical hits."""
    c, t, X, price = bigshard_cluster
    Q = _queries(X, 6, seed=23)
    br = c.coordinator.probe_batch(
        "emb", Q, 10, strategy="diskann", filter="price < 40", L=256
    )
    assert br.masked_beam_rows == len(Q)
    for i in range(len(Q)):
        pr = c.coordinator.probe(
            "emb", Q[i], 10, strategy="diskann", filter="price < 40", L=256
        )
        assert pr.masked_beam_rows == 1
        assert _locs(pr.hits[0]) == _locs(br.hits[i])


def test_masked_beam_heterogeneous_batch_shares_width_pools(bigshard_cluster):
    """Distinct predicates in one fragment pool by planner width; hits still
    match sequential probes."""
    c, t, X, price = bigshard_cluster
    Q = _queries(X, 4, seed=29)
    filters = ["price < 60", "price < 45", "price < 60", "price < 8"]
    br = c.coordinator.probe_batch(
        "emb", Q, 10, strategy="diskann", filter=filters, L=256
    )
    assert br.masked_beam_rows == len(Q)
    for i in range(len(Q)):
        pr = c.coordinator.probe(
            "emb", Q[i], 10, strategy="diskann", filter=filters[i], L=256
        )
        assert _locs(pr.hits[0]) == _locs(br.hits[i])


def test_masked_beam_underdelivery_fallback_fires(bigshard_cluster, monkeypatch):
    """Regression: when the widened beam under-delivers, every starved row is
    re-answered by the fused exact-masked fallback — results stay
    oracle-exact and the fallback is visible in the report accounting."""
    c, t, X, price = bigshard_cluster
    Q = _queries(X, 8, seed=31)
    where = "price < 30"

    def _starved(self, queries, k, unique_masks, mask_idx=None, L=None,
                 batch=64, use_pq=False):
        q = queries.shape[0]
        return (
            np.full((q, int(k)), np.inf, np.float32),
            np.full((q, int(k)), -1, np.int64),
        )

    monkeypatch.setattr(VamanaGraph, "search_masked", _starved)
    br = c.coordinator.probe_batch(
        "emb", Q, 10, strategy="diskann", filter=where, L=256
    )
    assert br.masked_beam_rows == len(Q)
    assert br.masked_beam_fallbacks == len(Q)
    # ONE fused exact-masked dispatch per fragment, not one per starved row
    assert br.kernel_dispatches == br.probe_fragments == 1
    monkeypatch.undo()
    oracle = c.coordinator.probe_batch("emb", Q, 10, strategy="scan", filter=where)
    for a, b in zip(oracle.hits, br.hits):
        assert _locs(a) == _locs(b)  # the fallback is exact

    # single-probe path fires the same fallback
    monkeypatch.setattr(VamanaGraph, "search_masked", _starved)
    pr = c.coordinator.probe(
        "emb", Q[0], 10, strategy="diskann", filter=where, L=256
    )
    assert pr.masked_beam_fallbacks == 1
    monkeypatch.undo()
    assert _locs(pr.hits[0]) == _locs(oracle.hits[0])


def test_masked_beam_above_mask_band_stays_postfilter(bigshard_cluster):
    """Selectivity above MASK_MAX_FRAC on the big shard keeps the
    over-fetched postfilter beam — MaskedBeam's widening would be wasted on
    a predicate nearly everything passes."""
    c, t, X, price = bigshard_cluster
    Q = _queries(X, 4, seed=37)
    br = c.coordinator.probe_batch(
        "emb", Q, 10, strategy="diskann", filter="price < 95", L=256
    )
    assert "mbeam" not in br.filter_plan
    assert "postfilter" in br.filter_plan
    assert br.masked_beam_rows == 0
