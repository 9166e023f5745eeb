"""repro_torch core (k-means, PQ, Vamana) against the JAX reference on CPU.

Search is held at id equality on the reference's own graph arrays, carried
into the port with ``graph_from_arrays``.  The build is held by recall and
degree statistics.  The vectorized reverse-edge scatter and the overflow
re-prune are held to the reference's loops exactly.  Tolerances:
centroids 1e-4 absolute (the update sums in another order); PQ codes equal
wherever the best-vs-second codeword margin is at least 1e-5; direct-form
distances 1e-5 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from conftest import clustered_vectors  # noqa: E402
from repro.core import kmeans as jkmeans  # noqa: E402
from repro.core import pq as jpq  # noqa: E402
from repro.core import vamana as jv  # noqa: E402
from repro_torch.core import kmeans as tkmeans  # noqa: E402
from repro_torch.core import pq as tpq  # noqa: E402
from repro_torch.core import vamana as tv  # noqa: E402

CPU = "cpu"
PARAMS = dict(R=12, L=24, alpha=1.2)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X, _ = clustered_vectors(rng, n_clusters=8, per_cluster=150, dim=16)
    Q = X[rng.choice(len(X), 40, replace=False)] + 0.05 * rng.normal(size=(40, 16)).astype(np.float32)
    return X, Q


@pytest.fixture(scope="module")
def ref_graph(data):
    """A reference-built graph with PQ codes (one refinement pass)."""
    X, _ = data
    return jv.build_vamana(
        X, jv.VamanaParams(**PARAMS), passes=1, batch=64, seed=3, with_pq=True, pq_m=4
    )


def _port_of(g):
    return tv.graph_from_arrays(
        g.vectors, g.adjacency, g.n, g.medoid, tv.VamanaParams(**PARAMS),
        pq_codebook=g.pq.codebook if g.pq is not None else None,
        pq_codes=g.pq_codes, tombstones=g.tombstones, device=CPU,
    )


# -- k-means / PQ --------------------------------------------------------------

def test_train_kmeans_matches_reference(data):
    X, _ = data
    want, w_inertia = jkmeans.train_kmeans(X, 8, iters=10, seed=5)
    got, g_inertia = tkmeans.train_kmeans(X, 8, iters=10, seed=5, device=CPU)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert abs(g_inertia - w_inertia) <= 1e-4 * abs(w_inertia)


def test_assign_matches_reference(data):
    X, _ = data
    cents, _ = jkmeans.train_kmeans(X, 8, iters=5, seed=1)
    np.testing.assert_array_equal(tkmeans.assign(X, cents, device=CPU), jkmeans.assign(X, cents))


def test_pq_codebook_and_codes_match_reference(data):
    X, _ = data
    want = jpq.train_pq(X, m=4, nbits=5, iters=6, seed=2)
    got = tpq.train_pq(X, m=4, nbits=5, iters=6, seed=2, device=CPU)
    np.testing.assert_allclose(got.codebook, want.codebook, atol=1e-4)
    codes_ref = jpq.encode(want, X)
    codes_port = tpq.encode(tpq.PQCodebook(want.codebook.copy()), X, batch=500, device=CPU)
    # margin between the best and second-best codeword per (row, subspace)
    sub = X.reshape(len(X), 4, -1)
    d = ((sub[:, :, None, :] - want.codebook[None]) ** 2).sum(-1)
    two = np.sort(d, axis=-1)[..., :2]
    clear = (two[..., 1] - two[..., 0]) >= 1e-5
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(codes_port[clear], codes_ref[clear])
    np.testing.assert_array_equal(
        tpq.decode(got, codes_port[:10]).shape, (10, X.shape[1])
    )


@pytest.mark.parametrize("sample", [None, "default"])
def test_reconstruction_error_matches_reference(sample):
    """The same seeded codebook and 6,000 vectors (above the default sample
    of 4,096, so that case subsamples) through both packages."""
    rng = np.random.default_rng(11)
    X, _ = clustered_vectors(rng, n_clusters=12, per_cluster=500, dim=16)
    book = jpq.train_pq(X, m=4, nbits=6, iters=4, seed=3)
    kw = {} if sample == "default" else {"sample": sample}
    want = jpq.reconstruction_error(book, X, **kw)
    got = tpq.reconstruction_error(tpq.PQCodebook(book.codebook.copy()), X, **kw, device=CPU)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_build_luts_match_reference(data, ref_graph):
    _, Q = data
    want = np.asarray(jpq.build_luts(ref_graph.pq, Q))
    got = tpq.build_luts(tpq.PQCodebook(ref_graph.pq.codebook.copy()), Q, device=CPU).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- search on the reference's graph arrays -------------------------------------

def test_beam_search_equal_ids(data, ref_graph):
    _, Q = data
    g = ref_graph
    L, max_iters = 24, int(1.3 * 24) + 8
    want = jv._beam_search(
        jnp.asarray(g.vectors), jnp.asarray(g.adjacency), jnp.int32(g.n),
        jnp.int32(g.medoid), jnp.asarray(Q), L, max_iters, "l2", False,
    )
    got = tv._beam_search(
        torch.as_tensor(g.vectors), torch.as_tensor(g.adjacency.astype(np.int64)), g.n,
        g.medoid, torch.as_tensor(Q), L, max_iters, "l2", False,
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))  # pool ids
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # visited ids
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)


def test_beam_search_pq_equal_ids(data, ref_graph):
    _, Q = data
    g = ref_graph
    luts = np.array(jpq.build_luts(g.pq, Q))
    L, max_iters = 24, int(1.3 * 24) + 8
    want = jv._beam_search(
        jnp.asarray(g.pq_codes.astype(np.int32)), jnp.asarray(g.adjacency), jnp.int32(g.n),
        jnp.int32(g.medoid), jnp.asarray(luts), L, max_iters, "l2", True,
    )
    got = tv._beam_search(
        torch.as_tensor(g.pq_codes.astype(np.int64)), torch.as_tensor(g.adjacency.astype(np.int64)),
        g.n, g.medoid, torch.as_tensor(luts), L, max_iters, "l2", True,
    )
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("alpha", [1.0, 1.2])
def test_robust_prune_equal_ids(data, ref_graph, alpha):
    X, Q = data
    g = ref_graph
    rng = np.random.default_rng(4)
    cap = g.vectors.shape[0]
    cand = rng.integers(0, g.n, size=(len(Q), 40)).astype(np.int32)
    cand[:, 30:] = cand[:, :10]  # duplicates
    cand[:5, -3:] = cap  # invalid slots
    want = jv._robust_prune(
        jnp.asarray(g.vectors), jnp.asarray(Q), jnp.asarray(cand), jnp.int32(g.n), 12, alpha, "l2"
    )
    got = tv._robust_prune(
        torch.as_tensor(g.vectors), torch.as_tensor(Q), torch.as_tensor(cand), g.n, 12, alpha, "l2"
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pq", [False, True])
def test_graph_search_equal_ids(data, ref_graph, pq):
    _, Q = data
    port = _port_of(ref_graph)
    fn = "search_pq" if pq else "search"
    wd, wi = getattr(ref_graph, fn)(Q, 10)
    gd, gi = getattr(port, fn)(Q, 10)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-6)


def test_tombstones_filter_like_reference(data, ref_graph):
    _, Q = data
    port = _port_of(ref_graph)
    _, ids = port.search_pq(Q, 5)
    port.tombstone(ids[:, 0])
    _, ids2 = port.search_pq(Q, 5)
    assert not np.isin(ids2, ids[:, 0]).any()


# -- build: reverse edges, re-prune, recall -------------------------------------

def _batch_state(g, seed=7):
    """Pick a batch of sources and their pruned neighbour rows, as the
    build's inner loop produces them."""
    rng = np.random.default_rng(seed)
    sel = rng.choice(g.n, size=48, replace=False)
    cap = g.vectors.shape[0]
    L, max_iters = 24, int(1.3 * 24) + 8
    pool, _, vis, _ = jv._beam_search(
        jnp.asarray(g.vectors), jnp.asarray(g.adjacency), jnp.int32(g.n),
        jnp.int32(g.medoid), jnp.asarray(g.vectors[sel]), L, max_iters, "l2", False,
    )
    cand = np.concatenate([np.asarray(pool), np.asarray(vis)], axis=1)
    cand = np.where(cand == sel[:, None], cap, cand)
    nbrs = np.asarray(jv._robust_prune(
        jnp.asarray(g.vectors), jnp.asarray(g.vectors[sel]), jnp.asarray(cand),
        jnp.int32(g.n), 12, 1.2, "l2",
    ))
    return sel, nbrs


def _fresh_ref_graph(X, passes):
    return jv.build_vamana(X, jv.VamanaParams(**PARAMS), passes=passes, batch=64, seed=11)


@pytest.mark.parametrize("passes", [0, 1])
def test_reverse_edge_scatter_equals_reference_loop(data, passes):
    """passes=0: every row full from the random init (all edges overflow or
    are present); passes=1: pruned rows with free suffixes."""
    X, _ = data
    g = _fresh_ref_graph(X, passes)
    sel, nbrs = _batch_state(g)
    g.adjacency[sel] = nbrs
    before = g.adjacency.copy()
    captured = {}
    g._reprune_nodes = lambda overflow: captured.update(overflow)
    g._add_reverse_edges(sel, nbrs)

    adj = torch.as_tensor(before.astype(np.int64))
    tgt, src = tv._reverse_edge_scatter(adj, torch.as_tensor(sel), torch.as_tensor(nbrs))
    np.testing.assert_array_equal(adj.numpy(), g.adjacency)
    overflow = {}
    for t, s in zip(tgt.tolist(), src.tolist()):  # the reference's dict form
        overflow.setdefault(t, []).append(s)
    assert overflow == captured
    if passes == 0:
        assert captured


def test_reprune_equals_reference(data):
    X, _ = data
    g = _fresh_ref_graph(X, 1)
    sel, nbrs = _batch_state(g, seed=8)
    g.adjacency[sel] = nbrs
    adj = torch.as_tensor(g.adjacency.astype(np.int64))
    captured = {}
    real = g._reprune_nodes
    g._reprune_nodes = lambda overflow: (captured.update(overflow), real(overflow))
    g._add_reverse_edges(sel, nbrs)
    tv._link_reverse(torch.as_tensor(g.vectors), adj, torch.as_tensor(sel),
                     torch.as_tensor(nbrs.astype(np.int64)), g.n, tv.VamanaParams(**PARAMS))
    assert captured, "the batch should overflow some rows"
    np.testing.assert_array_equal(adj.numpy(), g.adjacency)


def test_port_build_recall_and_degrees(data):
    X, Q = data
    ref = jv.build_vamana(X, jv.VamanaParams(**PARAMS), passes=2, batch=64, seed=1)
    port = tv.build_vamana(X, tv.VamanaParams(**PARAMS), passes=2, batch=64, seed=1, device=CPU)
    _, truth = tv.brute_force_topk(X, Q, 10, device=CPU)
    r_ref = jv.recall_at_k(ref.search(Q, 10)[1], truth)
    r_port = tv.recall_at_k(port.search(Q, 10)[1], truth)
    assert r_port >= r_ref - 0.02
    deg = port.degrees()
    assert deg.max() <= PARAMS["R"] and deg.min() >= 1
    assert abs(deg.mean() - ref.degrees().mean()) <= 0.1 * ref.degrees().mean()


def test_build_rejects_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        tv.build_vamana(np.zeros((4, 2), np.float32), tv.VamanaParams(R=2, L=4))


@pytest.mark.parametrize("pq", [False, True])
def test_cuda_search_matches_cpu_search(data, ref_graph, pq):
    """On the card the beam search replays captured CUDA graphs and the
    rerank runs the gather_rerank kernel; the answers are the CPU path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, Q = data
    cpu = _port_of(ref_graph)
    gpu = tv.graph_from_arrays(
        ref_graph.vectors, ref_graph.adjacency, ref_graph.n, ref_graph.medoid,
        tv.VamanaParams(**PARAMS), pq_codebook=ref_graph.pq.codebook,
        pq_codes=ref_graph.pq_codes, device="cuda",
    )
    fn = "search_pq" if pq else "search"
    for _ in range(2):  # the second call replays the cached graphs
        gd, gi = getattr(gpu, fn)(Q, 10)
        wd, wi = getattr(cpu, fn)(Q, 10)
        assert (gi == wi).mean() > 0.99
        np.testing.assert_allclose(np.sort(gd, 1), np.sort(wd, 1), rtol=1e-4, atol=1e-4)


# -- search_masked ---------------------------------------------------------------

def _mask_rows(n, seed):
    """Three admissibility rows over graph ids (tight, medium, wide) with a
    few tombstones folded in, as the executor folds them."""
    rng = np.random.default_rng(seed)
    rows = np.stack([rng.random(n) < f for f in (0.05, 0.3, 0.8)])
    dead = rng.random(n) < 0.05
    return rows & ~dead[None, :], dead


@pytest.mark.parametrize("pq", [False, True])
@pytest.mark.parametrize("width,L", [(10, 24), (40, 16), (120, 24)])
def test_search_masked_equal_ids(data, ref_graph, pq, width, L):
    """Per-query mask rows through the dedup'd form; widths below, near and
    above L (L is not floored at the admit target)."""
    _, Q = data
    port = _port_of(ref_graph)
    rows, _ = _mask_rows(ref_graph.n, 5)
    idx = np.arange(len(Q)) % 3
    wd, wi = ref_graph.search_masked(Q, width, rows, idx, L=L, use_pq=pq)
    gd, gi = port.search_masked(Q, width, rows, idx, L=L, use_pq=pq)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5, atol=1e-6)
    adm = rows[idx[:, None], np.clip(gi, 0, ref_graph.n - 1)] | (gi < 0)
    assert adm.all()


def test_search_masked_tombstones_and_shared_row(data, ref_graph):
    """One shared row (mask_idx None) with tombstones folded in: no
    tombstoned id is admitted, and the ids are the reference's."""
    _, Q = data
    rows, dead = _mask_rows(ref_graph.n, 9)
    port = _port_of(ref_graph)
    wd, wi = ref_graph.search_masked(Q, 20, rows[2], L=24)
    gd, gi = port.search_masked(Q, 20, torch.as_tensor(rows[2]), L=24)
    np.testing.assert_array_equal(gi, wi)
    assert not np.isin(gi[gi >= 0], np.flatnonzero(dead)).any()


def test_graph_from_arrays_round_trips_a_refreshed_graph(data):
    """A reference graph grown past its capacity by ``insert_batch`` and
    tombstoned carries into the port with its quantized device copies equal
    to the reference's (stored values and scale) and the same search."""
    from repro.kernels import device_cache as jcache

    X, Q = data
    g = jv.build_vamana(X[:900], jv.VamanaParams(**PARAMS), passes=1, batch=64, seed=5)
    g.insert_batch(X[900:])  # 900 + the rest passes the 1,024-row capacity
    g.tombstone(np.arange(0, g.n, 7))
    port = _port_of(g)
    assert port.vectors.shape == g.vectors.shape and port.n == g.n
    for dtype in ("bf16", "int8"):
        want, w_scale = jcache.device_vectors_quant(g, dtype)
        got, g_scale = tv.device_cache.device_vectors_quant(port, dtype)
        assert g_scale == w_scale
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    np.testing.assert_array_equal(port.search(Q, 10)[1], g.search(Q, 10)[1])
