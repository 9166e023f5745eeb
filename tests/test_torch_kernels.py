"""repro_torch kernel layer against the JAX reference.

The plain PyTorch versions (``repro_torch.kernels.ref``, the CPU path of
every wrapper) are held against ``repro.kernels.ref`` on the same numpy
inputs, and ``gather_rerank`` also against the reference's Pallas kernel in
interpret mode.  Tolerances:

- direct-form distances (``gather_rerank``): 1e-5 relative — both sides sum
  the same squared differences, only the summation order may differ;
- expanded-form distances (``exact_distances`` against the reference's
  jnp oracle and its Pallas kernel, ``kmeans_assign``): 1e-5 of
  |q|^2 + |x|^2, the magnitude the form cancels from (torch and XLA run
  different matrix-product routines);
- ``gather_rerank`` against the Pallas kernel, which scores through the
  expanded form: the reference test suite's own rtol 2e-4 / atol 2e-3;
- ids equal throughout (inputs are random, so no exact ties).

The ``test_cuda_*`` cases launch the CUDA kernels and skip (inside the
``cuda`` fixture) where there is no card; on the card select them with
``-k cuda``.  The reference is imported inside the ``jx`` fixture, so the
card-only cases run where JAX is not installed.  ``chip_smoke.py`` runs
the same comparisons at the main-path shapes.

The edge inputs of the redesigned ``gather_rerank`` and ``kmeans_assign``
(pool sizes around one warp's sort and past it, k of 1, P and P + 5,
sentinel rows, tied slots, -0.0 under ip; a winning centroid duplicated
at indices that different lanes scan, ragged K, N and D) run twice: here
through the plain versions against the reference, at the tolerances
above, and on the card through the kernels against the plain versions.
Where the inputs are small integers every sum is exact, and the card
holds the kernels to the plain versions' bits.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import rerank as trerank  # noqa: E402
from repro_torch.kernels.kmeans_assign import kmeans_assign as kmeans_kernel  # noqa: E402


def _np(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _expanded_atol(q, x):
    return 1e-5 * (float(np.max(np.sum(q * q, 1))) + float(np.max(np.sum(x * x, 1))))


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, repro.kernels.ops, repro.kernels.ref), or a skip where
    JAX is absent."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jops, jref


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# -- plain versions vs repro.kernels.ref --------------------------------------

# (33, 130, 70), (1, 129, 33) and (65, 257, 130) cross the kernel tiles'
# edges: ragged rows past 32 / 64 / 128, D past 16-feature chunks and
# D % 4 != 0 (the 4-byte copy path)
@pytest.mark.parametrize("q,n,d", [(1, 1, 1), (5, 37, 16), (17, 130, 24), (33, 130, 70),
                                   (1, 129, 33), (65, 257, 130)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_exact_distances_match_reference(jx, q, n, d, metric, backend):
    """Against the reference's jnp oracle and its Pallas kernel (interpret
    mode); both compute the expanded form, so the expanded-form tolerance
    holds for each."""
    jnp, jops, jref = jx
    Q, X = _np(q, d, 1), _np(n, d, 2)
    want = np.asarray(jops.exact_distances(jnp.asarray(Q), jnp.asarray(X), metric=metric,
                                           backend=backend))
    got = ops.exact_distances(_t(Q), _t(X), metric=metric).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=_expanded_atol(Q, X))


def test_exact_topk_matches_reference(jx):
    jnp, jops, jref = jx
    Q, X = _np(6, 16, 3), _np(200, 16, 4)
    wd, wi = jops.exact_topk(jnp.asarray(Q), jnp.asarray(X), 7, backend="ref")
    gd, gi = ops.exact_topk(_t(Q), _t(X), 7)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=_expanded_atol(Q, X))


def test_build_pq_luts_match_reference(jx):
    jnp, jops, jref = jx
    Q = _np(5, 16, 5)
    book = _np(4 * 8, 4, 6).reshape(4, 8, 4)
    for metric in ("l2", "ip"):
        want = np.asarray(jref.build_pq_luts(jnp.asarray(Q), jnp.asarray(book), metric))
        got = ref.build_pq_luts(_t(Q), _t(book), metric).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,k,d", [(1, 1, 1), (300, 16, 32), (257, 256, 4), (64, 3, 70)])
def test_kmeans_assign_matches_reference(jx, n, k, d):
    jnp, jops, jref = jx
    X, C = _np(n, d, n), _np(k, d, k + 1)
    wi, wd = jref.kmeans_assign(jnp.asarray(X), jnp.asarray(C))
    gi, gd = ops.kmeans_assign(_t(X), _t(C))
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=_expanded_atol(X, C))


def test_kmeans_assign_ties_go_to_lowest_index():
    X = np.zeros((3, 4), np.float32)
    C = np.ones((5, 4), np.float32)  # every centroid equidistant
    gi, _ = ops.kmeans_assign(_t(X), _t(C))
    assert gi.tolist() == [0, 0, 0]


# -- gather_rerank: plain version vs reference oracle and Pallas kernel -------

def _pool(q, n, p, seed):
    rng = np.random.default_rng(seed)
    if p <= n:
        return np.stack([rng.choice(n, size=p, replace=False) for _ in range(q)]).astype(np.int32)
    return rng.integers(0, n, size=(q, p)).astype(np.int32)


def _assert_rerank_equal(got, want, rtol, atol):
    gd, gi = (np.asarray(a) for a in got)
    wd, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi.astype(np.int64), wi.astype(np.int64))
    assert (np.isinf(gd) == np.isinf(wd)).all()
    np.testing.assert_allclose(
        np.where(np.isinf(gd), 0.0, gd), np.where(np.isinf(wd), 0.0, wd), rtol=rtol, atol=atol
    )


@pytest.mark.parametrize("q,n,p,d", [(1, 1, 1, 1), (3, 90, 7, 16), (9, 300, 33, 24), (5, 130, 130, 100)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gather_rerank_matches_reference(jx, q, n, p, d, metric):
    jnp, jops, jref = jx
    Q, X = _np(q, d, q), _np(n, d, n + 1)
    pids = _pool(q, n, p, q * 11 + n)
    k = min(5, p)
    want = jops.gather_rerank(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(pids), k,
                              metric=metric, backend="ref")
    got = ops.gather_rerank(_t(Q), _t(X), _t(pids), k, metric=metric)
    _assert_rerank_equal(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gather_rerank_matches_pallas_interpret(jx, metric):
    jnp, jops, jref = jx
    Q, X = _np(6, 32, 1), _np(200, 32, 2)
    pids = _pool(6, 200, 24, 42)
    pids[2, 5:] = -1  # one mostly-empty pool
    want = jops.gather_rerank(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(pids), 10,
                              metric=metric, backend="pallas")
    got = ops.gather_rerank(_t(Q), _t(X), _t(pids), 10, metric=metric)
    _assert_rerank_equal(got, want, rtol=2e-4, atol=2e-3)


def _edge_pools():
    """(name, Q, X, pids, k): the edge cases of tests/test_kernels.py."""
    rng = np.random.default_rng(9)
    sent = np.full((4, 8), -1, np.int32)
    sent[0, :3] = [5, 7, 50]  # 50 == N: out of range
    sent[1, 0] = 999
    dup = rng.integers(0, 40, size=(3, 12)).astype(np.int32)
    dup[:, 6:] = dup[:, :6]
    return [
        ("sentinels_and_ids_ge_n", _np(4, 16, 3), _np(50, 16, 4), sent, 8),
        ("k_exceeds_pool", _np(2, 8, 5), _np(60, 8, 6), np.array([[3, 9, 41], [0, 59, 17]], np.int32), 10),
        ("k_exceeds_n", _np(2, 8, 5), _np(4, 8, 6), np.array([[0, 1, 2, 3, -1], [3, 2, -1, -1, 1]], np.int32), 9),
        ("duplicate_ids", _np(3, 16, 7), _np(40, 16, 8), dup, 5),
    ]


@pytest.mark.parametrize("case", _edge_pools(), ids=lambda c: c[0])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gather_rerank_edge_cases(jx, case, metric):
    jnp, jops, jref = jx
    _, Q, X, pids, k = case
    want = jops.gather_rerank(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(pids), k,
                              metric=metric, backend="ref")
    got = ops.gather_rerank(_t(Q), _t(X), _t(pids), k, metric=metric)
    _assert_rerank_equal(got, want, rtol=1e-5, atol=1e-6)
    gd, gi = (a.numpy() for a in got)
    assert gd.shape == (Q.shape[0], k)
    assert ((gi == -1) == np.isinf(gd)).all()
    assert (np.diff(np.where(np.isinf(gd), 1e30, gd), axis=1) >= 0).all()


# -- edge inputs of the redesigned kernels: plain versions vs reference -------

def _ints(shape, rng, lo=-3, hi=4):
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _rerank_edges():
    """(name, Q, X, pids, k, exact): pool sizes around one warp's sort
    (32 M keys, M <= 16) and past it, k of 1, P and P + 5, a sentinel row,
    tied slots and -0.0 under ip; ``exact`` where every sum is exact."""
    rng = np.random.default_rng(16)
    out = []
    for name, n, p, k in [("k1", 300, 40, 1), ("k_eq_p", 300, 40, 40), ("k_p_plus_5", 300, 40, 45),
                          ("p1", 50, 1, 3), ("p255", 1000, 255, 40), ("p256", 1000, 256, 40),
                          ("p257", 1000, 257, 40), ("p600", 2000, 600, 40), ("p600_k605", 2000, 600, 605)]:
        pids = _pool(4, n, p, p + k)
        pids[1, ::7] = -1  # sentinels between live slots
        out.append((name, _np(4, 24, p), _np(n, 24, n), pids, k, False))
    pids = _pool(3, 200, 50, 5)
    pids[1] = -1  # a row with no live slot
    pids[2, 10:] = 200  # ids >= N
    out.append(("sentinel_row", _np(3, 16, 6), _np(200, 16, 7), pids, 20, False))
    # one row id at two slots, and two equal rows at slots 2 and 5 (the
    # higher id first): a tie keeps the lower slot first
    X = _ints((30, 8), rng)
    X[17] = X[4]
    pids = rng.permutation(30)[:12].astype(np.int32)[None].repeat(2, 0)
    pids[:, 2], pids[:, 5], pids[:, 8], pids[:, 9] = 17, 4, 11, 11
    out.append(("tied_slots", _ints((2, 8), rng), X, pids, 12, True))
    # zero cross products: ip scores -0.0, tied by slot
    X = _ints((40, 8), rng)
    Q = np.zeros((2, 8), np.float32)
    Q[:, 0] = [1, -2]
    X[::3, 0] = 0
    out.append(("neg_zero_ip", Q, X, rng.permutation(40)[:30].astype(np.int32)[None].repeat(2, 0), 30, True))
    return out


def _kmeans_edges():
    """(name, X, C, exact): a winning centroid duplicated at indices that
    different lanes (D < 64), butterfly batches or shared-memory tiles
    (D >= 64; a tile holds 95 centroids at D = 128) scan, ragged K, N past
    a block's points, D on both sides of 64."""
    rng = np.random.default_rng(17)
    out = []
    for d, k, i, j in [(4, 256, 3, 200), (128, 16, 3, 12), (128, 40, 3, 35), (128, 128, 3, 100),
                       (128, 300, 90, 290)]:
        C = _ints((k, d), rng, -20, 21)
        C[j] = C[i]
        X = (C[i] + _ints((333, d), rng, -1, 2)).astype(np.float32)
        out.append((f"dup_winner_d{d}_k{k}", X, C, True))
    for k in (1, 7, 255, 256, 257):
        out.append((f"d4_k{k}", _np(1001, 4, k), _np(k, 4, k + 1), False))
    for d in (1, 4, 5, 33, 64, 128, 130):
        out.append((f"d{d}_k19", _np(777, d, d), _np(19, d, d + 1), False))
    for k in (96, 128, 300):  # several tiles, the last one ragged
        out.append((f"d128_k{k}", _np(1001, 128, k), _np(k, 128, k + 1), False))
    out.append(("ints_d33_k300", _ints((500, 33), rng), _ints((300, 33), rng), True))
    return out


@pytest.mark.parametrize("case", _rerank_edges(), ids=lambda c: c[0])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gather_rerank_redesign_edges_match_reference(jx, case, metric):
    jnp, jops, _ = jx
    _, Q, X, pids, k, _exact = case
    want = jops.gather_rerank(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(pids), k,
                              metric=metric, backend="ref")
    got = ops.gather_rerank(_t(Q), _t(X), _t(pids), k, metric=metric)
    _assert_rerank_equal(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", _kmeans_edges(), ids=lambda c: c[0])
def test_kmeans_assign_redesign_edges_match_reference(jx, case):
    jnp, _, jref = jx
    _, X, C, _exact = case
    wi, wd = jref.kmeans_assign(jnp.asarray(X), jnp.asarray(C))
    gi, gd = ops.kmeans_assign(_t(X), _t(C))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=_expanded_atol(X, C))


# -- wrapper contract ----------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda", "pallas", ""])
def test_unknown_backend_raises(backend):
    Q, X = _t(_np(2, 4, 1)), _t(_np(8, 4, 2))
    with pytest.raises(ValueError):
        ops.exact_distances(Q, X, backend=backend)
    with pytest.raises(ValueError):
        ops.kmeans_assign(X, Q, backend=backend)


def test_kernel_wrappers_refuse_mixed_devices():
    Q, X = _t(_np(2, 4, 1)), _t(_np(8, 4, 2))
    with pytest.raises(ValueError):
        ops.on_cpu(Q, X.to("meta"))
    with pytest.raises(ValueError):
        trerank.check_cuda("points", X, torch.float32, 2)


def test_cpu_tensors_never_build_or_count():
    """Each CUDA wrapper raises for CPU tensors before it builds or counts;
    only ``ops`` chooses the plain version for them."""
    _build.reset_launch_counts()
    Q, X = _t(_np(3, 8, 1)), _t(_np(20, 8, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        trerank.rerank_distances(Q, X)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trerank.gather_rerank(Q, X, _t(np.zeros((3, 4), np.int32)), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmeans_kernel(X, Q)
    ops.exact_distances(Q, X)
    ops.gather_rerank(Q, X, _t(np.zeros((3, 4), np.int32)), 2)
    ops.kmeans_assign(X, Q)
    assert _build.launch_counts() == {}
    assert _build._libs == {}


def test_import_builds_nothing():
    """Importing the whole port starts no compiler and loads no library."""
    code = (
        "import ctypes, subprocess, torch; subprocess.Popen = ctypes.CDLL = None; "
        "import repro_torch.runtime.cluster, repro_torch.kernels.ops, repro_torch.serving; "
        "import repro_torch.kernels._build as b; print(b._libs == {} and b._counts == {})"
    )
    src = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": src},
    )
    assert out.stdout.strip() == "True"


def test_lib_path_covers_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cuh").write_text("// v1\n")
    (tmp_path / "k.cu").write_text('#include <stdint.h>\n#include "k.cuh"\n')
    before = _build._lib_path("k")
    (tmp_path / "k.cuh").write_text("// v2\n")
    assert _build._lib_path("k") != before


def test_every_source_has_a_kernel_note():
    for name in _build.sources():
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert "Replaces" in text or "replaces" in text
        assert "Bound on this card" in text and "Design" in text


# -- the CUDA kernels against their plain versions (card only) ----------------

# the small tile (Stage B's shape, the tiles' ragged edges, D % 4 != 0,
# D > 256 in two rounds) and the large one (ragged Q, N and D, D % 4 != 0,
# one query against many points)
RERANK_SHAPES = [(1, 1, 1), (100, 4000, 128), (33, 1000, 70), (33, 130, 70), (1, 129, 33),
                 (65, 257, 130), (300, 20000, 33), (129, 30000, 130), (33, 5000, 300),
                 (257, 40001, 68), (600, 20000, 33), (300, 70000, 130), (1, 300000, 4)]


@pytest.mark.parametrize("q,n,d", RERANK_SHAPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_rerank_distances_matches_plain(cuda, q, n, d, metric):
    Q, X = _t(_np(q, d, 1)).to(cuda), _t(_np(n, d, 2)).to(cuda)
    got = ops.exact_distances(Q, X, metric=metric)
    want = ops.exact_distances(Q, X, metric=metric, backend="ref")
    torch.cuda.synchronize()
    atol = _expanded_atol(Q.cpu().numpy(), X.cpu().numpy())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_rerank_distances_large_matches_plain(cuda, metric):
    """A ground-truth-sized call (Q = 1,000, N = 100,000) takes the large
    tile and stays within the expanded form's tolerance of the plain version."""
    Q, X = _t(_np(1000, 128, 5)).to(cuda), _t(_np(100_000, 128, 6)).to(cuda)
    assert trerank.tile_class(1000, 100_000, 128) == ("large",)
    got = ops.exact_distances(Q, X, metric=metric)
    want = ops.exact_distances(Q, X, metric=metric, backend="ref")
    torch.cuda.synchronize()
    atol = _expanded_atol(Q.cpu().numpy(), X.cpu().numpy())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("d", [128, 33, 70, 1])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_rerank_distances_tiles_agree_bit_for_bit(cuda, d, metric):
    """The rows of a Q = 100 call (the small tile) equal the same rows of a
    call whose Q takes the large tile: both sum the same chains."""
    Q, X = _t(_np(2200, d, 7)).to(cuda), _t(_np(4000, d, 8)).to(cuda)
    assert trerank.tile_class(100, 4000, d) == ("small",)
    assert trerank.tile_class(2200, 4000, d) == ("large",)
    small = ops.exact_distances(Q[:100].contiguous(), X, metric=metric)
    large = ops.exact_distances(Q, X, metric=metric)
    torch.cuda.synchronize()
    assert torch.equal(small.view(torch.int32), large[:100].view(torch.int32))


@pytest.mark.parametrize("q,n", [(100, 4000), (1000, 20000)])
def test_cuda_rerank_distances_unaligned_rows(cuda, q, n):
    """Tensors whose data starts 4 bytes past a 16-byte boundary take the
    4-byte copies and give the aligned call's bits."""
    Q, X = _t(_np(q, 128, 9)).to(cuda), _t(_np(n, 128, 10)).to(cuda)
    qu = torch.empty(q * 128 + 1, device=cuda)[1:].view(q, 128)
    xu = torch.empty(n * 128 + 1, device=cuda)[1:].view(n, 128)
    qu.copy_(Q)
    xu.copy_(X)
    assert qu.data_ptr() % 16 and xu.data_ptr() % 16
    for metric in ("l2", "ip"):
        got = ops.exact_distances(qu, xu, metric=metric)
        want = ops.exact_distances(Q, X, metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cuda_rerank_distances_counts_by_tile(cuda):
    _build.reset_launch_counts()
    ops.exact_distances(_t(_np(100, 128, 1)).to(cuda), _t(_np(4000, 128, 2)).to(cuda))
    ops.exact_distances(_t(_np(1000, 128, 1)).to(cuda), _t(_np(50000, 128, 2)).to(cuda))
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"rerank_distances": 2}
    assert _build.launch_shapes() == {"rerank_distances": {("small",): 1, ("large",): 1}}


@pytest.mark.parametrize("case", _edge_pools(), ids=lambda c: c[0])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_gather_rerank_matches_plain(cuda, case, metric):
    _, Q, X, pids, k = case
    args = (_t(Q).to(cuda), _t(X).to(cuda), _t(pids).to(cuda), k)
    got = ops.gather_rerank(*args, metric=metric)
    want = ops.gather_rerank(*args, metric=metric, backend="ref")
    torch.cuda.synchronize()
    _assert_rerank_equal([a.cpu() for a in got], [a.cpu() for a in want], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,k,d", [(1000, 16, 128), (5000, 256, 4), (77, 5, 33)])
def test_cuda_kmeans_assign_matches_plain(cuda, n, k, d):
    X, C = _t(_np(n, d, 3)).to(cuda), _t(_np(k, d, 4)).to(cuda)
    gi, gd = ops.kmeans_assign(X, C)
    wi, wd = ops.kmeans_assign(X, C, backend="ref")
    torch.cuda.synchronize()
    assert (gi == wi).float().mean().item() > 0.999
    torch.testing.assert_close(gd, wd, rtol=1e-5, atol=_expanded_atol(X.cpu().numpy(), C.cpu().numpy()))


def _assert_bits(got, want):
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", _rerank_edges(), ids=lambda c: c[0])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_gather_rerank_redesign_edges(cuda, case, metric):
    _, Q, X, pids, k, exact = case
    args = (_t(Q).to(cuda), _t(X).to(cuda), _t(pids).to(cuda), k)
    got = ops.gather_rerank(*args, metric=metric)
    want = ops.gather_rerank(*args, metric=metric, backend="ref")
    torch.cuda.synchronize()
    if exact:
        _assert_bits(got, want)
    else:
        _assert_rerank_equal([a.cpu() for a in got], [a.cpu() for a in want], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", _kmeans_edges(), ids=lambda c: c[0])
def test_cuda_kmeans_assign_redesign_edges(cuda, case):
    _, X, C, exact = case
    gi, gd = ops.kmeans_assign(_t(X).to(cuda), _t(C).to(cuda))
    wi, wd = ops.kmeans_assign(_t(X).to(cuda), _t(C).to(cuda), backend="ref")
    torch.cuda.synchronize()
    if exact:
        _assert_bits((gi, gd), (wi, wd))
        return
    atol = _expanded_atol(X, C)
    torch.testing.assert_close(gd, wd, rtol=1e-5, atol=atol)
    # assignments equal wherever the plain best-vs-second margin exceeds atol
    full = ops.exact_distances(_t(X), _t(C), backend="ref")
    two = torch.topk(full, min(2, C.shape[0]), dim=1, largest=False).values
    margin = two[:, 1] - two[:, 0] if C.shape[0] > 1 else torch.full_like(two[:, 0], float("inf"))
    assert not bool(((gi.cpu() != wi.cpu()) & (margin > atol)).any())
