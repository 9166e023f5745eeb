"""The masked top-k ops of ``repro_torch.kernels.ops`` against the reference.

The five masked ops and the three ``*_dedup`` forms run their plain
versions here (CPU tensors) and are held against ``repro.kernels.ops`` with
``backend="ref"`` on the same numpy inputs made from a seed.  Ids are equal
(inputs are random, or integer-valued where a case needs exact ties, so
both sides tie the same way and pick the lowest id); exact distances agree
within 1e-5 of |q|^2 + |x|^2 (the expanded form, summed by other matrix
routines); ADC scores within 1e-5 relative.  Within the port, the unified
op gives each row the bits of the split per-flavor op.

The ``test_cuda_*`` cases launch the CUDA kernels against their plain
versions and skip (inside the ``cuda`` fixture) where there is no card; on
the card select them with ``-k cuda``.  The reference is imported inside
the ``ref`` fixture, so the card-only cases run where JAX is not installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.vamana import brute_force_topk  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import masked_topk as kmasked  # noqa: E402

M_SUB, K_CODE = 4, 16


@pytest.fixture(scope="module")
def ref():
    """(jax.numpy, repro.kernels.ops), or a skip where JAX is absent."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops

    return jnp, jops


def _case(name):
    """(queries, points, luts, codes, plane (Q, N) bool, k) for one edge case."""
    rng = np.random.default_rng(CASES.index(name) + 1)
    q, n, d, k, frac = {
        "basic": (5, 70, 16, 10, 0.5),
        "all_masked": (4, 60, 8, 5, 0.0),
        "k_gt_n": (3, 7, 8, 12, 1.0),
        "k_gt_passing": (4, 70, 16, 10, 0.07),
        "ragged": (3, 129, 33, 9, 0.6),
        "q1": (1, 50, 8, 5, 0.5),
        "ties": (4, 40, 8, 12, 0.8),
        "chunks": (6, 1300, 16, 40, 0.5),
        "k_gt_chunk": (3, 1300, 8, 600, 0.7),
    }[name]
    if name == "ties":  # integer values: every sum is exact, duplicated rows tie
        X = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
        X[n // 2 :] = X[: n - n // 2]
        Q = rng.integers(-2, 3, size=(q, d)).astype(np.float32)
        luts = rng.integers(0, 4, size=(q, M_SUB, K_CODE)).astype(np.float32)
    else:
        X = rng.normal(size=(n, d)).astype(np.float32)
        Q = rng.normal(size=(q, d)).astype(np.float32)
        luts = rng.normal(size=(q, M_SUB, K_CODE)).astype(np.float32)
    codes = rng.integers(0, K_CODE, size=(n, M_SUB)).astype(np.uint8)
    plane = rng.random((q, n)) < frac
    if name == "k_gt_passing":
        plane[:] = False
        plane[:, rng.choice(n, 5, replace=False)] = True
    return Q, X, luts, codes, plane, k


CASES = ["basic", "all_masked", "k_gt_n", "k_gt_passing", "ragged", "q1", "ties", "chunks",
         "k_gt_chunk"]


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _atol(Q, X):
    return 1e-5 * (float(np.max(np.sum(Q * Q, 1), initial=0)) + float(np.max(np.sum(X * X, 1))))


def _assert_topk(got, want, atol, rtol=1e-5):
    gd, gi = (np.asarray(a) for a in got)
    wd, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=rtol, atol=atol)
    assert ((wi < 0) == np.isinf(wd)).all()


# -- plain versions vs repro.kernels.ops (backend="ref") ------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_masked_exact_topk_matches_reference(ref, case, metric):
    jnp, jops = ref
    Q, X, _, _, plane, k = _case(case)
    want = jops.masked_exact_topk(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(plane[0]), k,
                                  metric=metric, backend="ref")
    got = ops.masked_exact_topk(_t(Q), _t(X), _t(plane[0]), k, metric=metric)
    _assert_topk(got, want, _atol(Q, X))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_masked_exact_topk_multi_matches_reference(ref, case, metric):
    jnp, jops = ref
    Q, X, _, _, plane, k = _case(case)
    want = jops.masked_exact_topk_multi(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(plane), k,
                                        metric=metric, backend="ref")
    got = ops.masked_exact_topk_multi(_t(Q), _t(X), _t(plane), k, metric=metric)
    _assert_topk(got, want, _atol(Q, X))


@pytest.mark.parametrize("case", CASES)
def test_masked_pq_topk_matches_reference(ref, case):
    jnp, jops = ref
    _, _, luts, codes, plane, k = _case(case)
    want = jops.masked_pq_topk(jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(plane[0]), k,
                               backend="ref")
    got = ops.masked_pq_topk(_t(luts), _t(codes), _t(plane[0]), k)
    _assert_topk(got, want, 1e-6)


@pytest.mark.parametrize("case", CASES)
def test_masked_pq_topk_multi_matches_reference(ref, case):
    jnp, jops = ref
    _, _, luts, codes, plane, k = _case(case)
    want = jops.masked_pq_topk_multi(jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(plane), k,
                                     backend="ref")
    got = ops.masked_pq_topk_multi(_t(luts), _t(codes), _t(plane), k)
    _assert_topk(got, want, 1e-6)


def _flavors(q, kind):
    return {"exact": np.zeros(q, bool), "adc": np.ones(q, bool),
            "mixed": np.arange(q) % 2 == 1}[kind]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["exact", "adc", "mixed"])
def test_unified_masked_topk_matches_reference_and_split(ref, case, kind):
    jnp, jops = ref
    Q, X, luts, codes, plane, k = _case(case)
    fl = _flavors(Q.shape[0], kind)
    want = jops.unified_masked_topk(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(plane),
        jnp.asarray(fl), k, backend="ref",
    )
    got = ops.unified_masked_topk(_t(Q), _t(X), _t(luts), _t(codes), _t(plane), _t(fl), k)
    _assert_topk(got, want, _atol(Q, X))
    # each row carries the bits of the split per-flavor op
    ex_d, ex_i = ops.masked_exact_topk_multi(_t(Q), _t(X), _t(plane), k)
    pq_d, pq_i = ops.masked_pq_topk_multi(_t(luts), _t(codes), _t(plane), k)
    f = _t(fl)
    assert torch.equal(got[0], torch.where(f[:, None], pq_d, ex_d))
    assert torch.equal(got[1], torch.where(f[:, None], pq_i, ex_i))


def _dedup(plane, seed):
    """Unique rows and a row index with repeats (row 0 used twice at least)."""
    rng = np.random.default_rng(seed)
    unique = plane[: max(1, plane.shape[0] // 2 + 1)]
    idx = rng.integers(0, unique.shape[0], size=plane.shape[0])
    idx[-1] = idx[0]
    return unique, idx


@pytest.mark.parametrize("case", ["basic", "all_masked", "k_gt_passing", "ragged", "q1", "chunks"])
def test_dedup_ops_match_reference(ref, case):
    jnp, jops = ref
    Q, X, luts, codes, plane, k = _case(case)
    unique, idx = _dedup(plane, 3)
    ju, ji = jnp.asarray(unique), jnp.asarray(idx)
    tu, ti = _t(unique), _t(idx)
    want = jops.masked_exact_topk_dedup(jnp.asarray(Q), jnp.asarray(X), ju, ji, k, backend="ref")
    got = ops.masked_exact_topk_dedup(_t(Q), _t(X), tu, ti, k)
    _assert_topk(got, want, _atol(Q, X))
    want = jops.masked_pq_topk_dedup(jnp.asarray(luts), jnp.asarray(codes), ju, ji, k, backend="ref")
    got = ops.masked_pq_topk_dedup(_t(luts), _t(codes), tu, ti, k)
    _assert_topk(got, want, 1e-6)
    fl = _flavors(Q.shape[0], "mixed")
    want = jops.unified_masked_topk_dedup(
        jnp.asarray(Q), jnp.asarray(X), jnp.asarray(luts), jnp.asarray(codes), ju, ji,
        jnp.asarray(fl), k, backend="ref",
    )
    got = ops.unified_masked_topk_dedup(_t(Q), _t(X), _t(luts), _t(codes), tu, ti, _t(fl), k)
    _assert_topk(got, want, _atol(Q, X))
    np.testing.assert_array_equal(ops.expand_mask_plane(tu, ti).numpy(), unique[idx])


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantized_dtype_matches_reference(ref, dtype):
    """The three exact entry points with a quantized ``dtype`` score the
    quantized values as the reference's oracle does (equal id sets; the
    tolerance of the reference's own quantized tests)."""
    jnp, jops = ref
    Q, X, _, _, plane, k = _case("basic")
    idx = np.arange(Q.shape[0]) % 2
    for fn, jfn, masks in (
        (ops.masked_exact_topk, jops.masked_exact_topk, (plane[0],)),
        (ops.masked_exact_topk_multi, jops.masked_exact_topk_multi, (plane,)),
        (ops.masked_exact_topk_dedup, jops.masked_exact_topk_dedup, (plane[:2], idx)),
    ):
        gd, gi = fn(_t(Q), _t(X), *[_t(m) for m in masks], k, dtype=dtype)
        wd, wi = jfn(jnp.asarray(Q), jnp.asarray(X), *[jnp.asarray(m) for m in masks], k,
                     dtype=dtype, backend="ref")
        wd, wi = np.asarray(wd), np.asarray(wi)
        for g, w in zip(gi.numpy(), wi):
            assert set(g.tolist()) == set(w.tolist())
        np.testing.assert_allclose(np.where(np.isinf(wd), 0, gd.numpy()),
                                   np.where(np.isinf(wd), 0, wd), rtol=5e-3, atol=5e-2)


# -- exact_topk ties (a slice-1 fault: torch.topk orders ties freely) -------------

@pytest.mark.parametrize("tile", [1, 11])
def test_exact_topk_ties_take_the_lowest_index(ref, tile):
    """Query [0] against rows [2, 1, 1, 1, 3, 1] (tiled to 66 rows): the
    reference's lax.top_k returns the lowest tied ids first."""
    jnp, jops = ref
    Q = np.zeros((1, 1), np.float32)
    X = np.tile(np.array([[2], [1], [1], [1], [3], [1]], np.float32), (tile, 1))
    wd, wi = jops.exact_topk(jnp.asarray(Q), jnp.asarray(X), 4, backend="ref")
    gd, gi = ops.exact_topk(_t(Q), _t(X), 4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gi.numpy(), [[1, 2, 3, 5]])
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    bd, bi = brute_force_topk(X, Q, 4, device="cpu")
    np.testing.assert_array_equal(bi, [[1, 2, 3, 5]])


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    Q, X, luts, codes, plane, k = _case("basic")
    _build.reset_launch_counts()
    rows = _t(plane.astype(np.uint8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmasked.masked_exact_topk(_t(Q), _t(X), rows, None, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmasked.masked_pq_topk(_t(luts), _t(codes), rows, None, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmasked.unified_masked_topk(_t(Q), _t(X), _t(luts), _t(codes), rows, None,
                                    _t(np.zeros(Q.shape[0], bool)), k)
    ops.masked_exact_topk(_t(Q), _t(X), _t(plane[0]), k)
    ops.unified_masked_topk(_t(Q), _t(X), _t(luts), _t(codes), _t(plane),
                            _t(np.ones(Q.shape[0], bool)), k)
    assert _build.launch_counts() == {}


# -- the CUDA kernels against their plain versions (card only) ----------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.as_tensor(np.asarray(a)).to(dev) for a in arrays]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_masked_exact_topk_matches_plain(cuda, case, metric):
    Q, X, _, _, plane, k = _case(case)
    q, x, m, p = _on(cuda, Q, X, plane[0], plane)
    for fn, mask in ((ops.masked_exact_topk, m), (ops.masked_exact_topk_multi, p)):
        got = fn(q, x, mask, k, metric=metric)
        want = fn(q, x, mask, k, metric=metric, backend="ref")
        torch.cuda.synchronize()
        _assert_topk([a.cpu() for a in got], [a.cpu() for a in want], _atol(Q, X))


@pytest.mark.parametrize("case", CASES)
def test_cuda_masked_pq_topk_matches_plain_bit_for_bit(cuda, case):
    """The kernel sums the LUT entries in the plain version's order."""
    _, _, luts, codes, plane, k = _case(case)
    lt, c, m, p = _on(cuda, luts, codes, plane[0], plane)
    for fn, mask in ((ops.masked_pq_topk, m), (ops.masked_pq_topk_multi, p)):
        got = fn(lt, c, mask, k)
        want = fn(lt, c, mask, k, backend="ref")
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", ["exact", "adc", "mixed"])
def test_cuda_unified_equals_split_kernels(cuda, case, kind):
    Q, X, luts, codes, plane, k = _case(case)
    fl = _flavors(Q.shape[0], kind)
    q, x, lt, c, p, f = _on(cuda, Q, X, luts, codes, plane, fl)
    got = ops.unified_masked_topk(q, x, lt, c, p, f, k)
    want = ops.unified_masked_topk(q, x, lt, c, p, f, k, backend="ref")
    torch.cuda.synchronize()
    _assert_topk([a.cpu() for a in got], [a.cpu() for a in want], _atol(Q, X))
    # split kernels (forced onto the plane path): the same bits per row
    rows = torch.arange(q.shape[0], dtype=torch.int32, device=cuda)
    ex = kmasked.masked_exact_topk(q, x, p.to(torch.uint8), rows, k)
    pq = kmasked.masked_pq_topk(lt, c, p.to(torch.uint8), rows, k)
    assert torch.equal(got[0], torch.where(f[:, None], pq[0], ex[0]))
    assert torch.equal(got[1], torch.where(f[:, None], pq[1], ex[1]))


def test_cuda_dedup_reads_unique_rows(cuda):
    Q, X, luts, codes, plane, k = _case("chunks")
    unique, idx = _dedup(plane, 5)
    q, x, lt, c, u, i = _on(cuda, Q, X, luts, codes, unique, idx)
    fl = torch.as_tensor(_flavors(Q.shape[0], "mixed")).to(cuda)
    dense = ops.expand_mask_plane(u, i)
    for dedup, multi in (
        (lambda: ops.masked_exact_topk_dedup(q, x, u, i, k),
         lambda: ops.masked_exact_topk_multi(q, x, dense, k)),
        (lambda: ops.masked_pq_topk_dedup(lt, c, u, i, k),
         lambda: ops.masked_pq_topk_multi(lt, c, dense, k)),
        (lambda: ops.unified_masked_topk_dedup(q, x, lt, c, u, i, fl, k),
         lambda: ops.unified_masked_topk(q, x, lt, c, dense, fl, k)),
    ):
        a, b = dedup(), multi()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_cuda_exact_topk_ties(cuda):
    Q = torch.zeros((1, 1), device=cuda)
    X = torch.tensor([[2.0], [1.0], [1.0], [1.0], [3.0], [1.0]], device=cuda).repeat(11, 1)
    _, gi = ops.exact_topk(Q, X, 4)
    assert gi.cpu().tolist() == [[1, 2, 3, 5]]


def test_cuda_concurrent_exact_and_adc_launches(cuda):
    """Executors launch from several threads at once, exact-only calls (a
    small shared-memory tile) beside ADC calls (a large one, m = 32,
    K = 256): every call still launches and gives its single-thread bits."""
    import threading

    rng = np.random.default_rng(7)
    n, d, m, kc = 4096, 128, 32, 256
    q, x, lt, c, p = _on(
        cuda,
        rng.normal(size=(8, d)).astype(np.float32),
        rng.normal(size=(n, d)).astype(np.float32),
        rng.random((8, m, kc)).astype(np.float32),
        rng.integers(0, kc, size=(n, m)).astype(np.uint8),
        rng.random((8, n)) < 0.5,
    )
    calls = (lambda: ops.masked_exact_topk_multi(q, x, p, 40),
             lambda: ops.masked_pq_topk_multi(lt, c, p, 160))
    want = []
    for fn in calls:
        want.append(fn())
    torch.cuda.synchronize()
    errors = []

    def worker(tid):
        try:
            for i in range(40):
                j = (tid + i) % 2
                got = calls[j]()
                torch.cuda.current_stream().synchronize()
                if not (torch.equal(got[0], want[j][0]) and torch.equal(got[1], want[j][1])):
                    errors.append(f"thread {tid} call {i}: results differ")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(f"thread {tid}: {e!r}")

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:3]


# -- the chunked select's edges (card only) ------------------------------------
# The kernel sorts each 512-row chunk and merges the chunks' lists (one warp
# for up to 32 chunks; up to 16 warps of 32 lists and a second level over
# their streams; lanes that own several lists past 512 chunks).


def _select_case(name, n=1800, q=4, d=16):
    """(queries, points, luts, codes, plane) over several 512-row chunks, the
    last one short."""
    rng = np.random.default_rng(n + len(name))
    X = rng.normal(size=(n, d)).astype(np.float32)
    Q = rng.normal(size=(q, d)).astype(np.float32)
    luts = rng.normal(size=(q, M_SUB, K_CODE)).astype(np.float32)
    codes = rng.integers(0, K_CODE, size=(n, M_SUB)).astype(np.uint8)
    plane = rng.random((q, n)) < 0.5
    if name == "equal":  # integer values, every score of a query equal: ties across chunks
        X[:] = 1.0
        Q = np.round(Q)
        luts[:] = 1.0
        plane[:] = True
    elif name == "gaps":  # chunks with fewer live rows than kc, one fully masked between
        plane[:] = False
        plane[:, :3] = True
        plane[:, 1024:1124] = True
        plane[:, 1700:1790] = True
    elif name == "zeros":  # zero query rows and zero points: ip scores of 0.0, tied by id
        Q[::2] = 0.0
        X[::3] = 0.0
    return Q, X, luts, codes, plane


def _select_checks(dev, Q, X, luts, codes, plane, k, metric):
    """Every masked kernel against its plain version (ids equal; exact
    distances within tolerance, ADC bit for bit) and unified against the
    split kernels bit for bit; returns {op: (dists, ids)} on the host."""
    q, x, lt, c, m, p = _on(dev, Q, X, luts, codes, plane[0], plane)
    fl = torch.as_tensor(_flavors(Q.shape[0], "mixed")).to(dev)
    calls = {
        "exact": lambda b: ops.masked_exact_topk(q, x, m, k, metric=metric, backend=b),
        "exact_multi": lambda b: ops.masked_exact_topk_multi(q, x, p, k, metric=metric, backend=b),
        "pq": lambda b: ops.masked_pq_topk(lt, c, m, k, backend=b),
        "pq_multi": lambda b: ops.masked_pq_topk_multi(lt, c, p, k, backend=b),
        "unified": lambda b: ops.unified_masked_topk(q, x, lt, c, p, fl, k, metric=metric, backend=b),
    }
    got = {}
    for name, fn in calls.items():
        g, w = fn("auto"), fn("ref")
        torch.cuda.synchronize()
        g, w = [a.cpu() for a in g], [a.cpu() for a in w]
        if name.startswith("pq"):
            assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1]), name
        else:
            _assert_topk(g, w, _atol(Q, X))
        got[name] = g
    rows = torch.arange(q.shape[0], dtype=torch.int32, device=dev)
    ex = kmasked.masked_exact_topk(q, x, p.to(torch.uint8), rows, k, metric=metric)
    pq = kmasked.masked_pq_topk(lt, c, p.to(torch.uint8), rows, k)
    f = fl.cpu()[:, None]
    for a, e, b in zip(got["unified"], ex, pq):
        assert torch.equal(a, torch.where(f, b.cpu(), e.cpu()))
    return got


@pytest.mark.parametrize("k", [1, 511, 512, 513, 1805])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_select_k_around_the_chunk_matches_plain(cuda, k, metric):
    """N = 1,800 (four chunks, the last of 264 rows), k from 1 to N + 5."""
    _select_checks(cuda, *_select_case("random"), k, metric)


@pytest.mark.parametrize("n, k", [(1800, 1000), (20580, 600), (300_000, 600)])
def test_cuda_equal_scores_take_ids_in_order(cuda, n, k):
    """Every score equal: ids 0 .. k-1 across chunk boundaries, through one
    merge warp (4 chunks), two warps and the second level (41 chunks) and
    16 warps whose lanes own several lists (586 chunks)."""
    got = _select_checks(cuda, *_select_case("equal", n=n, q=2, d=4), k, "l2")
    for name, (_d, ids) in got.items():
        assert ids.tolist() == [list(range(k))] * 2, name


@pytest.mark.parametrize("case", ["gaps", "zeros"])
@pytest.mark.parametrize("k", [40, 160, 600])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_select_gaps_and_signed_zeros_match_plain(cuda, case, k, metric):
    """Chunks with fewer live rows than kc and a fully masked chunk between
    live ones; ip scores of -0.0 and +0.0 (zero query rows, zero points),
    which tie and go to the lowest id."""
    Q, X, luts, codes, plane = _select_case(case)
    got = _select_checks(cuda, Q, X, luts, codes, plane, k, metric)
    if case == "zeros" and metric == "ip":  # query rows 0 and 2 are zero: every passing row ties
        for name, masks in (("exact", plane[[0, 0]]), ("exact_multi", plane[[0, 2]])):
            for row, passing in zip(got[name][1][[0, 2]].tolist(), masks):
                want = np.flatnonzero(passing)[:k].tolist()
                assert row == want + [-1] * (k - len(want)), name


# -- the f32 tile's shapes (card only) ------------------------------------------
# The f32 tile scores 32 queries x 256 rows a step (two 16-query halves x
# four 64-row units, one warp each) in 512-row chunks; a unit no query of a
# half may see is not scored, and one no query of the tile may see is not
# staged.


def _unit_mask(q, n, rng, shift=True):
    """(Q, N) bool: by 64-row unit u (shifted by the query index when
    ``shift``), every row passes (u % 3 == 0), none (1) or one in ten (2),
    so some units are live for some queries of a tile and dead for others."""
    u = np.arange(n)[None, :] // 64 + (np.arange(q)[:, None] if shift else 0)
    sparse = rng.random((q, n)) < 0.1
    return np.where(u % 3 == 0, True, np.where(u % 3 == 1, False, sparse))


def _assert_topk_near_ties(got, want_next, atol, rtol=1e-5):
    """Kernel (dists, ids) against the plain version's top-(k + 1) on the
    card: distances within tolerance, the same (+inf, -1) sentinels, and
    ids equal except where the plain version's distance ties within the
    tolerance with a neighbouring slot, slot k (the first row left out)
    included.  The kernel's fused chains and the plain version's matrix
    product round apart by a few ulps, so rows that near-tie may swap."""
    gd, gi = (np.asarray(a) for a in got)
    nd, ni = (np.asarray(a) for a in want_next)
    k = gd.shape[1]
    wd, wi = nd[:, :k], ni[:, :k]
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    assert ((gi < 0) == np.isinf(gd)).all()
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=rtol, atol=atol)
    d = np.where(np.isinf(nd), 1e30, nd)
    step = np.abs(np.diff(d, axis=1))
    gap = np.full(d.shape, np.inf)
    gap[:, 1:] = step
    gap_r = np.full(d.shape, np.inf)
    gap_r[:, :-1] = step
    tied = (np.minimum(gap, gap_r) <= atol + rtol * np.abs(d))[:, :k]
    bad = (gi != wi) & ~tied
    assert not bad.any(), f"{int(bad.sum())} ids differ outside ties"


TILE_Q = [1, 8, 100, 129]
TILE_D = [8, 33, 128]
TILE_N = [64, 65, 1000, 1300]


@pytest.mark.parametrize("q", TILE_Q)
@pytest.mark.parametrize("d", TILE_D)
@pytest.mark.parametrize("n", TILE_N)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_f32_tile_matches_plain(cuda, q, d, n, metric):
    """Q either side of the 32-query tile and its 16-query halves, D below
    and past the 16-feature stage (unaligned at 33), N either side of the
    64-row unit and the 512-row chunk; a row mask, the dense plane and the
    dedup'd plane, units full, empty and sparse; k from 1 to past the
    chunk: ids equal to the plain version's, distances within tolerance."""
    rng = np.random.default_rng(q * 7919 + d * 31 + n)
    Q = rng.normal(size=(q, d)).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    plane = _unit_mask(q, n, rng)
    row = _unit_mask(1, n, rng, shift=False)[0]
    unique, idx = _dedup(plane, q + n)
    qq, x, m, p, u, i = _on(cuda, Q, X, row, plane, unique, idx)
    for k in (1, 40, 160, 600):
        for fn, args in ((ops.masked_exact_topk, (qq, x, m)), (ops.masked_exact_topk_multi, (qq, x, p)),
                         (ops.masked_exact_topk_dedup, (qq, x, u, i))):
            got = fn(*args, k, metric=metric)
            want = fn(*args, k + 1, metric=metric, backend="ref")
            torch.cuda.synchronize()
            _assert_topk_near_ties([a.cpu() for a in got], [a.cpu() for a in want], _atol(Q, X))


@pytest.mark.parametrize("q", TILE_Q)
@pytest.mark.parametrize("n", [1000, 4096])
def test_cuda_f32_tile_unified_equals_split(cuda, q, n):
    """The unified launch's exact tiles are the f32 tile: each exact row of
    a mixed-flavor call has the split kernel's bits, under unit masks."""
    rng = np.random.default_rng(q + n)
    Q = rng.normal(size=(q, 128)).astype(np.float32)
    X = rng.normal(size=(n, 128)).astype(np.float32)
    luts = rng.normal(size=(q, M_SUB, K_CODE)).astype(np.float32)
    codes = rng.integers(0, K_CODE, size=(n, M_SUB)).astype(np.uint8)
    plane = _unit_mask(q, n, rng)
    qq, x, lt, c, p, f = _on(cuda, Q, X, luts, codes, plane, _flavors(q, "mixed"))
    rows = torch.arange(q, dtype=torch.int32, device=cuda)
    for k in (1, 40, 160):
        got = ops.unified_masked_topk(qq, x, lt, c, p, f, k)
        ex = kmasked.masked_exact_topk(qq, x, p.to(torch.uint8), rows, k)
        pq = kmasked.masked_pq_topk(lt, c, p.to(torch.uint8), rows, k)
        torch.cuda.synchronize()
        assert torch.equal(got[0], torch.where(f[:, None], pq[0], ex[0]))
        assert torch.equal(got[1], torch.where(f[:, None], pq[1], ex[1]))


def test_cuda_f32_tile_unaligned_mask_rows(cuda):
    """N = 1,001 (mask rows not 8-byte aligned: the byte-at-a-time mask
    reads) and points at an odd offset (4-byte copies)."""
    rng = np.random.default_rng(11)
    Q = rng.normal(size=(40, 64)).astype(np.float32)
    X = rng.normal(size=(1001, 64)).astype(np.float32)
    plane = _unit_mask(40, 1001, rng)
    qq, x, p = _on(cuda, Q, X, plane)
    odd = torch.empty(1001 * 64 + 1, dtype=torch.float32, device=cuda)[1:].view(1001, 64)
    odd.copy_(x)
    assert odd.data_ptr() % 16
    for pts in (x, odd):
        got = ops.masked_exact_topk_multi(qq, pts, p, 50)
        want = ops.masked_exact_topk_multi(qq, x, p, 51, backend="ref")
        torch.cuda.synchronize()
        _assert_topk_near_ties([a.cpu() for a in got], [a.cpu() for a in want], _atol(Q, X))


# -- the ADC tile's shapes (card only) ------------------------------------------
# An ADC block stages the LUTs of a tile of 8, 4, 2 or 1 queries once (the
# tile's size from (m, K): 2 at m = 32, K = 256; 1 at 64 KB a LUT), then
# scores and selects batches of chunks, each chunk's rows that some query
# of the tile may see listed first; codes go to registers as 16-byte
# vectors where m is 16, 32, 48 or 64 and the codes are aligned, else a
# byte at a time.

# (m, K): a tiny LUT (8-query tiles), the main path's, a 64 KB LUT (one
# query a tile), and m not a multiple of 16 (byte codes)
ADC_MK = [(8, 16), (32, 256), (64, 256), (20, 256)]


@pytest.mark.parametrize("m, kc", ADC_MK)
@pytest.mark.parametrize("n", [511, 2047, 2049, 20000])
def test_cuda_adc_tile_matches_plain_bit_for_bit(cuda, m, kc, n):
    """N inside one chunk, either side of a run of chunks and over many
    batches (20,000 rows: batches of several chunks, the last one short);
    a row mask, the dense plane and the dedup'd plane with units full,
    empty and sparse; codes aligned and at an odd offset; k from 1 to past
    the chunk: the plain version's bits, and the unified launch's ADC and
    exact rows the split kernels' bits."""
    q = 37
    rng = np.random.default_rng(m * 31 + kc + n)
    luts = rng.random((q, m, kc)).astype(np.float32)
    codes = rng.integers(0, kc, size=(n, m)).astype(np.uint8)
    Q = rng.normal(size=(q, 16)).astype(np.float32)
    X = rng.normal(size=(n, 16)).astype(np.float32)
    plane = _unit_mask(q, n, rng)
    row = _unit_mask(1, n, rng, shift=False)[0]
    unique, idx = _dedup(plane, q + n)
    lt, c, mrow, p, u, i, qq, x, f = _on(cuda, luts, codes, row, plane, unique, idx, Q, X,
                                         _flavors(q, "mixed"))
    odd = torch.empty(n * m + 1, dtype=torch.uint8, device=cuda)[1:].view(n, m)
    odd.copy_(c)
    assert odd.data_ptr() % 16
    rows = torch.arange(q, dtype=torch.int32, device=cuda)
    for k in (1, 40, 160, 600):
        for cc in (c, odd):
            for fn, args in ((ops.masked_pq_topk, (lt, cc, mrow)), (ops.masked_pq_topk_multi, (lt, cc, p)),
                             (ops.masked_pq_topk_dedup, (lt, cc, u, i))):
                got = fn(*args, k)
                want = fn(*args, k, backend="ref")
                torch.cuda.synchronize()
                assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), (fn.__name__, k)
                assert torch.equal(got[1], want[1]), (fn.__name__, k)
        got = ops.unified_masked_topk(qq, x, lt, c, p, f, k)
        ex = kmasked.masked_exact_topk(qq, x, p.to(torch.uint8), rows, k)
        pq = kmasked.masked_pq_topk(lt, c, p.to(torch.uint8), rows, k)
        torch.cuda.synchronize()
        assert torch.equal(got[0], torch.where(f[:, None], pq[0], ex[0]))
        assert torch.equal(got[1], torch.where(f[:, None], pq[1], ex[1]))


@pytest.mark.parametrize("m, kc", [(64, 256), (132, 256)])
def test_cuda_adc_large_luts_still_launch(cuda, m, kc):
    """A LUT past the tile's budget (64 KB, and m = 132, the largest m at
    K = 256 that the tile took before its rebuild) gets a one-query tile
    and launches: the plain version's bits."""
    rng = np.random.default_rng(m)
    luts = rng.random((3, m, kc)).astype(np.float32)
    codes = rng.integers(0, kc, size=(1300, m)).astype(np.uint8)
    lt, c, p = _on(cuda, luts, codes, rng.random((3, 1300)) < 0.5)
    got = ops.masked_pq_topk_multi(lt, c, p, 40)
    want = ops.masked_pq_topk_multi(lt, c, p, 40, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
