"""The quantized (bf16 / int8) scans and the dense ADC scan of the port
against the reference.

- ``quantize_points`` equals ``repro.kernels.ref.quantize_points`` bit for
  bit: the stored values and the scale (1.0 for an all-zero matrix).
- The port's ``masked_exact_topk`` / ``_multi`` / ``_dedup`` with ``dtype``
  bf16 and int8 (their plain versions here, on CPU tensors) against
  ``repro.kernels.ops`` with ``backend="ref"`` and ``"pallas"`` (interpret
  mode), as the reference's own tests hold its kernels: equal id sets, and
  scores within rtol 5e-3 / atol 5e-2 (both score the same quantized
  values; a Pallas int8 score is the int32 cross times the scales, the
  oracles' a dot of dequantized values, so they round apart).
- Stored points with their scale answer exactly as f32 points quantized in
  the call; the scan plus the full-precision guard restores f32 recall.
- ``pq.adc_scores``, ``ops.pq_scan`` and ``ops.pq_scan_topk`` against the
  reference within 1e-5.

The ``test_cuda_*`` cases launch the new kernels against their plain
versions and skip (inside the ``cuda`` fixture) where there is no card; the
reference is imported inside the ``ref`` fixture, so they run where JAX is
not installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.pq import PQCodebook, adc_scores  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import masked_topk as kmasked  # noqa: E402
from repro_torch.kernels import pq_scan as kpq  # noqa: E402
from repro_torch.kernels import ref as pref  # noqa: E402
from repro_torch.runtime import planner  # noqa: E402

DTYPES = ["bf16", "int8"]
RTOL, ATOL = 5e-3, 5e-2


@pytest.fixture(scope="module")
def ref():
    """(jax.numpy, repro.kernels.ops, repro.kernels.ref), or a skip where
    JAX is absent."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jops, jref


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _matrix(name):
    rng = np.random.default_rng(len(name))
    return {
        "normal": rng.normal(size=(300, 33)).astype(np.float32) * 3,
        "zeros": np.zeros((7, 8), np.float32),
        # |x| max 63.5: x / scale lands on .5 often, where rounding is to even
        "halves": (rng.integers(-127, 128, size=(64, 16)) * 0.5).astype(np.float32),
        "one_row": rng.normal(size=(1, 128)).astype(np.float32),
    }[name]


@pytest.mark.parametrize("name", ["normal", "zeros", "halves", "one_row"])
@pytest.mark.parametrize("dtype", DTYPES + ["f32"])
def test_quantize_points_equals_reference(ref, name, dtype):
    jnp, _, jref = ref
    X = _matrix(name)
    want, w_scale = jref.quantize_points(jnp.asarray(X), dtype)
    got, g_scale = pref.quantize_points(_t(X), dtype)
    assert g_scale == w_scale
    if dtype == "int8":
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    back = pref.dequantize_points(got, g_scale).numpy()
    np.testing.assert_array_equal(back, np.asarray(jref.dequantize_points(want, w_scale)))


def _case(name):
    """(queries, points, plane (Q, N) bool, k) for one case."""
    rng = np.random.default_rng(CASES.index(name) + 31)
    q, n, d, k, frac = {
        "basic": (5, 300, 48, 10, 0.5),
        "all_masked": (3, 60, 8, 5, 0.0),
        "k_gt_n": (3, 7, 8, 12, 1.0),
        "k_gt_passing": (4, 90, 16, 10, 0.05),
        "ragged": (3, 129, 33, 9, 0.6),
        "q1": (1, 50, 8, 5, 0.5),
        "zero_points": (3, 40, 8, 6, 0.7),
        "chunks": (6, 1300, 16, 40, 0.5),
    }[name]
    X = rng.normal(size=(n, d)).astype(np.float32)
    Q = rng.normal(size=(q, d)).astype(np.float32)
    if name == "zero_points":
        X[:] = 0.0
    plane = rng.random((q, n)) < frac
    return Q, X, plane, k


CASES = ["basic", "all_masked", "k_gt_n", "k_gt_passing", "ragged", "q1", "zero_points",
         "chunks"]


def _dedup(plane, m):
    unique = plane[:m]
    idx = np.arange(plane.shape[0]) % m
    return unique, idx


def _assert_sets(got, want):
    gd, gi = (np.asarray(a) for a in got)
    wd, wi = (np.asarray(a) for a in want)
    assert gi.shape == wi.shape
    for qi in range(gi.shape[0]):
        assert set(gi[qi].tolist()) == set(wi[qi].tolist()), qi
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    assert ((gi < 0) == np.isinf(gd)).all()
    np.testing.assert_allclose(np.where(np.isinf(gd), 0.0, gd), np.where(np.isinf(wd), 0.0, wd),
                               rtol=RTOL, atol=ATOL)


def _both(ref, form, Q, X, plane, k, metric, dtype, backend):
    """(port plain version, reference op on ``backend``) for one form."""
    jnp, jops, _ = ref
    if form == "row":
        args = (Q, X, plane[0])
        port_fn, ref_fn = ops.masked_exact_topk, jops.masked_exact_topk
    elif form == "plane":
        args = (Q, X, plane)
        port_fn, ref_fn = ops.masked_exact_topk_multi, jops.masked_exact_topk_multi
    else:
        unique, idx = _dedup(plane, max(1, Q.shape[0] // 2))
        args = (Q, X, unique, idx)
        port_fn, ref_fn = ops.masked_exact_topk_dedup, jops.masked_exact_topk_dedup
    got = port_fn(*[_t(a) for a in args], k, metric=metric, dtype=dtype)
    want = ref_fn(*[jnp.asarray(a) for a in args], k, metric=metric, dtype=dtype,
                  backend=backend)
    return got, want


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["row", "plane", "dedup"])
def test_quantized_masked_ops_match_reference_oracle(ref, case, dtype, form):
    Q, X, plane, k = _case(case)
    for metric in ("l2", "ip"):
        got, want = _both(ref, form, Q, X, plane, k, metric, dtype, "ref")
        _assert_sets(got, want)


@pytest.mark.parametrize("case", ["basic", "k_gt_passing", "zero_points"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["row", "plane"])
def test_quantized_masked_ops_match_reference_pallas(ref, case, dtype, form):
    """The reference's Pallas kernels in interpret mode (int8: int32 cross
    times the scales)."""
    Q, X, plane, k = _case(case)
    got, want = _both(ref, form, Q, X, plane, k, "l2", dtype, "pallas")
    _assert_sets(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prestored_points_match_fresh_quantization(dtype):
    Q, X, plane, k = _case("basic")
    stored, x_scale = pref.quantize_points(_t(X), dtype)
    unique, idx = _dedup(plane, 2)
    for fn, mask in ((ops.masked_exact_topk, (plane[0],)), (ops.masked_exact_topk_multi, (plane,)),
                     (ops.masked_exact_topk_dedup, (unique, idx))):
        a = fn(_t(Q), _t(X), *[_t(m) for m in mask], k, dtype=dtype)
        b = fn(_t(Q), stored, *[_t(m) for m in mask], k, dtype=dtype, x_scale=x_scale)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_scan_plus_guard_restores_f32_recall(dtype):
    """The planner's two-stage form: the quantized scan at
    ``quant_guard_pool(k)`` then the full-precision ``gather_rerank`` give
    the f32 scan's ids, with exact f32 distances."""
    rng = np.random.default_rng(23)
    Q = rng.normal(size=(8, 64)).astype(np.float32)
    X = rng.normal(size=(500, 64)).astype(np.float32)
    mask = _t(rng.random(500) < 0.7)
    k = 10
    pool = min(planner.quant_guard_pool(k), 500)
    _qd, pids = ops.masked_exact_topk(_t(Q), _t(X), mask, pool, dtype=dtype)
    gd, gi = ops.gather_rerank(_t(Q), _t(X), pids, k)
    fd, fi = ops.masked_exact_topk(_t(Q), _t(X), mask, k)
    np.testing.assert_array_equal(gi.numpy(), fi.numpy())
    full = ops.exact_distances(_t(Q), _t(X), backend="ref").numpy()
    np.testing.assert_allclose(gd.numpy(), np.take_along_axis(full, fi.numpy().astype(np.int64), 1),
                               rtol=1e-5, atol=1e-4)


def test_int8_ties_take_the_lowest_id():
    """Duplicated integer rows tie exactly in int8: the lowest id first."""
    X = np.tile(np.array([[3, 0], [1, 1], [1, 1], [2, 2]], np.float32), (3, 1))
    Q = np.array([[1, 1]], np.float32)
    for dtype in DTYPES:
        d, i = ops.masked_exact_topk(_t(Q), _t(X), _t(np.ones(12, bool)), 6, dtype=dtype)
        assert i[0, :6].tolist() == [1, 2, 5, 6, 9, 10]


# -- dense ADC scan ----------------------------------------------------------------

def _pq_inputs(seed=5, q=6, n=700, m=8, kc=256, d=32):
    rng = np.random.default_rng(seed)
    book = rng.normal(size=(m, kc, d // m)).astype(np.float32)
    Q = rng.normal(size=(q, d)).astype(np.float32)
    codes = rng.integers(0, kc, size=(n, m)).astype(np.uint8)
    return book, Q, codes


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_adc_scores_match_reference(ref, metric):
    from repro.core import pq as jpq

    book, Q, codes = _pq_inputs()
    want = np.asarray(jpq.adc_scores(jpq.PQCodebook(book, metric), Q, codes, backend="ref"))
    got = adc_scores(PQCodebook(book, metric), Q, codes, device="cpu")
    assert got.shape == (Q.shape[0], codes.shape[0])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# (7, 1025, 3, 7) and (9, 2049, 3, 7): m = 3, K = 7, and Q and N that are
# multiples of no tile (the kernel's 4-query groups, its 1,024-row ranges)
@pytest.mark.parametrize("q,n,m,kc", [(5, 300, 4, 16), (7, 1025, 3, 7), (9, 2049, 3, 7)])
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_pq_scan_and_topk_match_reference(ref, backend, q, n, m, kc):
    jnp, jops, _ = ref
    rng = np.random.default_rng(9)
    luts = rng.random((q, m, kc)).astype(np.float32)
    codes = rng.integers(0, kc, size=(n, m)).astype(np.uint8)
    want = np.asarray(jops.pq_scan(jnp.asarray(luts), jnp.asarray(codes), backend=backend))
    got = ops.pq_scan(_t(luts), _t(codes))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    wd, wi = jops.pq_scan_topk(jnp.asarray(luts), jnp.asarray(codes), 12, backend=backend)
    gd, gi = ops.pq_scan_topk(_t(luts), _t(codes), 12)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)


def test_new_wrappers_refuse_cpu_tensors_and_count_nothing():
    Q, X, plane, k = _case("basic")
    _build.reset_launch_counts()
    rows = _t(plane.astype(np.uint8))
    for dtype in DTYPES:
        qs, qscale = pref.quantize_points(_t(Q), dtype)
        xs, xscale = pref.quantize_points(_t(X), dtype)
        scales = (qscale, xscale) if dtype == "int8" else None
        with pytest.raises(ValueError, match="CUDA tensor"):
            kmasked.masked_exact_topk(qs, xs, rows, None, k, scales=scales)
        ops.masked_exact_topk(_t(Q), _t(X), _t(plane[0]), k, dtype=dtype)
    luts = torch.rand((2, 4, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kpq.pq_scan(luts, torch.zeros((10, 4), dtype=torch.uint8))
    ops.pq_scan(luts, torch.zeros((10, 4), dtype=torch.uint8))
    assert _build.launch_counts() == {}


def test_unknown_score_dtype_raises():
    Q, X, plane, k = _case("basic")
    with pytest.raises(ValueError, match="score dtype"):
        ops.masked_exact_topk(_t(Q), _t(X), _t(plane[0]), k, dtype="fp8")


# -- the CUDA kernels against their plain versions (card only) ----------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.as_tensor(np.asarray(a)).to(dev) for a in arrays]


def _assert_close_ids(got, want, tol):
    """Distances within ``tol`` (5e-3 relative on top), the same (+inf, -1)
    sentinels, and ids equal except where the plain version's distances tie
    within the tolerance with a neighbouring slot.  ``want`` may hold one
    slot more than ``got`` (the plain version's top-(k + 1)): a tie of slot
    k - 1 with the first row left out then lets the ids differ too."""
    gd, gi = (a.cpu() for a in got)
    nd, ni = (a.cpu() for a in want)
    k = gd.shape[1]
    wd, wi = nd[:, :k], ni[:, :k]
    assert torch.equal(torch.isinf(gd), torch.isinf(wd))
    assert torch.equal(gi < 0, torch.isinf(gd))
    fin = torch.isfinite(wd)
    np.testing.assert_allclose(gd[fin].numpy(), wd[fin].numpy(), rtol=1e-5, atol=tol)
    d = torch.where(torch.isfinite(nd), nd, torch.full_like(nd, 1e30))
    gap = torch.full_like(d, float("inf"))
    gap[:, 1:] = (d[:, 1:] - d[:, :-1]).abs()
    gap_r = torch.full_like(d, float("inf"))
    gap_r[:, :-1] = (d[:, 1:] - d[:, :-1]).abs()
    tied = (torch.minimum(gap, gap_r) <= tol + 1e-5 * d.abs())[:, :k]
    assert not bool(((gi != wi) & ~tied).any())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_quantized_scans_match_plain(cuda, case, dtype, metric):
    Q, X, plane, k = _case(case)
    q, x, m, p = _on(cuda, Q, X, plane[0], plane)
    unique, idx = _dedup(plane, max(1, Q.shape[0] // 2))
    u, i = _on(cuda, unique, idx)
    # bf16 sums run in another order than the plain dot; int8 crosses are
    # exact, scaled once: both within 1e-5 of |q|^2 + |x|^2
    tol = 1e-5 * (float(np.max(np.sum(Q * Q, 1))) + float(np.max(np.sum(X * X, 1))) + 1.0)
    for fn, args in ((ops.masked_exact_topk, (q, x, m)), (ops.masked_exact_topk_multi, (q, x, p)),
                     (ops.masked_exact_topk_dedup, (q, x, u, i))):
        got = fn(*args, k, metric=metric, dtype=dtype)
        want = fn(*args, k, metric=metric, dtype=dtype, backend="ref")
        torch.cuda.synchronize()
        _assert_close_ids(got, want, tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_quantized_scans_launch_their_kernels(cuda, dtype):
    Q, X, plane, k = _case("chunks")
    q, x, m, p = _on(cuda, Q, X, plane[0], plane)
    _build.reset_launch_counts()
    stored, x_scale = pref.quantize_points(x, dtype)
    ops.masked_exact_topk(q, stored, m, k, dtype=dtype, x_scale=x_scale)
    ops.masked_exact_topk_multi(q, stored, p, k, dtype=dtype, x_scale=x_scale)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {f"masked_exact_topk_{dtype}": 1,
                                      f"masked_exact_topk_multi_{dtype}": 1}


@pytest.mark.parametrize("shape", [(5, 700, 8, 256), (3, 4097, 32, 256), (1, 1, 4, 16),
                                   (9, 2049, 3, 7)])
def test_cuda_pq_scan_equals_plain_bit_for_bit(cuda, shape):
    q, n, m, kc = shape
    rng = np.random.default_rng(q * n)
    luts, codes = _on(cuda, rng.random((q, m, kc)).astype(np.float32),
                      rng.integers(0, kc, size=(n, m)).astype(np.uint8))
    got = ops.pq_scan(luts, codes)
    want = ops.pq_scan(luts, codes, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# codewords a subquantizer for each m: byte codes (m = 1, 3) and 16-byte
# code vectors (m = 16, 32, 64; m = 64 interleaves 2 queries, not 4)
PQ_K = {1: 16, 3: 7, 16: 256, 32: 256, 64: 256}


@pytest.mark.parametrize("m", sorted(PQ_K))
@pytest.mark.parametrize("n", [1, 1023, 1025, 250_000])
@pytest.mark.parametrize("q", [1, 7, 100])
def test_cuda_pq_scan_grid_equals_plain_bit_for_bit(cuda, m, n, q):
    """m, N one either side of a 1,024-row range and Q one either side of
    the 4-query groups: the kernel's bits equal the plain version's."""
    kc = PQ_K[m]
    rng = np.random.default_rng(m * 7 + n + q)
    luts, codes = _on(cuda, rng.random((q, m, kc)).astype(np.float32),
                      rng.integers(0, kc, size=(n, m)).astype(np.uint8))
    got = ops.pq_scan(luts, codes)
    want = ops.pq_scan(luts, codes, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_cuda_pq_scan_unaligned_codes(cuda):
    """Codes that start one byte past a 16-byte boundary take the byte loads."""
    rng = np.random.default_rng(3)
    luts, codes = _on(cuda, rng.random((7, 32, 256)).astype(np.float32),
                      rng.integers(0, 256, size=(3000, 32)).astype(np.uint8))
    odd = torch.empty(3000 * 32 + 1, dtype=torch.uint8, device=cuda)[1:].view(3000, 32)
    odd.copy_(codes)
    assert odd.data_ptr() % 16
    got = ops.pq_scan(luts, odd)
    want = ops.pq_scan(luts, codes, backend="ref")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# -- the chunked select's edges in the quantized scans (card only) ------------

def _select_case(name, n=1800, q=4, d=16):
    """(queries, points, plane) over four 512-row chunks, the last short."""
    rng = np.random.default_rng(n + len(name) + 7)
    X = rng.normal(size=(n, d)).astype(np.float32)
    Q = rng.normal(size=(q, d)).astype(np.float32)
    plane = rng.random((q, n)) < 0.5
    if name == "equal":  # every score of a query equal: ties across chunks
        X[:] = 1.0
        plane[:] = True
    elif name == "gaps":  # chunks with fewer live rows than kc, one fully masked between
        plane[:] = False
        plane[:, :3] = True
        plane[:, 1024:1124] = True
        plane[:, 1700:1790] = True
    elif name == "zeros":  # zero query rows and zero points: ip scores of 0.0, tied by id
        Q[::2] = 0.0
        X[::3] = 0.0
    return Q, X, plane


@pytest.mark.parametrize("case", ["random", "equal", "gaps", "zeros"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_quantized_select_edges_match_plain(cuda, case, dtype, metric):
    """k = 160 (the quantized pool) over several chunks: random scores,
    every score equal (ids 0 .. 159), chunks with few or no live rows, and
    ip scores of 0.0 on zero query rows (ids in order)."""
    Q, X, plane = _select_case(case)
    k = planner.quant_guard_pool(40)
    q, x, m, p = _on(cuda, Q, X, plane[0], plane)
    unique, idx = _dedup(plane, 2)
    u, i = _on(cuda, unique, idx)
    tol = 1e-5 * (float(np.max(np.sum(Q * Q, 1))) + float(np.max(np.sum(X * X, 1))) + 1.0)
    for fn, args, masks in ((ops.masked_exact_topk, (q, x, m), plane[[0] * len(Q)]),
                            (ops.masked_exact_topk_multi, (q, x, p), plane),
                            (ops.masked_exact_topk_dedup, (q, x, u, i), unique[idx])):
        got = fn(*args, k, metric=metric, dtype=dtype)
        want = fn(*args, k, metric=metric, dtype=dtype, backend="ref")
        torch.cuda.synchronize()
        _assert_close_ids(got, want, tol)
        tied = {"equal": range(len(Q)), "zeros": range(0, len(Q), 2) if metric == "ip" else ()}
        for qi in tied.get(case, ()):
            passing = np.flatnonzero(masks[qi])[:k].tolist()
            assert got[1][qi].tolist() == passing + [-1] * (k - len(passing)), (fn.__name__, qi)


# -- the tensor-core tiles' shapes (card only) ---------------------------------
# The bf16 and int8 tiles score on the tensor cores (mma.sync m16n8k16 for
# bf16, m16n8k32 for int8): a warp a 64-row unit of a 512-row chunk against
# every 8-query fragment of a tile of 16, 8 or 4 queries (the launch picks
# it from Q and N), features zero-padded to the next 16 (bf16) or 32 (int8);
# a unit no query of the tile may see is skipped.


def _unit_mask(q, n, rng, shift=True):
    """(Q, N) bool: by 64-row unit u (shifted by the query index when
    ``shift``), every row passes (u % 3 == 0), none (1) or one in ten (2)."""
    u = np.arange(n)[None, :] // 64 + (np.arange(q)[:, None] if shift else 0)
    sparse = rng.random((q, n)) < 0.1
    return np.where(u % 3 == 0, True, np.where(u % 3 == 1, False, sparse))


@pytest.mark.parametrize("q", [1, 8, 100, 129])
@pytest.mark.parametrize("d", [8, 33, 128])
@pytest.mark.parametrize("n", [64, 65, 1000, 4096, 20000])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_quantized_tile_shapes_match_plain(cuda, q, d, n, dtype, metric):
    """Q across the tile sizes, D = 8 and 33 (padded to the stage, unaligned
    rows) and 128, N either side of the 64-row unit and past the 512-row
    chunk (4,096: the phase-7 shard, where the launch takes 4-query tiles;
    20,000: 16-query tiles at Q = 100 and 129);
    row mask, dense and dedup'd plane with units full, empty and sparse;
    k from 1 to past the chunk: within the plain version's tolerance, ids
    equal outside ties."""
    rng = np.random.default_rng(q * 7919 + d * 31 + n)
    Q = rng.normal(size=(q, d)).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    plane = _unit_mask(q, n, rng)
    row = _unit_mask(1, n, rng, shift=False)[0]
    unique, idx = _dedup(plane, max(1, q // 2))
    qq, x, m, p, u, i = _on(cuda, Q, X, row, plane, unique, idx)
    tol = 1e-5 * (float(np.max(np.sum(Q * Q, 1))) + float(np.max(np.sum(X * X, 1))) + 1.0)
    for k in (1, 40, 160, 600):
        for fn, args in ((ops.masked_exact_topk, (qq, x, m)), (ops.masked_exact_topk_multi, (qq, x, p)),
                         (ops.masked_exact_topk_dedup, (qq, x, u, i))):
            got = fn(*args, k, metric=metric, dtype=dtype)
            want = fn(*args, k + 1, metric=metric, dtype=dtype, backend="ref")
            torch.cuda.synchronize()
            _assert_close_ids(got, want, tol)
