"""The port's autotuner (``repro_torch.kernels.autotune``) and its knob.

- The reference's four cases (``tests/test_kernels.py``) against the port:
  defaults on a cache miss; a fixture read, with a tile the flavor was not
  swept at rejected; ``DEFAULT_TILES`` among the candidates and the
  hysteresis in (0, 0.5); identical results across every candidate (here
  through the plain version, which ignores the tile).
- ``cache_key`` buckets (rows, D, flavor) as the reference's does.
- The masked ops resolve their tile as the reference's ``_tiles`` does:
  explicit values win, an invalid one raises, ``None`` asks the cache.
- The committed fixture was swept on the card and holds only candidates.
- On the card (``test_cuda_*``, skipped without one): every candidate of
  every masked flavor gives the default's dists and ids bit for bit, at
  the smoke's phase-2 shape and at the main path's 4,096-row shards.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import autotune, ops  # noqa: E402
from repro_torch.kernels import masked_topk as mt  # noqa: E402

MASKED = ("exact", "exact_bf16", "exact_int8", "pq", "unified")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture()
def no_fixture(tmp_path, monkeypatch):
    """The autotuner pointed at a missing fixture (every lookup a miss)."""
    monkeypatch.setattr(autotune, "_CACHE_PATH", tmp_path / "missing.json")
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def test_autotune_defaults_on_cache_miss(tmp_path):
    autotune.clear_cache()
    assert autotune.get_tiles(4096, 128, "exact", cache_path=tmp_path / "nope.json") \
        == autotune.DEFAULT_TILES
    # an unknown flavor is a miss too, never an error
    assert autotune.get_tiles(4096, 128, "no-such-flavor") == autotune.DEFAULT_TILES
    autotune.clear_cache()


def test_autotune_reads_fixture_and_rejects_unknown_tiles(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({
        "tiles": {
            autotune.cache_key(4096, 128, "exact"): [16, 512],
            autotune.cache_key(4096, 128, "pq"): [13, 77],  # never swept
            autotune.cache_key(4096, 128, "exact_bf16"): [32, 512],  # an f32 tile, not a bf16 one
            autotune.cache_key(4096, 128, "gather_rerank"): [8, 512],  # no knob
            autotune.cache_key(4096, 128, "unified"): "x",  # unreadable entry
        }
    }))
    autotune.clear_cache()
    assert autotune.get_tiles(4096, 128, "exact", cache_path=path) == (16, 512)
    # bucketing: 3000 rows round up to the same 4096 bucket
    assert autotune.get_tiles(3000, 128, "exact", cache_path=path) == (16, 512)
    # invalid tiles are discarded -> defaults
    for flavor in ("pq", "exact_bf16", "gather_rerank", "unified"):
        assert autotune.get_tiles(4096, 128, flavor, cache_path=path) == autotune.DEFAULT_TILES
    autotune.clear_cache()


def test_autotune_candidates_include_defaults():
    """Structural never-regress: the default tiling is always a candidate,
    of every flavor, and a challenger must beat it by the hysteresis
    margin; the default is the launch's own rule (tile 0) on the kernels'
    512-row chunk."""
    assert autotune.DEFAULT_TILES in autotune.CANDIDATES
    assert autotune.DEFAULT_TILES == (0, mt.CHUNK_ROWS) == (0, 512)
    assert 0.0 < autotune.HYSTERESIS < 0.5
    assert set(autotune.FLAVOR_CANDIDATES) == set(autotune.FLAVORS)
    for flavor, cands in autotune.FLAVOR_CANDIDATES.items():
        assert cands[0] == autotune.DEFAULT_TILES
        assert set(cands) <= set(autotune.CANDIDATES)
        assert all(tn == 512 for _, tn in cands)
    assert autotune.FLAVOR_CANDIDATES["gather_rerank"] == (autotune.DEFAULT_TILES,)


def _masked_inputs(seed=29, q=9, n=300, d=40, m=4, K=16):
    rng = np.random.default_rng(seed)
    return dict(
        queries=torch.from_numpy(rng.normal(size=(q, d)).astype(np.float32)),
        points=torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)),
        mask=torch.from_numpy(rng.random(n) < 0.5),
        masks=torch.from_numpy(rng.random((q, n)) < 0.5),
        luts=torch.from_numpy(rng.normal(size=(q, m, K)).astype(np.float32)),
        codes=torch.from_numpy(rng.integers(0, K, size=(n, m)).astype(np.uint8)),
        flavor=torch.from_numpy(rng.random(q) < 0.5),
    )


def _call(flavor, x, tile_q, k=7, device=None):
    g = {k_: (v.to(device) if device is not None else v) for k_, v in x.items()}
    if flavor.startswith("exact"):
        dtype = {"exact": "f32", "exact_bf16": "bf16", "exact_int8": "int8"}[flavor]
        one = ops.masked_exact_topk(g["queries"], g["points"], g["mask"], k, dtype=dtype,
                                    tile_q=tile_q, tile_n=512)
        multi = ops.masked_exact_topk_multi(g["queries"], g["points"], g["masks"], k, dtype=dtype,
                                            tile_q=tile_q)
        return one + multi
    if flavor == "pq":
        return (ops.masked_pq_topk(g["luts"], g["codes"], g["mask"], k, tile_q=tile_q)
                + ops.masked_pq_topk_multi(g["luts"], g["codes"], g["masks"], k, tile_q=tile_q))
    return ops.unified_masked_topk(g["queries"], g["points"], g["luts"], g["codes"], g["masks"],
                                   g["flavor"], k, tile_q=tile_q)


@pytest.mark.parametrize("flavor", MASKED)
def test_autotune_tiles_give_identical_results(flavor):
    """Whatever tiles the autotuner picks, the op answers identically —
    tiling is a performance knob, never a semantics knob (on the CPU the
    plain version ignores the tile; every candidate is one the op takes)."""
    x = _masked_inputs()
    base = None
    for tq, _tn in autotune.FLAVOR_CANDIDATES[flavor]:
        got = _call(flavor, x, tq)
        if base is None:
            base = got
            continue
        for a, b in zip(got, base):
            assert torch.equal(a, b)


def test_cache_key_matches_the_reference():
    pytest.importorskip("jax")
    from repro.kernels import autotune as ref_autotune

    rows = [1, 127, 128, 129, 2048, 3000, 4096, 8191, 8192, 250_000, 262_144, 1 << 20, 5 << 20]
    dims = [1, 4, 8, 32, 127, 128, 129, 256, 768, 2048]
    for flavor in ref_autotune.FLAVORS:
        for n in rows:
            for d in dims:
                assert autotune.cache_key(n, d, flavor) == ref_autotune.cache_key(n, d, flavor)
    assert autotune.FLAVORS == ref_autotune.FLAVORS
    assert autotune.HYSTERESIS == ref_autotune.HYSTERESIS


def test_masked_ops_resolve_tiles(no_fixture, tmp_path, monkeypatch):
    # a miss is the launch's own rule
    assert ops._tiles(None, None, 4096, 128, "exact") == 0
    # explicit values win, and must be ones the launch takes
    assert ops._tiles(8, 512, 4096, 128, "exact") == 8
    assert ops._tiles(4, None, 4096, 128, "exact_int8") == 4
    for flavor, bad in (("exact", 4), ("exact_bf16", 32), ("pq", 16), ("unified", 3)):
        with pytest.raises(ValueError, match="tile_q"):
            ops._tiles(bad, None, 4096, 128, flavor)
    with pytest.raises(ValueError, match="tile_n"):
        ops._tiles(None, 128, 4096, 128, "exact")
    x = _masked_inputs()
    with pytest.raises(ValueError, match="tile_q"):
        ops.masked_exact_topk(x["queries"], x["points"], x["mask"], 3, tile_q=5)
    # None asks the cache for the call's bucket (pq: D is the codes' m)
    path = tmp_path / "cache.json"
    path.write_text(json.dumps({"tiles": {autotune.cache_key(4096, 128, "exact"): [16, 512],
                                          autotune.cache_key(4096, 4, "pq"): [2, 512]}}))
    monkeypatch.setattr(autotune, "_CACHE_PATH", path)
    autotune.clear_cache()
    assert ops._tiles(None, None, 3000, 100, "exact") == 16
    assert ops._tiles(None, None, 4096, 4, "pq") == 2
    assert ops._tiles(None, None, 4096, 128, "unified") == 0


def test_committed_fixture_was_swept_on_the_card():
    raw = json.loads(autotune._CACHE_PATH.read_text())
    meta = raw["meta"]
    assert meta["backend"] == "cuda" and "H100" in meta["device"]
    assert meta["nvidia_smi"].count(",") == 1  # "name, power limit"
    assert meta["hysteresis"] == autotune.HYSTERESIS
    assert raw["tiles"]
    for key, tiles in raw["tiles"].items():
        flavor = key.split(":", 1)[0]
        assert tuple(tiles) in autotune.FLAVOR_CANDIDATES[flavor], key
        # every recorded winner beat the default by the margin, or is it
        t = raw["times_ms"][key]
        if tuple(tiles) != autotune.DEFAULT_TILES:
            assert t["%dx%d" % tuple(tiles)] < t["0x512"] * (1 - autotune.HYSTERESIS), key
    autotune.clear_cache()
    for key, tiles in raw["tiles"].items():
        flavor, n, d = key.split(":")
        assert autotune.get_tiles(int(n[1:]), int(d[1:]), flavor) == tuple(tiles)


def _shape_inputs(q, n, d, seed):
    return _masked_inputs(seed=seed, q=q, n=n, d=d, m=32, K=256)


@pytest.mark.parametrize("q,n,d", [(100, 250_000, 128), (100, 4096, 128), (33, 1000, 70)])
def test_cuda_every_tile_gives_the_default_bits(cuda, q, n, d):
    """Every candidate of every masked flavor: the default's dists and ids
    bit for bit on the card (the smoke's phase-2 shape, the main path's
    4,096-row shards, and a ragged shape with D % 4 != 0)."""
    x = _shape_inputs(q, n, d, seed=n)
    for flavor in MASKED:
        base = _call(flavor, x, 0, k=40, device=cuda)
        for tq, _tn in autotune.FLAVOR_CANDIDATES[flavor][1:]:
            got = _call(flavor, x, tq, k=40, device=cuda)
            for a, b in zip(got, base):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (flavor, tq)


def test_cuda_sweep_point_holds_the_bits(cuda):
    for flavor in autotune.FLAVORS:
        best, times = autotune.sweep_point(flavor, 2048, 128, repeat=2)
        assert best in autotune.FLAVOR_CANDIDATES[flavor]
        assert set(times) == set(autotune.FLAVOR_CANDIDATES[flavor])
        assert all(t > 0 for t in times.values())
