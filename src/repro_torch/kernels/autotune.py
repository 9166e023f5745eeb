"""Measured query-tile selection for the masked top-k launches.

Port of ``repro/kernels/autotune.py``.  The reference picks a Pallas
``(tile_q, tile_n)`` per ``(shard row-count, D, flavor)`` bucket from a
one-time measured sweep committed as ``autotune_cache.json``; this module
does the same for the H100 kernels, with the knob the CUDA launch has:

- ``tile_q`` is the masked launch's query tile (``csrc/masked_topk.cu``):
  the f32 tile takes 32, 16 or 8 queries (the unified launch's exact tiles
  too), the bf16 / int8 tensor-core tiles 16, 8 or 4, the ADC tile 8, 4, 2
  or 1 (never above its LUT budget, ``masked_topk_adc_tile``), and 0 is
  the launch's own rule (f32 32; bf16 / int8 the largest tile that still
  gives every SM a block; ADC the budget's tile).
- ``tile_n`` is the kernel's 512-row chunk, fixed: it sizes the
  ``(Q, chunks, kc)`` scratch the wrapper allocates.  The pair keeps the
  reference's shape and every candidate has ``tile_n == 512``.
- ``gather_rerank`` has no knob (``csrc/rerank.cu`` picks its tile by
  shape): :func:`get_tiles` returns the default for it, and the sweep
  records the default.

:data:`DEFAULT_TILES` is ``(0, 512)``, the launch's own rule, so a cache
miss, a missing fixture or an unknown flavor launches exactly what the
kernels launched before the knob: the same grid, the same bits.  As in the
reference, a challenger displaces the default only when it beats it by
more than :data:`HYSTERESIS`, and a fixture entry that is not one of its
flavor's candidates is ignored.

A tile is a performance knob, never a semantics knob: each query's score is
one ``__fmaf_rn`` chain (f32), one tensor-core accumulation (bf16), one
integer sum (int8) or one ``__fadd_rn`` chain (ADC) whichever queries share
its tile, and the chunk select orders by (score, row).  :func:`sweep_point`
holds every candidate's dists and ids bit for bit against the default's
and raises if one differs; no candidate has been removed for that.

The sweep runs on the card only (CUDA graph replay timed with CUDA events
after a warm-up, best of ``repeat``), on the reference's synthetic workload
(Q = 32, k = 32, 60 % of the rows passing, PQ m = 8, K = 256), and never on
the query path.  CLI (regenerates the committed fixture on an H100)::

    PYTHONPATH=src python -m repro_torch.kernels.autotune [--out PATH] [--repeat N]
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

from repro_torch.kernels.masked_topk import CHUNK_ROWS, QUERY_TILES

DEFAULT_TILES: Tuple[int, int] = (0, CHUNK_ROWS)

FLAVORS = ("exact", "exact_bf16", "exact_int8", "pq", "unified", "gather_rerank")

# every flavor's candidates: the default first, then the query tiles its
# launch takes (none for gather_rerank), each with the fixed 512-row chunk
FLAVOR_CANDIDATES: Dict[str, Tuple[Tuple[int, int], ...]] = {
    f: (DEFAULT_TILES,) + tuple((tq, CHUNK_ROWS) for tq in QUERY_TILES.get(f, ()))
    for f in FLAVORS
}

CANDIDATES: Tuple[Tuple[int, int], ...] = (DEFAULT_TILES,) + tuple(
    (tq, CHUNK_ROWS) for tq in sorted({t for ts in QUERY_TILES.values() for t in ts}, reverse=True))

HYSTERESIS = 0.05  # challenger must beat default by >5% to displace it

_CACHE_PATH = Path(__file__).with_name("autotune_cache.json")


def _bucket_rows(n_rows: int) -> int:
    """Next power of two, clamped to [128, 2**20] — one sweep point covers
    every shard whose row count rounds to the same bucket."""
    n = max(128, min(int(n_rows), 1 << 20))
    return 1 << (n - 1).bit_length()


def _bucket_dim(d: int) -> int:
    """Next multiple of 128 (the reference's wrappers pad the feature dim
    there)."""
    return max(128, ((int(d) + 127) // 128) * 128)


def cache_key(n_rows: int, d: int, flavor: str) -> str:
    return f"{flavor}:n{_bucket_rows(n_rows)}:d{_bucket_dim(d)}"


@functools.lru_cache(maxsize=1)
def _load_cache(path_str: str) -> Dict[str, Tuple[int, int]]:
    path = Path(path_str)
    if not path.exists():
        return {}
    try:
        raw = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):  # unreadable fixture → defaults
        return {}
    tiles = raw.get("tiles", {})
    out: Dict[str, Tuple[int, int]] = {}
    for key, val in tiles.items():
        try:
            tq, tn = int(val[0]), int(val[1])
        except (TypeError, ValueError, IndexError):
            continue
        # never trust tiles we didn't sweep for this flavor
        if (tq, tn) in FLAVOR_CANDIDATES.get(key.split(":", 1)[0], ()):
            out[key] = (tq, tn)
    return out


def get_tiles(
    n_rows: int, d: int, flavor: str, cache_path: Optional[Path] = None
) -> Tuple[int, int]:
    """Tile choice for a kernel dispatch: measured winner when the sweep has
    seen this ``(rows, D, flavor)`` bucket, :data:`DEFAULT_TILES` otherwise
    (cache miss, missing fixture, unknown flavor — never an error)."""
    cache = _load_cache(str(cache_path or _CACHE_PATH))
    return cache.get(cache_key(n_rows, d, flavor), DEFAULT_TILES)


def clear_cache() -> None:
    """Drop the memoized fixture (tests swap cache files)."""
    _load_cache.cache_clear()


# -- sweep (on the card; never runs on the query path) ------------------------


def _time_ms(fn, repeat: int = 3, inner: int = 10) -> float:
    """Device ms of one ``fn()``: ``inner`` calls captured in a CUDA graph
    after a warm-up, the graph replayed between CUDA events, best of
    ``repeat`` replays (the host's dispatch left out, so a microsecond
    kernel's tile shows)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeat):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / inner)
    del graph
    return best


def _workload(flavor: str, n_rows: int, d: int, seed: int = 0, device="cuda", q_n: int = 32,
              m_sub: int = 8):
    """Synthetic inputs for one sweep point, the reference's (Q = 32
    coalesced queries, k = 32, m = 8 / K = 256 PQ geometry), made with numpy
    and laid out as the kernels take them (mask bytes, uint8 codes, the
    stored bf16 / int8 matrices with their scales)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref

    rng = np.random.default_rng(seed)
    k = 32
    dev = torch.device(device)
    queries = torch.from_numpy(rng.standard_normal((q_n, d)).astype(np.float32)).to(dev)
    points = torch.from_numpy(rng.standard_normal((n_rows, d)).astype(np.float32)).to(dev)
    mask = torch.from_numpy((rng.random(n_rows) > 0.4).astype(np.uint8)).to(dev).reshape(1, -1)
    if flavor in ("exact", "exact_bf16", "exact_int8"):
        dtype = {"exact": "f32", "exact_bf16": "bf16", "exact_int8": "int8"}[flavor]
        xs, x_scale = ref.quantize_points(points, dtype)
        qs, q_scale = ref.quantize_points(queries, dtype)
        return {
            "queries": qs.contiguous(), "points": xs.contiguous(), "mask": mask, "k": k,
            "scales": (q_scale, x_scale) if dtype == "int8" else None,
        }
    K = 256
    luts = torch.from_numpy(rng.standard_normal((q_n, m_sub, K)).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, K, size=(n_rows, m_sub)).astype(np.uint8)).to(dev)
    if flavor == "pq":
        return {"luts": luts, "codes": codes, "mask": mask, "k": k}
    if flavor == "unified":
        masks = torch.from_numpy((rng.random((q_n, n_rows)) > 0.4).astype(np.uint8)).to(dev)
        flav = torch.from_numpy(rng.integers(0, 2, size=q_n).astype(bool)).to(dev)
        # the launch's query order and exact count, worked out once (the
        # wrapper reads the count back to the host, which a graph cannot)
        qperm = torch.sort(flav.to(torch.int32), stable=True).indices.to(torch.int32)
        return {
            "queries": queries, "points": points, "luts": luts, "codes": codes, "masks": masks,
            "rows": torch.arange(q_n, dtype=torch.int32, device=dev), "qperm": qperm.contiguous(),
            "n_exact": q_n - int(flav.sum()), "k": k,
        }
    if flavor == "gather_rerank":
        pool = torch.from_numpy(rng.integers(0, n_rows, size=(q_n, 128)).astype(np.int32)).to(dev)
        return {"queries": queries, "points": points, "pool_ids": pool, "k": k}
    raise ValueError(f"unknown flavor {flavor!r}")


def _dispatch(flavor: str, work, tile_q: int, tile_n: int):
    """One kernel launch of ``flavor`` on ``work`` at the tile (the kernel
    wrappers themselves: no host read-back, so a CUDA graph can hold it)."""
    from repro_torch.kernels import masked_topk, rerank

    if tile_n != DEFAULT_TILES[1]:
        raise ValueError(f"tile_n={tile_n}: the kernels' chunk is {DEFAULT_TILES[1]} rows")
    if flavor in ("exact", "exact_bf16", "exact_int8"):
        return masked_topk.masked_exact_topk(
            work["queries"], work["points"], work["mask"], None, work["k"],
            scales=work["scales"], tile_q=tile_q,
        )
    if flavor == "pq":
        return masked_topk.masked_pq_topk(
            work["luts"], work["codes"], work["mask"], None, work["k"], tile_q=tile_q)
    if flavor == "unified":
        q = work["queries"]
        return masked_topk._launch(
            "unified_masked_topk", q.shape[0], work["points"].shape[0], work["k"],
            device=q.device, queries=q, points=work["points"], luts=work["luts"],
            codes=work["codes"], mask_rows=work["masks"], row_index=work["rows"],
            qperm=work["qperm"], n_exact=work["n_exact"],
            tile_q=masked_topk.check_tile("unified", tile_q),
        )
    if flavor == "gather_rerank":
        if tile_q != DEFAULT_TILES[0]:
            raise ValueError("gather_rerank picks its tile by shape: only the default")
        return rerank.gather_rerank(work["queries"], work["points"], work["pool_ids"], work["k"])
    raise ValueError(f"unknown flavor {flavor!r}")


def sweep_point(flavor: str, n_rows: int, d: int, repeat: int = 3, device="cuda"):
    """Measure every candidate of ``flavor`` at one (rows, D) point on the
    card.  Returns (winning tiles, {tiles: device ms}).  The default wins
    ties and anything within :data:`HYSTERESIS` of it.  Raises if a
    candidate's dists or ids differ from the default's in any bit."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the autotune sweep measures the card: no CUDA device here")
    work = _workload(flavor, n_rows, d, device=device)
    base = _dispatch(flavor, work, *DEFAULT_TILES)
    times: Dict[Tuple[int, int], float] = {}
    for tq, tn in FLAVOR_CANDIDATES[flavor]:
        got = _dispatch(flavor, work, tq, tn)
        for a, b in zip(got, base):
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise RuntimeError(f"{flavor} at tile ({tq}, {tn}) changes the answer "
                                   f"({n_rows} rows, D = {d}): a tile is never a semantics knob")
        times[(tq, tn)] = _time_ms(lambda tq=tq, tn=tn: _dispatch(flavor, work, tq, tn), repeat)
    base_t = times[DEFAULT_TILES]
    best, best_t = DEFAULT_TILES, base_t
    for tiles, t in times.items():
        if t < best_t and t < base_t * (1.0 - HYSTERESIS):
            best, best_t = tiles, t
    return best, times


def _card_meta() -> Dict[str, str]:
    """The card's name and power limit as ``nvidia-smi`` gives them, and the
    torch and CUDA versions: what the fixture's times were measured on."""
    import torch

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        smi = "not read"
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": str(torch.version.cuda)}


def sweep(
    out_path: Optional[Path] = None,
    flavors=FLAVORS,
    row_counts=(2048, 8192),
    dims=(128, 256),
    repeat: int = 3,
) -> Dict[str, Tuple[int, int]]:
    """Run the sweep on the card and write the JSON fixture.  Keys collapse
    by bucket, so overlapping (rows, dims) points just overwrite each
    other."""
    tiles: Dict[str, Tuple[int, int]] = {}
    times_ms: Dict[str, Dict[str, float]] = {}
    for flavor in flavors:
        for n_rows in row_counts:
            for d in dims:
                best, times = sweep_point(flavor, n_rows, d, repeat=repeat)
                key = cache_key(n_rows, d, flavor)
                tiles[key] = best
                times_ms[key] = {f"{tq}x{tn}": round(t, 5) for (tq, tn), t in times.items()}
                print(f"{key}: {best}  "
                      + "  ".join(f"{tq}x{tn}={t:.4f}ms" for (tq, tn), t in times.items()),
                      flush=True)
    payload = {
        "meta": {
            "backend": "cuda",
            **_card_meta(),
            "candidates": {f: [list(c) for c in FLAVOR_CANDIDATES[f]] for f in flavors},
            "hysteresis": HYSTERESIS,
            "workload": "Q=32 k=32 m=8 K=256; device ms by CUDA-graph replay, best-of-%d" % repeat,
        },
        "tiles": {k: list(v) for k, v in sorted(tiles.items())},
        "times_ms": dict(sorted(times_ms.items())),
    }
    path = Path(out_path or _CACHE_PATH)
    path.write_text(json.dumps(payload, indent=2) + "\n")
    clear_cache()
    return tiles


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=_CACHE_PATH)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--rows", type=int, nargs="+", default=[2048, 8192],
                    help="shard row counts to sweep (add the main path's: 4096 262144)")
    ap.add_argument("--dims", type=int, nargs="+", default=[128, 256])
    args = ap.parse_args(argv)
    sweep(out_path=args.out, row_counts=tuple(args.rows), dims=tuple(args.dims),
          repeat=args.repeat)


if __name__ == "__main__":
    main()
