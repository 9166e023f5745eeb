"""Masked top-k kernels (CUDA source in ``csrc/masked_topk.cu``).

- :func:`masked_exact_topk` replaces ``masked_exact_topk_pallas`` and
  ``masked_exact_topk_multi_pallas`` (f32) of ``repro/kernels/masked_topk.py``:
  each query's k nearest rows of the point matrix among the rows its mask
  lets through, squared L2 in the expanded form or -IP.
- :func:`masked_pq_topk` replaces ``masked_pq_topk_pallas`` and
  ``masked_pq_topk_multi_pallas``: the same over PQ-ADC scores.
- :func:`unified_masked_topk` replaces ``unified_masked_topk_pallas``: each
  query scored by its own flavor in one launch.
- :func:`masked_exact_topk` on bf16 or int8 tensors replaces the
  reduced-precision scans of the two exact Pallas functions
  (``_masked_exact_kernel`` on bf16 inputs, ``_masked_exact_q_kernel``):
  the caller passes the stored (quantized) queries and points, and for
  int8 their two scales.

A mask is bytes: ``mask_rows`` (U, N) uint8 (nonzero = the row may win) and
``row_index`` (Q,) int32 naming each query's row, or ``row_index=None`` for
one row shared by every query.  Outputs are (dists (Q, k) f32, ids (Q, k)
int32), ascending, ties to the lowest id, (+inf, -1) past the passing rows.

``tile_q`` picks the launch's query tile (0: the launch's own rule, the
only choice before the autotuner); :data:`QUERY_TILES` lists what each
flavor takes.  It changes the grid, never a score.

Each wrapper takes CUDA tensors only and raises for any other; the choice
between a kernel and its plain version (``kernels/ref.py``) is made in
``kernels/ops.py``.  Launch counts: ``masked_exact_topk`` /
``masked_pq_topk`` for a shared row, ``*_multi`` for per-query rows (the two
Pallas functions each replaces), ``unified_masked_topk``; the quantized
scans count under the same names with ``_bf16`` / ``_int8`` appended.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rerank import _METRIC, check_cuda


def _lib() -> ctypes.CDLL:
    lib = _build.load("masked_topk")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.masked_topk.argtypes = [vp] * 7 + [ci] * 10 + [cf] * 2 + [vp] * 4 + [vp]
        lib.masked_topk.restype = ci
        lib.masked_topk_chunk_rows.argtypes = []
        lib.masked_topk_chunk_rows.restype = ci
        lib.masked_topk_adc_tile.argtypes = [ci, ci]
        lib.masked_topk_adc_tile.restype = ci
        lib._typed = True
    return lib


# the query tiles each flavor's launch takes besides 0 (the launch's rule):
# the f32 tile 32, 16 or 8 queries (the unified launch's exact tiles; its
# ADC tiles keep their own budget's), the tensor-core tiles 16, 8 or 4, the
# ADC tile 8, 4, 2 or 1 (capped by the LUT budget, masked_topk_adc_tile)
QUERY_TILES = {
    "exact": (32, 16, 8),
    "exact_bf16": (16, 8, 4),
    "exact_int8": (16, 8, 4),
    "pq": (8, 4, 2, 1),
    "unified": (32, 16, 8),
}
# rows a chunk (csrc CN): the (Q, chunks, kc) scratch's unit, fixed
CHUNK_ROWS = 512


def check_tile(flavor: str, tile_q: int) -> int:
    """``tile_q`` as an int if ``flavor``'s launch takes it; raises else."""
    tile_q = int(tile_q)
    if tile_q != 0 and tile_q not in QUERY_TILES[flavor]:
        raise ValueError(f"tile_q={tile_q} is not a query tile of the {flavor!r} launch "
                         f"(0 or one of {QUERY_TILES[flavor]})")
    return tile_q


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_mask(mask_rows: torch.Tensor, row_index: Optional[torch.Tensor], q: int, n: int):
    check_cuda("mask_rows", mask_rows, torch.uint8, 2)
    if mask_rows.shape[1] != n or mask_rows.shape[0] < 1:
        raise ValueError(f"mask_rows must be (U >= 1, {n}), got {tuple(mask_rows.shape)}")
    if row_index is not None:
        check_cuda("row_index", row_index, torch.int32, 1)
        if row_index.shape[0] != q:
            raise ValueError(f"row_index must be ({q},), got {tuple(row_index.shape)}")


def _launch(
    name: str,
    q: int,
    n: int,
    k: int,
    *,
    device: torch.device,
    queries=None,
    points=None,
    luts=None,
    codes=None,
    mask_rows: torch.Tensor,
    row_index: Optional[torch.Tensor],
    qperm: Optional[torch.Tensor] = None,
    n_exact: int,
    metric: str = "l2",
    kind: int = 0,
    scales=(1.0, 1.0),
    tile_q: int = 0,
):
    out_d = torch.full((q, k), float("inf"), dtype=torch.float32, device=device)
    out_i = torch.full((q, k), -1, dtype=torch.int32, device=device)
    if q == 0 or n == 0 or k == 0:
        return out_d, out_i  # nothing passes: all sentinels, no launch
    lib = _lib()
    cn = lib.masked_topk_chunk_rows()
    chunks, kc = -(-n // cn), min(k, cn)
    part_d = torch.empty((q, chunks, kc), dtype=torch.float32, device=device)
    part_i = torch.empty((q, chunks, kc), dtype=torch.int32, device=device)
    d = queries.shape[1] if queries is not None else 0
    m, kcode = (luts.shape[1], luts.shape[2]) if luts is not None else (0, 0)
    with torch.cuda.device(device):
        rc = lib.masked_topk(
            _ptr(queries), _ptr(points), _ptr(luts), _ptr(codes),
            mask_rows.data_ptr(), _ptr(row_index), _ptr(qperm),
            q, n, d, m, kcode, _METRIC[metric], n_exact, k, kind, tile_q,
            float(scales[0]), float(scales[1]),
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _build.check(lib, rc, name)
    _build.count_launch(name)
    return out_d, out_i


def _check_adc(luts: torch.Tensor, codes: torch.Tensor, q: int, n: int) -> None:
    check_cuda("luts", luts, torch.float32, 3)
    check_cuda("codes", codes, torch.uint8, 2)
    if luts.shape[0] != q or codes.shape[0] != n or codes.shape[1] != luts.shape[1]:
        raise ValueError(
            f"shape mismatch: luts {tuple(luts.shape)}, codes {tuple(codes.shape)}"
        )
    if luts.shape[2] > 256:
        raise ValueError(f"uint8 codes address at most 256 codewords, got K={luts.shape[2]}")
    if luts.shape[0] and _lib().masked_topk_adc_tile(luts.shape[1], luts.shape[2]) <= 0:
        raise ValueError(f"one query's LUT (m={luts.shape[1]}, K={luts.shape[2]}) "
                         "does not fit the kernel's shared memory")


# element kind of the exact scan (the kernel's template argument) and the
# suffix of its launch count, by the dtype of the stored queries and points
_KINDS = {torch.float32: (0, ""), torch.bfloat16: (1, "_bf16"), torch.int8: (2, "_int8")}


def masked_exact_topk(
    queries: torch.Tensor,
    points: torch.Tensor,
    mask_rows: torch.Tensor,
    row_index: Optional[torch.Tensor],
    k: int,
    *,
    metric: str = "l2",
    scales=None,
    tile_q: int = 0,
):
    """Masked exact top-k: queries (Q, D), points (N, D), both f32, both
    bf16, or both int8 with ``scales`` = (q_scale, x_scale)."""
    if points.dtype not in _KINDS:
        raise ValueError(f"points must be f32, bf16 or int8, got {points.dtype}")
    check_cuda("queries", queries, points.dtype, 2)
    check_cuda("points", points, points.dtype, 2)
    kind, suffix = _KINDS[points.dtype]
    if (scales is None) != (kind != 2):
        raise ValueError("scales (q_scale, x_scale) go with int8 inputs, and only with them")
    q, n = queries.shape[0], points.shape[0]
    if queries.shape[1] != points.shape[1]:
        raise ValueError(f"feature dims differ: {queries.shape[1]} vs {points.shape[1]}")
    _check_mask(mask_rows, row_index, q, n)
    name = "masked_exact_topk" if row_index is None else "masked_exact_topk_multi"
    tile_q = check_tile("exact" + suffix, tile_q)
    return _launch(
        name + suffix, q, n, int(k), device=queries.device, queries=queries, points=points,
        mask_rows=mask_rows, row_index=row_index, n_exact=q, metric=metric, kind=kind,
        scales=scales or (1.0, 1.0), tile_q=tile_q,
    )


def masked_pq_topk(
    luts: torch.Tensor,
    codes: torch.Tensor,
    mask_rows: torch.Tensor,
    row_index: Optional[torch.Tensor],
    k: int,
    *,
    tile_q: int = 0,
):
    """Masked PQ-ADC top-k: luts (Q, m, K) f32, codes (N, m) uint8."""
    q, n = luts.shape[0], codes.shape[0]
    _check_adc(luts, codes, q, n)
    _check_mask(mask_rows, row_index, q, n)
    name = "masked_pq_topk" if row_index is None else "masked_pq_topk_multi"
    return _launch(
        name, q, n, int(k), device=luts.device, luts=luts, codes=codes,
        mask_rows=mask_rows, row_index=row_index, n_exact=0, tile_q=check_tile("pq", tile_q),
    )


def unified_masked_topk(
    queries: torch.Tensor,
    points: torch.Tensor,
    luts: torch.Tensor,
    codes: torch.Tensor,
    mask_rows: torch.Tensor,
    row_index: Optional[torch.Tensor],
    flavor: torch.Tensor,
    k: int,
    *,
    metric: str = "l2",
    tile_q: int = 0,
):
    """Mixed-flavor masked top-k: ``flavor`` (Q,) bool, True = the query
    scores by PQ-ADC (luts, codes), False = full precision (points)."""
    check_cuda("queries", queries, torch.float32, 2)
    check_cuda("points", points, torch.float32, 2)
    check_cuda("flavor", flavor, torch.bool, 1)
    q, n = queries.shape[0], points.shape[0]
    if queries.shape[1] != points.shape[1] or flavor.shape[0] != q:
        raise ValueError(
            f"shape mismatch: queries {tuple(queries.shape)}, points {tuple(points.shape)}, "
            f"flavor {tuple(flavor.shape)}"
        )
    _check_adc(luts, codes, q, n)
    _check_mask(mask_rows, row_index, q, n)
    # exact queries first, then ADC: each tile of the launch scores one flavor
    qperm = torch.sort(flavor.to(torch.int32), stable=True).indices.to(torch.int32)
    n_exact = q - int(flavor.sum())
    return _launch(
        "unified_masked_topk", q, n, int(k), device=queries.device, queries=queries,
        points=points, luts=luts, codes=codes, mask_rows=mask_rows, row_index=row_index,
        qperm=qperm.contiguous(), n_exact=n_exact, metric=metric,
        tile_q=check_tile("unified", tile_q),
    )
