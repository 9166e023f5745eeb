"""Exact-distance kernels: the dense rerank matrix and the pooled
gather-rerank (CUDA sources in ``csrc/rerank.cu``).

- :func:`rerank_distances` replaces ``rerank_distances_pallas``
  (``repro/kernels/rerank.py``): the (Q, N) matrix of |q|^2 - 2 q.x + |x|^2,
  or -q.x.  The kernel picks one of two tiles from the shape (both give
  the same bits); its launches are counted by tile, ``("small",)`` (Stage
  B's shape) or ``("large",)`` (the ground truth's), see
  :func:`tile_class`.
- :func:`gather_rerank` replaces ``gather_rerank_pallas``: exact distances
  from each query to its own P candidate ids, ascending top-k, (+inf, -1)
  for sentinel slots.  Its launches are counted by (P, k).

Each wrapper takes CUDA tensors only and raises for any other; the choice
between a kernel and its plain version (``kernels/ref.py``) is made in
``kernels/ops.py``.  The kernel notes (what bounds each one on the card,
and the design) are in the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_METRIC = {"l2": 0, "ip": 1}


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _lib() -> ctypes.CDLL:
    lib = _build.load("rerank")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rerank_distances.argtypes = [vp, vp, vp, ci, ci, ci, ci, vp]
        lib.rerank_distances.restype = ci
        lib.rerank_tile.argtypes = [ci, ci, ci]
        lib.rerank_tile.restype = ci
        lib.gather_rerank.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.gather_rerank.restype = ci
        lib._typed = True
    return lib


TILES = ("small", "large")


def tile_class(q: int, n: int, d: int) -> tuple:
    """The launch shape under which a (Q, N, D) ``rerank_distances`` call is
    counted: the tile the kernel's launcher takes for it."""
    return (TILES[_lib().rerank_tile(q, n, d)],)


def rerank_distances(
    queries: torch.Tensor, points: torch.Tensor, *, metric: str = "l2"
) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) f32 distance matrix (squared L2 or -IP)."""
    check_cuda("queries", queries, torch.float32, 2)
    check_cuda("points", points, torch.float32, 2)
    q, d = queries.shape
    n, d2 = points.shape
    if d != d2:
        raise ValueError(f"feature dims differ: {d} vs {d2}")
    out = torch.empty((q, n), dtype=torch.float32, device=queries.device)
    if q == 0 or n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(queries.device):
        rc = lib.rerank_distances(
            queries.data_ptr(), points.data_ptr(), out.data_ptr(),
            q, n, d, _METRIC[metric], _stream(queries),
        )
    _build.check(lib, rc, "rerank_distances")
    _build.count_launch("rerank_distances", shape=tile_class(q, n, d))
    return out


def gather_rerank(
    queries: torch.Tensor,
    points: torch.Tensor,
    pool_ids: torch.Tensor,
    k: int,
    *,
    metric: str = "l2",
):
    """Pooled exact rerank: queries (Q, D) f32, points (N, D) f32, pool_ids
    (Q, P) int32 (ids < 0 or >= N are sentinels) -> (dists (Q, k) f32, ids
    (Q, k) int32), ascending, (+inf, -1) beyond the live pool."""
    check_cuda("queries", queries, torch.float32, 2)
    check_cuda("points", points, torch.float32, 2)
    check_cuda("pool_ids", pool_ids, torch.int32, 2)
    q, d = queries.shape
    n, d2 = points.shape
    if d != d2 or pool_ids.shape[0] != q:
        raise ValueError(
            f"shape mismatch: queries {tuple(queries.shape)}, points "
            f"{tuple(points.shape)}, pool_ids {tuple(pool_ids.shape)}"
        )
    p = pool_ids.shape[1]
    k = int(k)
    out_d = torch.empty((q, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((q, k), dtype=torch.int32, device=queries.device)
    if q == 0 or k == 0:
        return out_d, out_i
    lib = _lib()
    with torch.cuda.device(queries.device):
        rc = lib.gather_rerank(
            queries.data_ptr(), points.data_ptr(), pool_ids.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            q, n, d, p, k, _METRIC[metric], _stream(queries),
        )
    _build.check(lib, rc, "gather_rerank")
    _build.count_launch("gather_rerank", shape=(p, k))
    return out_d, out_i
