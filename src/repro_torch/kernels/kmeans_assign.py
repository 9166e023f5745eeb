"""Nearest-centroid assignment (CUDA source in ``csrc/kmeans_assign.cu``).

:func:`kmeans_assign` replaces ``kmeans_assign_pallas``
(``repro/kernels/kmeans_assign.py``): per point, the argmin (ties to the
lowest index) and the minimum of the expanded squared distance over K
centroids.  It takes CUDA tensors only and raises for any other; the plain
version (``ref.kmeans_assign``) is chosen in ``kernels/ops.py``.  The
kernel note is in the CUDA source.  Launches are counted by (D, K): PQ
encoding runs at D = 4, K = 256, shard ownership at D = 128.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rerank import _stream, check_cuda


def _lib() -> ctypes.CDLL:
    lib = _build.load("kmeans_assign")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kmeans_assign.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        lib.kmeans_assign.restype = ci
        lib._typed = True
    return lib


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor):
    """points (N, D) f32, centroids (K, D) f32 -> (assignments (N,) int32,
    squared distances (N,) f32)."""
    check_cuda("points", points, torch.float32, 2)
    check_cuda("centroids", centroids, torch.float32, 2)
    n, d = points.shape
    k, d2 = centroids.shape
    if d != d2:
        raise ValueError(f"feature dims differ: {d} vs {d2}")
    if k == 0:
        raise ValueError("no centroids")
    out_i = torch.empty((n,), dtype=torch.int32, device=points.device)
    out_d = torch.empty((n,), dtype=torch.float32, device=points.device)
    if n == 0:
        return out_i, out_d
    lib = _lib()
    with torch.cuda.device(points.device):
        rc = lib.kmeans_assign(
            points.data_ptr(), centroids.data_ptr(), out_i.data_ptr(),
            out_d.data_ptr(), n, k, d, _stream(points),
        )
    _build.check(lib, rc, "kmeans_assign")
    _build.count_launch("kmeans_assign", shape=(d, k))
    return out_i, out_d
