"""Public dispatch for the kernels of the unfiltered DiskANN path.

Backend contract (as ``repro/kernels/ops.py``, with the Pallas backend
replaced by the CUDA kernels):

- ``backend="auto"`` → the CUDA kernel for CUDA tensors, the plain PyTorch
  version (``kernels/ref.py``) for CPU tensors.  A CUDA tensor never falls
  back to the plain version: a failed build or launch raises.
- ``backend="ref"``  → the plain version always (tests and the kernel
  comparisons in ``chip_smoke.py``).

The kernels take ragged shapes themselves, so nothing is padded here.
Inputs are coerced to contiguous f32 (ids to int32) on their own device.
The masked, ADC-scan and quantized ops arrive with the slices that port
their kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.kmeans_assign import kmeans_assign as _kmeans_assign_kernel
from repro_torch.kernels.rerank import gather_rerank as _gather_rerank_kernel
from repro_torch.kernels.rerank import rerank_distances as _rerank_distances_kernel

BACKENDS = ("auto", "ref")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises on a mix of devices."""
    kinds = {t.device.type for t in tensors}
    if len(kinds) > 1 or (kinds and kinds != {"cpu"} and kinds != {"cuda"}):
        raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")
    return kinds == {"cpu"}


def _use_kernel(backend: str, *tensors: torch.Tensor) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    return backend == "auto" and not on_cpu(*tensors)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


# -- exact distances ---------------------------------------------------------

def exact_distances(
    queries: torch.Tensor,
    points: torch.Tensor,
    *,
    metric: str = "l2",
    backend: str = "auto",
) -> torch.Tensor:
    """(Q, D) x (N, D) -> (Q, N) distance matrix (squared L2 or -IP)."""
    q, x = _f32(queries), _f32(points)
    if _use_kernel(backend, q, x):
        return _rerank_distances_kernel(q, x, metric=metric)
    fn = ref.l2_distances if metric == "l2" else ref.ip_distances
    return fn(q, x)


def exact_topk(
    queries: torch.Tensor,
    points: torch.Tensor,
    k: int,
    *,
    metric: str = "l2",
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k nearest: returns (distances (Q, k), indices (Q, k))."""
    d = exact_distances(queries, points, metric=metric, backend=backend)
    vals, idx = torch.topk(d, int(k), dim=1, largest=False, sorted=True)
    return vals, idx


# -- pooled gather-rerank -----------------------------------------------------

def gather_rerank(
    queries: torch.Tensor,
    points: torch.Tensor,
    pool_ids: torch.Tensor,
    k: int,
    *,
    metric: str = "l2",
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-precision rerank of per-query candidate pools: (Q, D) queries x
    (N, D) points under (Q, P) ``pool_ids`` (row q = query q's candidate
    ids; slots < 0 or >= N are sentinels) -> (dists (Q, k), ids (Q, k)),
    ascending, (+inf, -1) beyond the live pool.  ``k`` may exceed P."""
    q, x = _f32(queries), _f32(points)
    pids = pool_ids.to(device=q.device, dtype=torch.int32)
    n0 = x.shape[0]
    # out-of-range ids (stale pools, clipped host fills) become sentinels
    pids = torch.where((pids < 0) | (pids >= n0), -1, pids).contiguous()
    if _use_kernel(backend, q, x, pids):
        return _gather_rerank_kernel(q, x, pids, int(k), metric=metric)
    return ref.gather_rerank(q, x, pids, int(k), metric=metric)


# -- k-means assignment -------------------------------------------------------

def kmeans_assign(
    points: torch.Tensor,
    centroids: torch.Tensor,
    *,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (assignments (N,) int32, squared distances (N,) f32)."""
    x, c = _f32(points), _f32(centroids)
    if _use_kernel(backend, x, c):
        return _kmeans_assign_kernel(x, c)
    return ref.kmeans_assign(x, c)
