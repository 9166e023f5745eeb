"""k-means (Lloyd) in PyTorch — Stage-0 centroid training and PQ codebooks.

Port of ``repro/core/kmeans.py``.  The k-means++ seeding stays on the host
with the reference's numpy RNG stream, so both packages start from the
same centroids.  Assignment runs the ``kmeans_assign`` kernel on the card
(``backend="auto"``; the reference pins its plain version); the update is
an ``index_add_`` in place of ``segment_sum``.  On the card ``index_add_``
sums with atomics, in another order than XLA's segment sum, so centroids
agree with the reference to float tolerance, not bit for bit.  Empty
clusters are re-seeded from the points farthest from their centroid.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.device_cache import resolve_device, to_device


def kmeans_plus_plus_init(
    points: np.ndarray, k: int, rng: np.random.Generator, sample_cap: int = 16384
) -> np.ndarray:
    """k-means++ seeding (host-side; runs once per training call)."""
    n = points.shape[0]
    if n > sample_cap:
        points = points[rng.choice(n, size=sample_cap, replace=False)]
        n = sample_cap
    centroids = np.empty((k, points.shape[1]), dtype=np.float32)
    centroids[0] = points[rng.integers(n)]
    d2 = np.full(n, np.inf, dtype=np.float64)
    for i in range(1, k):
        diff = points - centroids[i - 1]
        d2 = np.minimum(d2, np.einsum("nd,nd->n", diff, diff))
        total = d2.sum()
        if total <= 0:
            centroids[i:] = points[rng.integers(n, size=k - i)]
            break
        probs = d2 / total
        centroids[i] = points[rng.choice(n, p=probs)]
    return centroids


def _lloyd_step(
    points: torch.Tensor, centroids: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    assign_, dist = ops.kmeans_assign(points, centroids, backend="auto")
    idx = assign_.to(torch.int64)
    counts = torch.zeros(k, dtype=torch.float32, device=points.device)
    counts.index_add_(0, idx, torch.ones_like(dist))
    sums = torch.zeros((k, points.shape[1]), dtype=torch.float32, device=points.device)
    sums.index_add_(0, idx, points)
    new_centroids = sums / torch.clamp(counts, min=1.0)[:, None]
    # keep old centroid where the cluster went empty (repaired on host)
    new_centroids = torch.where((counts > 0)[:, None], new_centroids, centroids)
    return new_centroids, counts, torch.sum(dist)


def train_kmeans(
    points: np.ndarray,
    k: int,
    *,
    iters: int = 20,
    seed: int = 0,
    repair_empty: bool = True,
    device="cuda",
) -> Tuple[np.ndarray, float]:
    """Returns (centroids (k, D) f32, final inertia)."""
    dev = resolve_device(device)
    points = np.ascontiguousarray(points, dtype=np.float32)
    n = points.shape[0]
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    rng = np.random.default_rng(seed)
    centroids = kmeans_plus_plus_init(points, k, rng)
    pts = to_device(points, dev)
    cen = to_device(centroids, dev)
    inertia = float("inf")
    for _ in range(iters):
        cen, counts, inertia_t = _lloyd_step(pts, cen, k)
        empties = np.flatnonzero(counts.cpu().numpy() == 0)
        inertia = float(inertia_t)
        if repair_empty and len(empties):
            # re-seed empty clusters at the points farthest from their centroid
            _, dist = ops.kmeans_assign(pts, cen, backend="auto")
            far = np.argsort(-dist.cpu().numpy())
            cen = cen.clone()
            cen[torch.as_tensor(empties, device=dev)] = pts[
                torch.as_tensor(far[: len(empties)], device=dev)
            ]
    return cen.cpu().numpy(), inertia


def assign(points: np.ndarray, centroids: np.ndarray, *, device="cuda") -> np.ndarray:
    """Host-facing nearest-centroid assignment (used for shard ownership)."""
    dev = resolve_device(device)
    idx, _ = ops.kmeans_assign(
        to_device(points, dev),
        to_device(centroids, dev),
        backend="auto",
    )
    return idx.cpu().numpy()
