"""Plain PyTorch versions of the kernels on the unfiltered DiskANN path.

These are the semantic ground truth for the CUDA kernels (``chip_smoke.py``
holds each kernel against them on the card) and the CPU path of every
wrapper.  Each mirrors its counterpart in the reference's
``repro/kernels/ref.py`` operation for operation, so the CPU tests can hold
the two packages to float tolerance.  The masked, ADC-scan and quantized
oracles arrive with the slices that port their kernels.
"""

from __future__ import annotations

import torch


def l2_distances(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance matrix in the expanded form |q|^2 - 2 q.x + |x|^2.

    queries (Q, D) f32, points (N, D) f32 -> (Q, N) f32."""
    q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
    x2 = torch.sum(points * points, dim=-1)[None, :]
    cross = queries @ points.T
    return q2 - 2.0 * cross + x2


def ip_distances(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Negative inner product ("distance": smaller is closer)."""
    return -(queries @ points.T)


def build_pq_luts(
    queries: torch.Tensor, codebook: torch.Tensor, metric: str = "l2"
) -> torch.Tensor:
    """ADC lookup tables: queries (Q, D), codebook (m, K, D/m) -> (Q, m, K)."""
    m, K, dsub = codebook.shape
    q_sub = queries.reshape(queries.shape[0], m, dsub)
    if metric == "l2":
        diff = q_sub[:, :, None, :] - codebook[None, :, :, :]
        return torch.sum(diff * diff, dim=-1)
    if metric == "ip":
        return -torch.einsum("qmd,mkd->qmk", q_sub, codebook)
    raise ValueError(f"unknown metric {metric}")


def _ascending_topk(d: torch.Tensor, k: int):
    """Ascending top-k along dim 1 with ties to the lowest index (as
    ``lax.top_k`` on the negated scores): a stable sort."""
    d_sorted, slot = torch.sort(d, dim=1, stable=True)
    return d_sorted[:, :k], slot[:, :k]


def gather_rerank(
    queries: torch.Tensor,
    points: torch.Tensor,
    pool_ids: torch.Tensor,
    k: int,
    metric: str = "l2",
):
    """Exact rerank of a per-query candidate pool.

    queries (Q, D) f32, points (N, D) f32, pool_ids (Q, P) integer; slots
    < 0 are sentinels and stay (+inf, -1).  Returns (dists (Q, k) f32, ids
    (Q, k) int32) ascending per row, (+inf, -1) beyond the live pool; ``k``
    may exceed P.  Direct-form L2, as the reference oracle."""
    pids = pool_ids.to(torch.int64)
    q = queries.to(torch.float32)
    x = points.to(torch.float32)
    safe = pids.clamp(0, x.shape[0] - 1)
    vecs = x[safe]  # (Q, P, D)
    if metric == "ip":
        d = -torch.einsum("qpd,qd->qp", vecs, q)
    else:
        diff = vecs - q[:, None, :]
        d = torch.sum(diff * diff, dim=-1)
    d = torch.where(pids < 0, torch.inf, d)
    p = d.shape[1]
    k_avail = min(k, p)
    out_d, slot = _ascending_topk(d, k_avail)
    out_i = torch.gather(pids, 1, slot)
    out_i = torch.where(torch.isinf(out_d), -1, out_i).to(torch.int32)
    if k_avail < k:
        pad = k - k_avail
        out_d = torch.nn.functional.pad(out_d, (0, pad), value=float("inf"))
        out_i = torch.nn.functional.pad(out_i, (0, pad), value=-1)
    return out_d.to(torch.float32), out_i


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor):
    """Nearest-centroid assignment: points (N, D), centroids (K, D) ->
    (assignments (N,) int32, squared distances (N,) f32); ties to the
    lowest centroid index."""
    d = l2_distances(points, centroids)
    idx = torch.argmin(d, dim=1).to(torch.int32)
    return idx, torch.min(d, dim=1).values
