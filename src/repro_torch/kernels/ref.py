"""Plain PyTorch versions of the hand-written kernels.

These are the semantic ground truth for the CUDA kernels (``chip_smoke.py``
holds each kernel against them on the card) and the CPU path of every
wrapper.  Each mirrors its counterpart in the reference's
``repro/kernels/ref.py``, so the CPU tests can hold the two packages to
float tolerance.

The masked oracles score each query row on its own (one matrix-vector
product per row, ADC sums in subquantizer order), so a row's scores carry
the same bits whatever other rows share the call.  The executor relies on
that: a query answered by the unified mixed-flavor op, by the split
per-flavor ops or by the per-predicate group loop gets the same hits.
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


def pq_adc_scores(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Asymmetric-distance-computation scores: luts (Q, m, K) f32, codes
    (N, m) integer -> (Q, N) f32 with ``scores[q, n] = sum_j luts[q, j,
    codes[n, j]]``, summed in subquantizer order from 0.0 (the order the
    ADC kernel sums in, so the two agree bit for bit)."""
    codes = codes.to(device=luts.device, dtype=torch.int64)
    out = torch.zeros((luts.shape[0], codes.shape[0]), dtype=torch.float32, device=luts.device)
    for j in range(luts.shape[1]):
        out = out + luts[:, j, :].to(torch.float32)[:, codes[:, j]]
    return out


def _row_cross(queries: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """(Q, N) inner products, one matrix-vector product per query row, so a
    row's bits do not depend on how many rows share the call (a matrix
    product may pick its routine by the row count)."""
    if queries.shape[0] == 0:
        return queries.new_zeros((0, points.shape[0]))
    return torch.stack([points @ q for q in queries])


def _row_distances(queries: torch.Tensor, points: torch.Tensor, metric: str) -> torch.Tensor:
    """Row-invariant :func:`l2_distances` / :func:`ip_distances`."""
    cross = _row_cross(queries, points)
    if metric == "ip":
        return -cross
    q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
    x2 = torch.sum(points * points, dim=-1)[None, :]
    return q2 - 2.0 * cross + x2


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


def _masked_topk(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Shared masked top-k epilogue: scores (Q, N), mask (N,) shared or
    (Q, N) per query, truthy.  Masked-out rows are forced to +inf before the
    reduction.  Returns (dists (Q, k) f32, ids (Q, k) int32), each row
    ascending with ties to the lowest id; slots beyond the passing rows, and
    beyond N when k > N, hold (+inf, -1)."""
    n = scores.shape[1]
    mask = mask.to(device=scores.device).bool()
    if mask.dim() == 1:
        mask = mask[None, :]
    scores = torch.where(mask, scores, torch.inf)
    k_avail = min(k, n)
    d, idx = _ascending_topk(scores, k_avail)
    idx = torch.where(torch.isinf(d), -1, idx).to(torch.int32)
    if k_avail < k:
        pad = k - k_avail
        d = torch.nn.functional.pad(d, (0, pad), value=float("inf"))
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    return d.to(torch.float32), idx


def masked_exact_topk(
    queries: torch.Tensor, points: torch.Tensor, mask: torch.Tensor, k: int, metric: str = "l2"
):
    """Mask-aware exact top-k: queries (Q, D), points (N, D), mask (N,)."""
    return _masked_topk(_row_distances(queries, points, metric), mask, k)


def masked_pq_topk(luts: torch.Tensor, codes: torch.Tensor, mask: torch.Tensor, k: int):
    """Mask-aware PQ-ADC top-k: luts (Q, m, K), codes (N, m), mask (N,)."""
    return _masked_topk(pq_adc_scores(luts, codes), mask, k)


def masked_exact_topk_multi(
    queries: torch.Tensor, points: torch.Tensor, masks: torch.Tensor, k: int, metric: str = "l2"
):
    """Per-query-mask exact top-k: masks (Q, N), row q masks query q."""
    return _masked_topk(_row_distances(queries, points, metric), masks, k)


def masked_pq_topk_multi(luts: torch.Tensor, codes: torch.Tensor, masks: torch.Tensor, k: int):
    """Per-query-mask PQ-ADC top-k: luts (Q, m, K), codes (N, m), masks (Q, N)."""
    return _masked_topk(pq_adc_scores(luts, codes), masks, k)


def unified_masked_topk(
    queries: torch.Tensor,
    points: torch.Tensor,
    luts: torch.Tensor,
    codes: torch.Tensor,
    masks: torch.Tensor,
    flavor: torch.Tensor,
    k: int,
    metric: str = "l2",
):
    """Mixed-flavor masked top-k: each query row is scored by its own
    flavor (truthy = PQ-ADC, else full precision), then the shared masked
    top-k.  masks (N,) or (Q, N)."""
    fl = flavor.to(device=queries.device).bool().reshape(-1, 1)
    mask = masks.to(device=queries.device).bool()
    # selector plane: 0 = masked out, 1 = exact flavor, 2 = ADC flavor
    sel = mask.to(torch.uint8) * (1 + fl.to(torch.uint8))
    d_exact = _row_distances(queries, points, metric)
    d_adc = pq_adc_scores(luts, codes)
    return _masked_topk(torch.where(sel == 2, d_adc, d_exact), sel != 0, k)


# -- quantized scoring --------------------------------------------------------
#
# As the reference: bf16 / int8 quantize the stored values; the oracles
# dequantize and score in f32, so they carry the quantized kernels' value
# error but not their accumulation order.

SCORE_DTYPES = ("f32", "bf16", "int8")


def quantize_points(points: torch.Tensor, dtype: str):
    """Quantize a point matrix for reduced-precision scoring.

    Returns (stored, scale): ``bf16`` stores bfloat16 values (round to
    nearest even, scale 1.0); ``int8`` stores symmetric per-tensor int8,
    ``round(x / scale)`` (half to even) clipped to [-127, 127] with
    ``scale = max|x| / 127`` (1.0 for an all-zero matrix); ``f32`` passes
    through.  Dequantization is ``stored.float() * scale`` in every case."""
    x = points.to(torch.float32)
    if dtype == "f32":
        return x, 1.0
    if dtype == "bf16":
        return x.to(torch.bfloat16), 1.0
    if dtype == "int8":
        top = float(x.abs().max()) if x.numel() else 0.0
        scale = top / 127.0 or 1.0
        # a tensor divisor: a Python scalar may become a multiply by its
        # reciprocal on the card, which rounds differently
        div = torch.full((), scale, dtype=torch.float32, device=x.device)
        return torch.clamp(torch.round(x / div), -127, 127).to(torch.int8), scale
    raise ValueError(f"unknown score dtype {dtype!r}")


def dequantize_points(stored: torch.Tensor, scale: float) -> torch.Tensor:
    return stored.to(torch.float32) * torch.full(
        (), scale, dtype=torch.float32, device=stored.device
    )


def masked_exact_topk_quant(
    queries: torch.Tensor,
    points: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    *,
    metric: str = "l2",
    dtype: str = "bf16",
    x_scale: float = 1.0,
):
    """Quantized-scoring oracle of the masked exact scan: ``points`` is the
    stored matrix from :func:`quantize_points` (with its ``x_scale``);
    the queries are quantized here, all rows of the call with one scale.
    Both sides are dequantized and scored in f32 (row-invariant, as
    :func:`masked_exact_topk`).  ``mask`` is (N,) or a (Q, N) plane."""
    xq = dequantize_points(points, x_scale)
    qs, q_scale = quantize_points(queries, dtype)
    qq = dequantize_points(qs, q_scale)
    return _masked_topk(_row_distances(qq, xq, metric), mask, k)


def kmeans_assign(points: torch.Tensor, centroids: torch.Tensor):
    """Nearest-centroid assignment: points (N, D), centroids (K, D) ->
    (assignments (N,) int32, squared distances (N,) f32); ties to the
    lowest centroid index."""
    d = l2_distances(points, centroids)
    idx = torch.argmin(d, dim=1).to(torch.int32)
    return idx, torch.min(d, dim=1).values
