"""Public dispatch for the hand-written kernels.

Backend contract (as ``repro/kernels/ops.py``, with the Pallas backend
replaced by the CUDA kernels):

- ``backend="auto"`` → the CUDA kernel for CUDA tensors, the plain PyTorch
  version (``kernels/ref.py``) for CPU tensors.  A CUDA tensor never falls
  back to the plain version: a failed build or launch raises.
- ``backend="ref"``  → the plain version always (tests and the kernel
  comparisons in ``chip_smoke.py``).

The kernels take ragged shapes themselves, so nothing is padded here.
Inputs are coerced to contiguous f32 (ids to int32, masks to bytes, PQ
codes to uint8) on their own device; every tensor of a call must lie on one
device.

Masked-op contract (``masked_exact_topk`` / ``masked_pq_topk``, their
``*_multi`` per-query-mask variants, ``unified_masked_topk`` and the three
``*_dedup`` forms), as the reference's:

- ``mask`` is a truthy (N,) row mask: falsy rows (predicate misses,
  tombstones) score +inf before the top-k and can never displace a passing
  row.  ``*_multi`` takes a (Q, N) plane, row q for query q; Q == 1 goes to
  the single-mask op.  ``*_dedup`` takes the plane factored as unique rows
  (m, N) plus a (Q,) row index; the kernels read that form directly, so the
  plane is never expanded on the card (the CPU path expands it with
  :func:`expand_mask_plane` for the plain version).
- ``unified_masked_topk`` scores each query by its own ``flavor`` (truthy =
  PQ-ADC) in one launch; mask and flavor fold into the selector plane
  ``mask * (1 + flavor)`` (0 = masked, 1 = exact, 2 = ADC).
- Outputs are (dists (Q, k) f32, ids (Q, k) int32), each row ascending with
  ties to the lowest id; slots past the passing rows, and past N when
  k > N, hold (+inf, -1).
- ``dtype`` (``masked_exact_topk``, ``*_multi``, ``*_dedup``) picks the
  scoring precision, ``"f32"``, ``"bf16"`` or ``"int8"``: for the
  quantized two, ``points`` may be the stored matrix (bf16, or int8 with its
  ``x_scale``, as :func:`ref.quantize_points` makes it) or f32 to quantize
  here; the queries are quantized per call, all rows with one scale.  On the
  card the bf16 / int8 kernels score the stored values, never an f32 scan
  in their place.  Quantized scores carry value error: callers route the
  pool through the full-precision :func:`gather_rerank` guard.
- ``pq_scan`` is the dense ADC score matrix (no mask, no top-k), summed in
  the masked ADC kernels' order; ``pq_scan_topk`` its ascending top-k.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import masked_topk as _masked
from repro_torch.kernels import ref
from repro_torch.kernels.kmeans_assign import kmeans_assign as _kmeans_assign_kernel
from repro_torch.kernels.pq_scan import pq_scan as _pq_scan_kernel
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
    # a stable sort: ties go to the lowest index, as lax.top_k (torch.topk
    # leaves the order of ties unspecified)
    return ref._ascending_topk(d, int(k))


# -- mask-aware top-k --------------------------------------------------------

def _quant_inputs(queries: torch.Tensor, points: torch.Tensor, dtype: str, x_scale: float):
    """A quantized call's inputs: ``points`` may arrive stored (bf16 / int8
    from a cached device copy, with its ``x_scale``) or f32 to quantize
    here; the queries are always quantized, all rows of the call together.
    Returns (stored_q, stored_x, q_scale, x_scale)."""
    if dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown score dtype {dtype!r}")
    want = torch.bfloat16 if dtype == "bf16" else torch.int8
    x = points
    if x.dtype != want:
        x, x_scale = ref.quantize_points(x, dtype)
    qs, q_scale = ref.quantize_points(queries, dtype)
    return qs.contiguous(), x.contiguous(), float(q_scale), float(x_scale)


def _masked_quant(queries, points, k, metric, dtype, x_scale, *, kernel_masks=None,
                  plain_mask=None):
    """Quantized masked exact top-k: the bf16 / int8 kernel on
    ``kernel_masks`` = (mask rows, row index or None), else the
    dequantizing plain version on ``plain_mask``, an (N,) row or a (Q, N)
    plane."""
    qs, xs, q_scale, x_scale = _quant_inputs(queries, points, dtype, x_scale)
    if kernel_masks is None:
        return ref.masked_exact_topk_quant(
            queries.to(torch.float32), xs, plain_mask, int(k), metric=metric, dtype=dtype,
            x_scale=x_scale,
        )
    return _masked.masked_exact_topk(
        qs, xs, *kernel_masks, int(k), metric=metric,
        scales=(q_scale, x_scale) if dtype == "int8" else None,
    )


def _bytes(mask: torch.Tensor) -> torch.Tensor:
    """A truthy mask (any dtype) as contiguous uint8 (nonzero = passes)."""
    if mask.dtype != torch.uint8:
        mask = mask != 0
    return mask.to(torch.uint8).contiguous()


def _codes(codes: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.uint8).contiguous()


def masked_exact_topk(
    queries: torch.Tensor,
    points: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    *,
    metric: str = "l2",
    backend: str = "auto",
    dtype: str = "f32",
    x_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked exact top-k: (Q, D) x (N, D) under a (N,) row mask ->
    (dists (Q, k), ids (Q, k)) per the masked-op contract above; ``dtype``
    and ``x_scale`` as the contract says."""
    if dtype != "f32":
        if _use_kernel(backend, queries, points, mask):
            return _masked_quant(queries, points, k, metric, dtype, x_scale,
                                 kernel_masks=(_bytes(mask).reshape(1, -1), None))
        return _masked_quant(queries, points, k, metric, dtype, x_scale, plain_mask=mask)
    q, x = _f32(queries), _f32(points)
    if _use_kernel(backend, q, x, mask):
        return _masked.masked_exact_topk(
            q, x, _bytes(mask).reshape(1, -1), None, int(k), metric=metric
        )
    return ref.masked_exact_topk(q, x, mask, int(k), metric=metric)


def masked_pq_topk(
    luts: torch.Tensor,
    codes: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    *,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked PQ-ADC top-k: LUTs (Q, m, K) x codes (N, m) under a (N,) row
    mask -> (scores (Q, k), ids (Q, k))."""
    lt = _f32(luts)
    if _use_kernel(backend, lt, codes, mask):
        return _masked.masked_pq_topk(
            lt, _codes(codes), _bytes(mask).reshape(1, -1), None, int(k)
        )
    return ref.masked_pq_topk(lt, codes, mask, int(k))


def _check_plane(masks: torch.Tensor, q: int, n: int) -> None:
    if tuple(masks.shape) != (q, n):
        raise ValueError(f"mask plane must be ({q}, {n}), got {tuple(masks.shape)}")


def _all_rows(q: int, device) -> torch.Tensor:
    return torch.arange(q, dtype=torch.int32, device=device)


def masked_exact_topk_multi(
    queries: torch.Tensor,
    points: torch.Tensor,
    masks: torch.Tensor,
    k: int,
    *,
    metric: str = "l2",
    backend: str = "auto",
    dtype: str = "f32",
    x_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query-mask exact top-k under a (Q, N) plane (row q masks query
    q): one call for a heterogeneous batch; Q == 1 goes to the single-mask
    op.  ``dtype`` and ``x_scale`` as :func:`masked_exact_topk`."""
    _check_plane(masks, queries.shape[0], points.shape[0])
    if queries.shape[0] == 1:
        return masked_exact_topk(queries, points, masks[0], k, metric=metric, backend=backend,
                                 dtype=dtype, x_scale=x_scale)
    if dtype != "f32":
        if _use_kernel(backend, queries, points, masks):
            rows = _all_rows(queries.shape[0], queries.device)
            return _masked_quant(queries, points, k, metric, dtype, x_scale,
                                 kernel_masks=(_bytes(masks), rows))
        return _masked_quant(queries, points, k, metric, dtype, x_scale, plain_mask=masks)
    q, x = _f32(queries), _f32(points)
    if _use_kernel(backend, q, x, masks):
        return _masked.masked_exact_topk(
            q, x, _bytes(masks), _all_rows(q.shape[0], q.device), int(k), metric=metric
        )
    return ref.masked_exact_topk_multi(q, x, masks, int(k), metric=metric)


def masked_pq_topk_multi(
    luts: torch.Tensor,
    codes: torch.Tensor,
    masks: torch.Tensor,
    k: int,
    *,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query-mask PQ-ADC top-k under a (Q, N) plane; Q == 1 goes to the
    single-mask op."""
    _check_plane(masks, luts.shape[0], codes.shape[0])
    if luts.shape[0] == 1:
        return masked_pq_topk(luts, codes, masks[0], k, backend=backend)
    lt = _f32(luts)
    if _use_kernel(backend, lt, codes, masks):
        return _masked.masked_pq_topk(
            lt, _codes(codes), _bytes(masks), _all_rows(lt.shape[0], lt.device), int(k)
        )
    return ref.masked_pq_topk_multi(lt, codes, masks, int(k))


def unified_masked_topk(
    queries: torch.Tensor,
    points: torch.Tensor,
    luts: torch.Tensor,
    codes: torch.Tensor,
    masks: torch.Tensor,
    flavor: torch.Tensor,
    k: int,
    *,
    metric: str = "l2",
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-dispatch mixed-flavor masked top-k: (Q, D) x (N, D) exact and
    (Q, m, K) x (N, m) PQ-ADC under a (Q, N) mask plane, with a per-query
    ``flavor`` (truthy = ADC)."""
    q, x, lt = _f32(queries), _f32(points), _f32(luts)
    _check_plane(masks, q.shape[0], x.shape[0])
    if lt.shape[0] != q.shape[0] or codes.shape[0] != x.shape[0]:
        raise ValueError(f"shape mismatch: luts {tuple(lt.shape)}, codes {tuple(codes.shape)}")
    fl = flavor.reshape(-1) != 0
    if _use_kernel(backend, q, x, lt, codes, masks, fl):
        return _masked.unified_masked_topk(
            q, x, lt, _codes(codes), _bytes(masks), _all_rows(q.shape[0], q.device),
            fl.contiguous(), int(k), metric=metric,
        )
    return ref.unified_masked_topk(q, x, lt, codes, masks, fl, int(k), metric=metric)


# -- dedup'd mask planes -------------------------------------------------------
#
# A coalesced fragment's (Q, N) plane usually holds m << Q distinct rows.  The
# *_dedup entry points take the factored form (unique_masks (m, N), row_index
# (Q,)): on the card the kernels read it as it is; on the CPU the plane is
# expanded for the plain version.  Results equal the dense *_multi call on
# the expanded plane.


def expand_mask_plane(unique_masks: torch.Tensor, row_index: torch.Tensor) -> torch.Tensor:
    """(m, N) unique rows + (Q,) row index -> dense (Q, N) plane."""
    return unique_masks.index_select(0, row_index.to(device=unique_masks.device, dtype=torch.int64))


def masked_exact_topk_dedup(
    queries: torch.Tensor,
    points: torch.Tensor,
    unique_masks: torch.Tensor,
    row_index: torch.Tensor,
    k: int,
    *,
    metric: str = "l2",
    backend: str = "auto",
    dtype: str = "f32",
    x_scale: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``masked_exact_topk_multi`` on ``unique_masks[row_index]``."""
    if queries.shape[0] == 1 or not _use_kernel(backend, queries, points, unique_masks, row_index):
        return masked_exact_topk_multi(
            queries, points, expand_mask_plane(unique_masks, row_index), k, metric=metric,
            backend=backend, dtype=dtype, x_scale=x_scale,
        )
    if dtype != "f32":
        return _masked_quant(
            queries, points, k, metric, dtype, x_scale,
            kernel_masks=(_bytes(unique_masks), row_index.to(torch.int32).contiguous()),
        )
    q, x = _f32(queries), _f32(points)
    return _masked.masked_exact_topk(
        q, x, _bytes(unique_masks), row_index.to(torch.int32).contiguous(), int(k), metric=metric
    )


def masked_pq_topk_dedup(
    luts: torch.Tensor,
    codes: torch.Tensor,
    unique_masks: torch.Tensor,
    row_index: torch.Tensor,
    k: int,
    *,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``masked_pq_topk_multi`` on ``unique_masks[row_index]``."""
    lt = _f32(luts)
    if lt.shape[0] == 1 or not _use_kernel(backend, lt, codes, unique_masks, row_index):
        return masked_pq_topk_multi(
            lt, codes, expand_mask_plane(unique_masks, row_index), k, backend=backend
        )
    return _masked.masked_pq_topk(
        lt, _codes(codes), _bytes(unique_masks), row_index.to(torch.int32).contiguous(), int(k)
    )


def unified_masked_topk_dedup(
    queries: torch.Tensor,
    points: torch.Tensor,
    luts: torch.Tensor,
    codes: torch.Tensor,
    unique_masks: torch.Tensor,
    row_index: torch.Tensor,
    flavor: torch.Tensor,
    k: int,
    *,
    metric: str = "l2",
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``unified_masked_topk`` on ``unique_masks[row_index]``."""
    q, x, lt = _f32(queries), _f32(points), _f32(luts)
    fl = flavor.reshape(-1) != 0
    if not _use_kernel(backend, q, x, lt, codes, unique_masks, row_index, fl):
        return unified_masked_topk(
            q, x, lt, codes, expand_mask_plane(unique_masks, row_index), fl, k,
            metric=metric, backend=backend,
        )
    if lt.shape[0] != q.shape[0] or codes.shape[0] != x.shape[0]:
        raise ValueError(f"shape mismatch: luts {tuple(lt.shape)}, codes {tuple(codes.shape)}")
    return _masked.unified_masked_topk(
        q, x, lt, _codes(codes), _bytes(unique_masks), row_index.to(torch.int32).contiguous(),
        fl.contiguous(), int(k), metric=metric,
    )


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
    pids = pool_ids.to(device=q.device, dtype=torch.int32).contiguous()
    if _use_kernel(backend, q, x, pids):
        # the kernel reads ids < 0 and >= N as sentinels itself
        return _gather_rerank_kernel(q, x, pids, int(k), metric=metric)
    # out-of-range ids (stale pools, clipped host fills) become sentinels
    pids = torch.where((pids < 0) | (pids >= x.shape[0]), -1, pids)
    return ref.gather_rerank(q, x, pids, int(k), metric=metric)


# -- dense ADC scan ------------------------------------------------------------

def pq_scan(
    luts: torch.Tensor,
    codes: torch.Tensor,
    *,
    backend: str = "auto",
) -> torch.Tensor:
    """ADC scores (Q, N) from per-query LUTs (Q, m, K) and codes (N, m)."""
    lt = _f32(luts)
    if _use_kernel(backend, lt, codes):
        return _pq_scan_kernel(lt, _codes(codes))
    return ref.pq_adc_scores(lt, codes)


def pq_scan_topk(
    luts: torch.Tensor,
    codes: torch.Tensor,
    k: int,
    *,
    backend: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k best ADC scores of each query, ascending, ties to the lowest
    row (as ``lax.top_k`` on the negated scores): (scores (Q, k), ids (Q, k))."""
    return ref._ascending_topk(pq_scan(luts, codes, backend=backend), int(k))


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
