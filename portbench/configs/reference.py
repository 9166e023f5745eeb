"""Plain reference of the configurations' semantics: exact k-nearest rows.

A query's answer is the ``k`` rows nearest to it by squared L2 distance,
ascending, ties to the lower row.  Nothing
here imports the program: the benchmark hands this module the raw corpus it
generated and the queries it sent, and the reference works the neighbours
out itself.

``precision="f32"`` is the reference: candidates by an f32 matrix product
(TF32 off), then rescored exactly in float64, so the answer does not depend
on the product's rounding.  ``precision="tf32"`` is the control: the same
search with the product's inputs in TF32 (on a card, the tensor cores' TF32
path; on the CPU, inputs rounded to TF32's 10-bit mantissa) and its
distances returned as computed, which is what a program that took that step
down would answer.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

MARGIN = 32  # candidates past k kept from the f32 pass for the exact rescoring


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to nearest-even at TF32's 10-bit mantissa."""
    i = t.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str, device: torch.device):
    was = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    tf32 = precision == "tf32" and device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def _sq_l2(q: torch.Tensor, x: torch.Tensor, precision: str) -> torch.Tensor:
    """(B, C) squared L2 distances by the product form, f32."""
    qm, xm = q, x
    if precision == "tf32" and q.device.type != "cuda":
        qm, xm = tf32_round(q), tf32_round(x)
    return (q * q).sum(1, keepdim=True) + (x * x).sum(1)[None, :] - 2.0 * (qm @ xm.T)


def pair_distances(corpus, queries: np.ndarray, rows: np.ndarray, device) -> np.ndarray:
    """Exact float64 squared L2 distance of query q to each row of ``rows[q]``
    (entries < 0 give +inf)."""
    rows = np.asarray(rows, np.int64)
    safe = np.where(rows < 0, 0, rows)
    out = np.empty(rows.shape, np.float64)
    step = max(1, (1 << 24) // max(1, rows.shape[1] * queries.shape[1]))
    for s in range(0, rows.shape[0], step):
        blk = safe[s : s + step]
        uniq = np.unique(blk)
        x = torch.as_tensor(np.asarray(corpus[uniq])).to(device, torch.float64)
        x = x[torch.as_tensor(np.searchsorted(uniq, blk)).to(device)]  # (b, k, d)
        q = torch.as_tensor(queries[s : s + step]).to(device, torch.float64)[:, None, :]
        out[s : s + step] = ((x - q) ** 2).sum(-1).cpu().numpy()
    out[rows < 0] = np.inf
    return out


def topk(corpus, queries: np.ndarray, k: int, device, *, precision: str = "f32",
         q_block: int = 256, x_block: int = 1 << 18):
    """(dists (Q, k), rows (Q, k) int64): each query's ``k`` nearest rows."""
    device = torch.device(device)
    n = corpus.shape[0]
    nq = queries.shape[0]
    keep = k if precision == "tf32" else k + MARGIN
    out_d = np.full((nq, k), np.inf, np.float64)
    out_i = np.full((nq, k), -1, np.int64)
    with _matmul_precision(precision, device):
        chunks = [(s, torch.from_numpy(np.array(corpus[s : s + x_block])).to(device, torch.float32))
                  for s in range(0, n, x_block)]
        for qs in range(0, nq, q_block):
            q = torch.as_tensor(queries[qs : qs + q_block]).to(device, torch.float32)
            best_d, best_i = [], []
            for s, x in chunks:
                d = _sq_l2(q, x, precision)
                kk = min(keep, x.shape[0])
                v, i = torch.topk(d, kk, dim=1, largest=False, sorted=False)
                best_d.append(v)
                best_i.append(i + s)
            d = torch.cat(best_d, 1)
            i = torch.cat(best_i, 1)
            if precision != "tf32":
                # exact rescoring of the candidates, in float64
                xv = torch.as_tensor(np.asarray(corpus[i.reshape(-1).cpu().numpy()]))
                xv = xv.to(device, torch.float64).reshape(i.shape[0], i.shape[1], -1)
                d = ((xv - q.to(torch.float64)[:, None, :]) ** 2).sum(-1)
            # ascending by (distance, row)
            order = torch.argsort(i, dim=1, stable=True)
            d, i = torch.gather(d, 1, order), torch.gather(i, 1, order)
            order = torch.argsort(d, dim=1, stable=True)[:, :k]
            d, i = torch.gather(d, 1, order), torch.gather(i, 1, order)
            out_d[qs : qs + q.shape[0], : d.shape[1]] = d.cpu().numpy()
            out_i[qs : qs + q.shape[0], : i.shape[1]] = i.cpu().numpy()
    return out_d, out_i
