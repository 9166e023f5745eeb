"""Product quantization (Jégou et al.) — train / encode / ADC LUTs.

Port of ``repro/core/pq.py``.  The codebook is a plain ``(m, K, D/m)``
float32 numpy array in both packages; codes are ``(N, m)`` uint8.
Encoding runs the ``kmeans_assign`` kernel once per subquantizer on the
card (the reference pins its plain version).  :func:`adc_scores` is the
dense ADC scan (the ``pq_scan`` kernel on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

from repro_torch.core.kmeans import train_kmeans
from repro_torch.kernels import ops, ref
from repro_torch.kernels.device_cache import resolve_device, to_device


@dataclass
class PQCodebook:
    codebook: np.ndarray  # (m, K, dsub) float32
    metric: str = "l2"

    @property
    def m(self) -> int:
        return self.codebook.shape[0]

    @property
    def K(self) -> int:
        return self.codebook.shape[1]

    @property
    def dsub(self) -> int:
        return self.codebook.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub

    @property
    def nbits(self) -> int:
        return int(np.log2(self.K))

    # -- serialization (flat f32 + shape header handled by blob codec) -----
    def tobytes(self) -> bytes:
        return np.ascontiguousarray(self.codebook, dtype=np.float32).tobytes()

    @staticmethod
    def frombytes(data: bytes, m: int, K: int, dsub: int, metric: str = "l2") -> "PQCodebook":
        arr = np.frombuffer(data, dtype=np.float32).reshape(m, K, dsub).copy()
        return PQCodebook(arr, metric)


def train_pq(
    vectors: np.ndarray,
    m: int = 48,
    nbits: int = 8,
    *,
    iters: int = 12,
    seed: int = 0,
    sample_cap: int = 65536,
    metric: str = "l2",
    device="cuda",
) -> PQCodebook:
    """Train one k-means codebook per subquantizer."""
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by m={m}")
    K = 1 << nbits
    rng = np.random.default_rng(seed)
    if n > sample_cap:
        vectors = vectors[rng.choice(n, size=sample_cap, replace=False)]
    dsub = d // m
    sub = vectors.reshape(-1, m, dsub)
    codebook = np.empty((m, K, dsub), dtype=np.float32)
    for j in range(m):
        k_eff = min(K, sub.shape[0])
        cents, _ = train_kmeans(
            sub[:, j, :], k_eff, iters=iters, seed=seed + j, device=device
        )
        if k_eff < K:  # degenerate tiny-corpus case: tile the codebook
            reps = int(np.ceil(K / k_eff))
            cents = np.tile(cents, (reps, 1))[:K]
        codebook[j] = cents
    return PQCodebook(codebook, metric)


def encode(
    pq: PQCodebook, vectors: np.ndarray, batch: int = 8192, *, device="cuda"
) -> np.ndarray:
    """PQ-encode vectors -> (N, m) uint8 codes.  The vectors cross to the
    device once; each batch runs one assignment per subquantizer."""
    dev = resolve_device(device)
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    if d != pq.dim:
        raise ValueError(f"dim {d} != codebook dim {pq.dim}")
    x = to_device(vectors, dev)
    books = to_device(pq.codebook, dev)
    out = torch.empty((n, pq.m), dtype=torch.uint8, device=dev)
    for start in range(0, n, batch):
        stop = min(start + batch, n)
        sub = x[start:stop].reshape(stop - start, pq.m, pq.dsub)
        for j in range(pq.m):
            idx, _ = ops.kmeans_assign(sub[:, j, :], books[j], backend="auto")
            out[start:stop, j] = idx.to(torch.uint8)
    return out.cpu().numpy()


def decode(pq: PQCodebook, codes: np.ndarray) -> np.ndarray:
    """Reconstruct approximate vectors from codes (N, m) -> (N, D)."""
    n = codes.shape[0]
    out = np.empty((n, pq.dim), dtype=np.float32)
    for j in range(pq.m):
        out[:, j * pq.dsub : (j + 1) * pq.dsub] = pq.codebook[j][codes[:, j]]
    return out


def build_luts(pq: PQCodebook, queries, *, device="cuda") -> torch.Tensor:
    """Per-query ADC lookup tables (Q, m, K) on ``device``."""
    dev = resolve_device(device)
    if isinstance(queries, np.ndarray):
        queries = to_device(queries, dev)
    return ref.build_pq_luts(
        queries.to(device=dev, dtype=torch.float32), to_device(pq.codebook, dev), pq.metric
    )


def adc_scores(
    pq: PQCodebook,
    queries,
    codes,
    *,
    backend: str = "auto",
    device="cuda",
) -> torch.Tensor:
    """Full ADC scan: (Q, N) approximate distances on ``device``."""
    dev = resolve_device(device)
    luts = build_luts(pq, queries, device=dev)
    if isinstance(codes, np.ndarray):
        codes = to_device(codes, dev, torch.uint8)
    return ops.pq_scan(luts, codes.to(dev), backend=backend)
