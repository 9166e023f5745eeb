"""Dense PQ-ADC scan (CUDA source in ``csrc/pq_scan.cu``).

:func:`pq_scan` replaces ``pq_scan_pallas`` (``repro/kernels/pq_scan.py``):
the (Q, N) f32 matrix ``scores[q, n] = sum_j luts[q, j, codes[n, j]]``,
summed in subquantizer order from 0, so it equals the plain version
(``ref.pq_adc_scores``) bit for bit.  It takes CUDA tensors only and
raises for any other; the plain version is chosen in ``kernels/ops.py``.
The kernel note is in the CUDA source.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rerank import _stream, check_cuda


def _lib() -> ctypes.CDLL:
    lib = _build.load("pq_scan")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pq_scan.argtypes = [vp, vp, ci, ci, ci, ci, vp, vp]
        lib.pq_scan.restype = ci
        lib.pq_scan_tile.argtypes = [ci, ci]
        lib.pq_scan_tile.restype = ci
        lib._typed = True
    return lib


def pq_scan(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts (Q, m, K) f32, codes (N, m) uint8 -> scores (Q, N) f32."""
    check_cuda("luts", luts, torch.float32, 3)
    check_cuda("codes", codes, torch.uint8, 2)
    q, m, kc = luts.shape
    n = codes.shape[0]
    if codes.shape[1] != m:
        raise ValueError(f"shape mismatch: luts {tuple(luts.shape)}, codes {tuple(codes.shape)}")
    if kc > 256:
        raise ValueError(f"uint8 codes address at most 256 codewords, got K={kc}")
    out = torch.empty((q, n), dtype=torch.float32, device=luts.device)
    if q == 0 or n == 0:
        return out
    lib = _lib()
    if lib.pq_scan_tile(m, kc) <= 0:
        raise ValueError(f"one query's LUT (m={m}, K={kc}) does not fit the kernel's shared memory")
    with torch.cuda.device(luts.device):
        rc = lib.pq_scan(luts.data_ptr(), codes.data_ptr(), q, n, m, kc, out.data_ptr(),
                         _stream(luts))
    _build.check(lib, rc, "pq_scan")
    _build.count_launch("pq_scan")
    return out
