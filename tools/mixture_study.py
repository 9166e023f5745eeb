#!/usr/bin/env python3
"""How hard is ``chip_smoke.py``'s mixture for PQ, per generator setting?

    PYTHONPATH=src python tools/mixture_study.py      # CPU, a few minutes

For 250,000 points and 200 queries of each setting (center spread, noise,
rank, components) prints the relative contrast (mean over 10th-nearest
squared distance, averaged over queries) and the share of each query's
exact top-10 found in the PQ-ADC top-100 and top-240 (PQ m=32 x 8 bits
trained with the port on a 10,000-point sample, as Stage 0 does).  It
counts; it times nothing.
"""

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import pq as P  # noqa: E402

SETTINGS = [(4, 0.25, 16, 1024), (4, 0.1, 8, 1024), (1, 0.1, 8, 1024), (2, 0.1, 8, 1024),
            (4, 0.1, 8, 64), (1, 0.25, 16, 64), (0.5, 0.1, 8, 1024)]


def run(scale, noise, rank, comps, n=250000, nq=200):
    rng = np.random.default_rng(0)
    data = cs.mixture(n + nq, 128, rng, components=comps, center_scale=scale, rank=rank, noise=noise)
    X, Q = data[:n], data[n:]
    Xt, Qt = torch.from_numpy(X), torch.from_numpy(Q)
    d = (Qt * Qt).sum(1, keepdim=True) - 2 * Qt @ Xt.T + (Xt * Xt).sum(1)[None]
    near = torch.topk(d, 10, largest=False)
    truth = near.indices
    rc = float((d.mean(1) / near.values[:, -1]).mean())
    pq = P.train_pq(X[rng.choice(n, min(n, 10000), replace=False)], m=32, nbits=8, device="cpu")
    codes = torch.from_numpy(P.encode(pq, X, device="cpu").astype(np.int64))
    luts = P.build_luts(pq, Q, device="cpu")
    adc = torch.zeros(nq, n)
    for j in range(pq.m):
        adc += luts[:, j, :][:, codes[:, j]]
    found = []
    for top in (100, 240):
        cand = torch.topk(adc, top, largest=False).indices
        found.append(np.mean([
            len(set(truth[i].tolist()) & set(cand[i].tolist())) / 10 for i in range(nq)
        ]))
    print(f"scale={scale} noise={noise} rank={rank} comps={comps}: RC={rc:.2f} "
          f"pq-contain@100={found[0]:.3f} @240={found[1]:.3f}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    for setting in SETTINGS:
        run(*setting)
