#!/usr/bin/env python3
"""Where a shard build's time goes, on one CUDA card.

    python3 tools/profile_build.py                            # 65,536 points
    python3 tools/profile_build.py --n 250000 --components 256 --spread 4 --batch 128

Builds one shard of ``chip_smoke.py``'s mixture (R=64, L=100, alpha=1.2,
2 passes; ``--n`` points, build batch ``--batch``, ``--components``
mixture components with centers drawn N(0, ``--spread``^2)) with synchronising timers around the beam search, the
prune (also counted when the re-prune calls it), the re-prune and the
reverse-edge scatter; then trains PQ (m=32), encodes, times ``search_pq``
for 100 queries, and prints recall@10 of ``search`` and of ``search_pq``
(k = 40 at L = 100, the probe's Stage-A call, cut to the first 10) for
``--queries`` queries drawn from the same mixture.
"""

import argparse
import collections
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.core import vamana as V  # noqa: E402
from repro_torch.core.pq import train_pq  # noqa: E402

T = collections.defaultdict(float)
C = collections.Counter()


def timed(name, fn):
    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t = time.time()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        T[name] += time.time() - t
        C[name] += 1
        return out
    return wrapper


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--spread", type=float, default=cs.MIX_CENTER_SCALE)
    ap.add_argument("--components", type=int, default=cs.MIX_COMPONENTS)
    ap.add_argument("--queries", type=int, default=1000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1
    V._robust_prune = timed("prune", V._robust_prune)
    V._reverse_edge_scatter = timed("scatter", V._reverse_edge_scatter)
    V._reprune = timed("reprune", V._reprune)
    V._Beam.run = timed("beam", V._Beam.run)
    rng = np.random.default_rng(0)
    data = cs.mixture(args.n + args.queries, 128, rng, components=args.components,
                      center_scale=args.spread)
    X, Q = data[: args.n], data[args.n :]
    tag = f"n={args.n} components={args.components} batch={args.batch} spread={args.spread}"
    t = time.time()
    g = V.build_vamana(X, V.VamanaParams(R=64, L=100, alpha=1.2), passes=2, batch=args.batch)
    print(f"build {tag}", time.time() - t,
          dict(T), dict(C), flush=True)
    t = time.time()
    pq = train_pq(X, m=32)
    print("train_pq", time.time() - t)
    t = time.time()
    g.attach_pq(pq)
    print("attach/encode", time.time() - t)
    T.clear()
    C.clear()
    t = time.time()
    g.search_pq(Q[:100], 40, L=100)
    torch.cuda.synchronize()
    print("search_pq 100q first", time.time() - t)
    t = time.time()
    for _ in range(5):
        g.search_pq(Q[:100], 40, L=100)
    torch.cuda.synchronize()
    print("search_pq 100q", (time.time() - t) / 5, dict(T), dict(C))
    _, truth = V.brute_force_topk(X, Q, 10)
    print(f"recall@10 {tag}: graph search",
          V.recall_at_k(g.search(Q, 10)[1], truth),
          "search_pq", V.recall_at_k(g.search_pq(Q, 40, L=100)[1][:, :10], truth), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
