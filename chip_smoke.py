#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, the full-size run
    python3 chip_smoke.py --n 262144 # a cut deployment (N is the only knob cut)

Phases, each raising on failure (the script then exits non-zero and prints
no result line):

1. Environment: torch / CUDA versions, the card's name and power limit, and
   the time to build every CUDA kernel from ``src/repro_torch/kernels/csrc``.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the main path gives it and at the edge cases (sentinel and out-of-range
   ids, duplicates, k > P, k > N, ip and l2, ragged Q/N/D, D = 4 with
   K = 256), timed with CUDA events (median of 30 after warm-up) beside a
   one-call PyTorch yardstick that the port never calls, and beside the
   least time the card could take (``bound_ms``).
3. The main path: a SIFT1M-shaped deployment (ann-benchmarks
   sift-128-euclidean: N = 1,000,000 x 128 f32, L2, 10,000 queries,
   k = 10), made from ``--seed`` as a Gaussian mixture, goes through
   ``make_local_cluster`` (4 executors, one card), ``create_index`` and 100
   ``probe(strategy="diskann")`` calls of 100 queries.  The kernel launch
   counts of exactly that run are read, and recall@10 against
   ``brute_force_topk`` must reach 0.90.

The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

KERNELS = {
    "rerank_distances": ("src/repro_torch/kernels/csrc/rerank.cu", "src/repro/kernels/rerank.py:90"),
    "gather_rerank": ("src/repro_torch/kernels/csrc/rerank.cu", "src/repro/kernels/rerank.py:175"),
    "kmeans_assign": (
        "src/repro_torch/kernels/csrc/kmeans_assign.cu",
        "src/repro/kernels/kmeans_assign.py:71",
    ),
}

# Gaussian mixture standing in for SIFT1M: 1,024 components with centers
# drawn N(0, 1) per coordinate, each with a rank-8 covariance (a random
# 128x8 loading, N(0, 1) factors) plus isotropic N(0, 0.1^2) noise: a low
# local intrinsic dimension, and components that overlap (mean over 10th-
# nearest squared distance about 5.7), as in real descriptor sets.  With
# far-apart components (centers N(0, 4^2)) the PQ-guided beam of Stage A
# loses recall (0.89 at 1M points) while the full-precision beam on the
# same graph does not (tools/profile_build.py; see PERF.md).
MIX_COMPONENTS = 1024
MIX_CENTER_SCALE = 1.0
MIX_RANK = 8
MIX_NOISE = 0.1
BUILD_BATCH = 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(flops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def mixture(
    n: int,
    d: int,
    rng: np.random.Generator,
    *,
    components: int = MIX_COMPONENTS,
    center_scale: float = MIX_CENTER_SCALE,
    rank: int = MIX_RANK,
    noise: float = MIX_NOISE,
):
    centers = rng.normal(size=(components, d)).astype(np.float32) * center_scale
    loads = rng.normal(size=(components, rank, d)).astype(np.float32) / np.sqrt(rank)
    comp = rng.integers(0, components, size=n)
    z = rng.normal(size=(n, rank)).astype(np.float32)
    x = centers[comp] + rng.normal(size=(n, d)).astype(np.float32) * noise
    order = np.argsort(comp, kind="stable")
    bounds = np.searchsorted(comp[order], np.arange(components + 1))
    for c in range(components):
        rows = order[bounds[c] : bounds[c + 1]]
        x[rows] += z[rows] @ loads[c]
    return x


# -- phase 1 -------------------------------------------------------------------

def phase_environment(torch):
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    from repro_torch.kernels import _build

    t0 = time.time()
    _build.build_all()
    log(f"kernel build: {time.time() - t0:.2f} s for {_build.sources()}")
    return smi


# -- phase 2 -------------------------------------------------------------------

def _close(got, want, atol, rtol=1e-5):
    """max |got - want| over finite entries; raises if any exceeds tolerance
    or the +inf patterns differ."""
    import torch

    gi, wi = torch.isinf(got), torch.isinf(want)
    if not torch.equal(gi, wi):
        raise AssertionError("+inf sentinels differ between kernel and plain version")
    g, w = got[~gi], want[~wi]
    if g.numel() == 0:
        return 0.0
    err = (g - w).abs()
    if bool((err > atol + rtol * w.abs()).any()):
        raise AssertionError(f"max abs err {float(err.max())} over tolerance (atol {atol})")
    return float(err.max())


def _ids_agree(got_i, want_i, want_d, tol) -> None:
    """Ids equal except where the plain version's distances tie within
    ``tol`` with a neighbouring slot (the order of a tie is free)."""
    import torch

    diff = got_i != want_i
    if not bool(diff.any()):
        return
    d = torch.where(torch.isinf(want_d), torch.full_like(want_d, 1e30), want_d)
    gap = torch.full_like(d, float("inf"))
    gap[:, 1:] = (d[:, 1:] - d[:, :-1]).abs()
    gap_r = torch.full_like(d, float("inf"))
    gap_r[:, :-1] = (d[:, 1:] - d[:, :-1]).abs()
    tied = torch.minimum(gap, gap_r) <= tol
    bad = diff & ~tied
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} ids differ outside ties")


def _scale(*ts) -> float:
    return float(sum(float((t * t).sum(1).max()) for t in ts))


def check_rerank_distances(torch, ops, dev, q, x, metric):
    got = ops.exact_distances(q, x, metric=metric)
    want = ops.exact_distances(q, x, metric=metric, backend="ref")
    torch.cuda.synchronize()
    # the expanded form cancels |q|^2 + |x|^2: tolerance scales with them
    return _close(got, want, atol=1e-5 * _scale(q, x))


def check_gather_rerank(torch, ops, q, x, pids, k, metric):
    gd, gi = ops.gather_rerank(q, x, pids, k, metric=metric)
    wd, wi = ops.gather_rerank(q, x, pids, k, metric=metric, backend="ref")
    torch.cuda.synchronize()
    # direct-form sums in another order: 1e-5 relative, plus 1e-6 of the
    # norms for distances near zero
    atol = 1e-6 * _scale(q, x)
    err = _close(gd, wd, atol=atol)
    finite = wd[torch.isfinite(wd)]
    top = float(finite.abs().max()) if finite.numel() else 0.0
    _ids_agree(gi, wi, wd, tol=atol + 1e-5 * top)
    return err


def check_kmeans_assign(torch, ops, x, c):
    gi, gd = ops.kmeans_assign(x, c)
    wi, wd = ops.kmeans_assign(x, c, backend="ref")
    torch.cuda.synchronize()
    tol = 1e-5 * _scale(x, c)
    err = _close(gd, wd, atol=tol)
    # assignments equal wherever the plain best-vs-second margin exceeds tol
    full = ops.exact_distances(x, c, backend="ref")
    two = torch.topk(full, min(2, c.shape[0]), dim=1, largest=False).values
    margin = (two[:, 1] - two[:, 0]) if c.shape[0] > 1 else torch.full_like(two[:, 0], float("inf"))
    bad = (gi != wi) & (margin > tol)
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} assignments differ outside near-ties")
    return err


def _pool_ids(torch, rng, q, n, p, dev, sentinel_frac=0.1, dup_frac=0.05):
    """Candidate pools shaped like search_pq's: ids sorted ascending, some
    -1 sentinels, some duplicates and some ids >= N."""
    ids = np.sort(rng.integers(0, n, size=(q, p)), axis=1)
    dups = rng.random((q, p)) < dup_frac
    ids[:, 1:] = np.where(dups[:, 1:], ids[:, :-1], ids[:, 1:])
    ids[rng.random((q, p)) < sentinel_frac] = -1
    ids[rng.random((q, p)) < 0.01] = n + 3
    return torch.as_tensor(ids.astype(np.int32)).to(dev)


def phase_kernels(torch, dev, shard_n: int, seed: int):
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed + 1)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(dev)

    rows = {}

    # ---- rerank_distances: Stage B (100 queries x the union of 4 shards x
    # k*oversample = 40 candidates), plus the ground-truth chunk shape
    q, x = t(rng.normal(size=(100, 128))), t(rng.normal(size=(4000, 128)))
    err = check_rerank_distances(torch, ops, dev, q, x, "l2")
    for args in [((7, 33), (1000, 33), "l2"), ((1, 1), (1, 1), "ip"), ((65, 130), (129, 130), "ip"),
                 ((100, 128), (4000, 128), "ip")]:
        (qs, xs, metric) = args
        check_rerank_distances(torch, ops, dev, t(rng.normal(size=qs)), t(rng.normal(size=xs)), metric)
    ms = time_ms(torch, lambda: ops.exact_distances(q, x))
    plain = time_ms(torch, lambda: ops.exact_distances(q, x, backend="ref"))

    def lib():
        q2 = (q * q).sum(1, keepdim=True)
        x2 = (x * x).sum(1)[None, :]
        return torch.addmm(q2 + x2, q, x.T, alpha=-2.0)

    lib_ms = time_ms(torch, lib)
    b, by = bound_ms(2 * 100 * 4000 * 128, 4 * (100 + 4000) * 128 + 4 * 100 * 4000)
    rows["rerank_distances"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib_ms,
                                    bound_ms=b, bound_by=by, shape="Q=100 N=4000 D=128 l2")
    gq, gx = t(rng.normal(size=(1000, 128))), t(rng.normal(size=(shard_n * 4, 128)))
    check_rerank_distances(torch, ops, dev, gq[:50], gx, "l2")
    g_ms = time_ms(torch, lambda: ops.exact_distances(gq, gx), reps=5, warmup=1)
    g_plain = time_ms(torch, lambda: ops.exact_distances(gq, gx, backend="ref"), reps=5, warmup=1)
    gb, gby = bound_ms(2 * 1000 * gx.shape[0] * 128, 4 * (1000 + gx.shape[0]) * 128 + 4 * 1000 * gx.shape[0])
    log(f"rerank_distances ground-truth chunk Q=1000 N={gx.shape[0]} D=128: kernel {g_ms:.3f} ms, "
        f"plain {g_plain:.3f} ms, bound {gb:.3f} ms ({gby})")
    del gq, gx

    # ---- gather_rerank: search_pq's call, Q = 64 (batch padding), P = L +
    # max_iters = 100 + 138, D = 128, k = k*oversample = 40, N = one shard
    pts = t(rng.normal(size=(shard_n, 128)))
    qq = t(rng.normal(size=(64, 128)))
    pids = _pool_ids(torch, rng, 64, shard_n, 238, dev)
    err = check_gather_rerank(torch, ops, qq, pts, pids, 40, "l2")
    check_gather_rerank(torch, ops, qq, pts, pids, 40, "ip")
    small = t(rng.normal(size=(50, 16)))
    sq = t(rng.normal(size=(4, 16)))
    sent = torch.full((4, 8), -1, dtype=torch.int32, device=dev)
    sent[0, :3] = torch.tensor([5, 7, 50])
    sent[1, 0] = 999
    for metric in ("l2", "ip"):
        check_gather_rerank(torch, ops, sq, small, sent, 8, metric)  # sentinels, ids >= N
        check_gather_rerank(torch, ops, sq, small, sent[:, :3].contiguous(), 10, metric)  # k > P
        check_gather_rerank(torch, ops, sq, small[:4].contiguous(), sent.clamp(max=5), 9, metric)  # k > N
        dup = _pool_ids(torch, rng, 4, 50, 12, dev, dup_frac=0.5)
        check_gather_rerank(torch, ops, sq, small, dup, 5, metric)  # duplicates
        odd_q, odd_x = t(rng.normal(size=(5, 33))), t(rng.normal(size=(70, 33)))
        check_gather_rerank(torch, ops, odd_q, odd_x, _pool_ids(torch, rng, 5, 70, 19, dev), 7, metric)
    ms = time_ms(torch, lambda: ops.gather_rerank(qq, pts, pids, 40))
    plain = time_ms(torch, lambda: ops.gather_rerank(qq, pts, pids, 40, backend="ref"))

    def lib():
        safe = pids.clamp(0, shard_n - 1).long()
        v = pts[safe]
        d = (v * v).sum(-1) - 2 * torch.einsum("qpd,qd->qp", v, qq) + (qq * qq).sum(-1, keepdim=True)
        d = torch.where((pids < 0) | (pids >= shard_n), float("inf"), d)
        return torch.topk(d, 40, dim=1, largest=False)

    lib_ms = time_ms(torch, lib)
    # every live slot is scored (duplicates twice, as the reference does),
    # but each distinct row need only be read once
    in_range = (pids >= 0) & (pids < shard_n)
    live, rows_read = int(in_range.sum()), int(torch.unique(pids[in_range]).numel())
    b, by = bound_ms(3 * live * 128, 4 * rows_read * 128 + 4 * 64 * 128 + 4 * 64 * 238 + 8 * 64 * 40)
    rows["gather_rerank"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib_ms,
                                 bound_ms=b, bound_by=by, shape=f"Q=64 P=238 D=128 k=40 N={shard_n}")
    del pts

    # ---- kmeans_assign: shard ownership (one executor's scan, K = 16 at
    # D = 128), and PQ encoding (an 8,192-row batch, K = 256 at D = 4)
    xs = t(rng.normal(size=(shard_n, 128)))
    cs = t(rng.normal(size=(16, 128)))
    err = check_kmeans_assign(torch, ops, xs, cs)
    for n, k, d in [(8192, 256, 4), (1, 1, 1), (1000, 300, 33), (777, 5, 70), (4097, 17, 128)]:
        check_kmeans_assign(torch, ops, t(rng.normal(size=(n, d))), t(rng.normal(size=(k, d))))
    ms = time_ms(torch, lambda: ops.kmeans_assign(xs, cs))
    plain = time_ms(torch, lambda: ops.kmeans_assign(xs, cs, backend="ref"))
    lib_ms = time_ms(torch, lambda: torch.cdist(xs, cs).argmin(1))
    b, by = bound_ms(2 * shard_n * 16 * 128, 4 * shard_n * 128 + 4 * 16 * 128 + 8 * shard_n)
    rows["kmeans_assign"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib_ms,
                                 bound_ms=b, bound_by=by, shape=f"N={shard_n} K=16 D=128")
    ex, ec = t(rng.normal(size=(8192, 4))), t(rng.normal(size=(256, 4)))
    e_ms = time_ms(torch, lambda: ops.kmeans_assign(ex, ec))
    e_plain = time_ms(torch, lambda: ops.kmeans_assign(ex, ec, backend="ref"))
    e_lib = time_ms(torch, lambda: torch.cdist(ex, ec).argmin(1))
    eb, eby = bound_ms(2 * 8192 * 256 * 4, 4 * 8192 * 4 + 4 * 256 * 4 + 8 * 8192)
    log(f"kmeans_assign PQ-encode batch N=8192 K=256 D=4: kernel {e_ms:.4f} ms, plain {e_plain:.4f} ms, "
        f"library {e_lib:.4f} ms, bound {eb:.5f} ms ({eby})")
    for name, r in rows.items():
        log(f"{name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
            f"max abs err {r['max_abs_err']:.3g}")
    return rows


# -- phase 3 -------------------------------------------------------------------

def phase_main_path(torch, n: int, n_queries: int, seed: int, workdir: str):
    from repro_torch.core.vamana import brute_force_topk
    from repro_torch.kernels import _build
    from repro_torch.lakehouse.table import LakehouseTable
    from repro_torch.runtime.cluster import make_local_cluster
    from repro_torch.runtime.coordinator import IndexConfig

    rng = np.random.default_rng(seed)
    t0 = time.time()
    data = mixture(n + n_queries, 128, rng)
    X, Q = data[:n], data[n:]
    log(f"data: N={n} x 128 f32 + {n_queries} queries, Gaussian mixture of {MIX_COMPONENTS} "
        f"components (centers N(0,{MIX_CENTER_SCALE}^2), rank-{MIX_RANK} covariance, "
        f"noise {MIX_NOISE}), {time.time() - t0:.1f} s")

    cluster = make_local_cluster(workdir, num_executors=4)
    table = LakehouseTable(cluster.catalog, "sift")
    table.create(dim=128)
    rows_per_group = 4096
    t0 = time.time()
    table.append_vectors(X, num_files=16, rows_per_group=rows_per_group)
    log(f"table: 16 files written in {time.time() - t0:.1f} s")
    # build_batch 1024 (IndexConfig's default is 128): an existing user
    # setting that cuts a 250k-point shard's build to ~245 batches a pass
    cfg = IndexConfig(name="idx", R=64, L=100, alpha=1.2, pq_m=32, pq_nbits=8,
                      build_batch=BUILD_BATCH)

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.time()
    rep = cluster.coordinator.create_index("sift", cfg)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    build_launches = _build.launch_counts()
    log(f"create_index: {build_s:.1f} s (stage0 {rep.stage0_seconds:.2f} s, stage1 "
        f"{rep.stage1_seconds:.2f} s, stage2 {rep.stage2_seconds:.2f} s), shards {rep.num_shards}, "
        f"vectors {rep.vector_count}, puffin {rep.total_bytes} bytes, build_batch {BUILD_BATCH}")
    if rep.vector_count != n:
        raise AssertionError(f"index holds {rep.vector_count} vectors, expected {n}")

    _build.reset_launch_counts()
    hits = []
    stage_a = stage_b = 0.0
    t0 = time.time()
    calls = n_queries // 100
    for c in range(calls):
        pr = cluster.coordinator.probe("sift", Q[c * 100 : (c + 1) * 100], 10, strategy="diskann")
        stage_a += pr.stage_a_seconds
        stage_b += pr.stage_b_seconds + pr.stage_c_seconds
        hits.extend(pr.hits)
    torch.cuda.synchronize()
    probe_s = time.time() - t0
    probe_launches = _build.launch_counts()
    launches = {k: build_launches.get(k, 0) + probe_launches.get(k, 0) for k in KERNELS}
    log(f"probe: {calls} calls x 100 queries in {probe_s:.1f} s = {calls * 100 / probe_s:.1f} QPS; "
        f"stage A {stage_a:.1f} s, stage B+C {stage_b:.1f} s")
    log(f"launches: build {build_launches}, probe {probe_launches} "
        f"(per probe call {({k: v / calls for k, v in probe_launches.items()})})")
    for name in KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    # recall@10 against brute force (the rerank_distances kernel, 1,000
    # queries a chunk); hits map back to row indices through the file layout
    starts, base = {}, 0
    for f in table.current_files():
        starts[f.path] = base
        base += f.record_count
    got = np.full((len(hits), 10), -1, np.int64)
    for qi, hs in enumerate(hits):
        if len(hs) != 10 or not all(np.isfinite(h.distance) for h in hs):
            raise AssertionError(f"query {qi}: {len(hs)} hits or non-finite distances")
        if any(a.distance > b.distance for a, b in zip(hs, hs[1:])):
            raise AssertionError(f"query {qi}: hits not ascending")
        got[qi] = [starts[h.file_path] + h.row_group * rows_per_group + h.row_offset for h in hs]
    truth_d = np.empty((len(hits), 10), np.float32)
    truth = np.empty((len(hits), 10), np.int64)
    t0 = time.time()
    for s in range(0, len(hits), 1000):
        truth_d[s : s + 1000], truth[s : s + 1000] = brute_force_topk(X, Q[s : s + 1000], 10)
    gt_s = time.time() - t0
    recall = float(np.mean([len(set(g) & set(t)) / 10 for g, t in zip(got, truth)]))
    # each returned distance is the exact one: check against a recomputation
    exact = np.sum((X[got[:200]] - Q[:200, None, :]) ** 2, axis=-1)
    d_err = float(np.max(np.abs(exact - np.array([[h.distance for h in hs] for hs in hits[:200]]))))
    log(f"recall@10 = {recall:.4f} over {len(hits)} queries (ground truth {gt_s:.1f} s); "
        f"max |hit distance - exact| = {d_err:.3g} on 200 queries")
    if d_err > 1e-3 * float(np.max(exact)):
        raise AssertionError(f"hit distances disagree with exact distances by {d_err}")
    if recall < 0.90:
        raise AssertionError(f"recall@10 {recall:.4f} < 0.90")
    return launches, dict(build_s=build_s, probe_s=probe_s, recall=recall)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="base vectors (SIFT1M: 1,000,000)")
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this smoke test runs only on a card")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()
    smi = phase_environment(torch)
    rows = phase_kernels(torch, dev, args.n // 4, args.seed)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, main = phase_main_path(
            torch, args.n, args.queries, args.seed, workdir
        )
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
        })
    log(f"total {time.time() - t_start:.1f} s")
    print(smi, flush=True)  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
