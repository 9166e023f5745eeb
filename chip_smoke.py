#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card, the full-size run
    python3 chip_smoke.py --n 262144 --queries 2000 --small-n 32768
                                     # a cut rehearsal (sizes are the only knobs cut)

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
   Phase 2 also holds the masked top-k kernels (exact, exact plane, ADC,
   ADC plane, unified) at Q = 100, D = 128, k = 40 for the exact ops and
   k = 160 for the ADC pool and the unified call (m = 32, K = 256), on
   N = one 250k shard and N = 4,096 (a phase-6 shard), each timed call
   against its plain version on its own inputs, and at their edge cases (all rows
   masked, k > N, k > passing rows, ties, ip and l2, ragged shapes,
   Q = 1, a dedup'd plane with repeated rows, unified with all-exact,
   all-ADC and mixed flavors, unified against split bit for bit).
   2b: the autotuner (``kernels/autotune.py``): its sweep at one point
   into a temporary file, every candidate query tile of every masked
   flavor bit for bit the default tile at phase 2's shapes, and the
   committed cache's tiles at phases 4, 6 and 7's shapes with their device
   ms beside the default's.
3. The main path: a SIFT1M-shaped deployment (ann-benchmarks
   sift-128-euclidean: N = 1,000,000 x 128 f32, L2, k = 10; its 10,000
   queries cut to 2,000 for the time limit), made from ``--seed`` as a
   Gaussian mixture with an int64 ``price`` attribute uniform on [0,
   10000), goes through ``make_local_cluster`` (4 executors, one card),
   ``create_index`` (build_batch 2,048) and 20 ``probe(strategy="diskann")``
   calls of 100 queries; recall@10 against ``brute_force_topk`` must reach
   0.90.  Phase 10's fault demo and the launchers of 11c and 13c run as
   processes beside it, one after another, and their phases read them.
4. Filtered probes on that index: ``price < 4`` (ExactScan after
   resolution), ``price < 200`` (MaskedBeam) and ``price < 9000``
   (PostfilterBeam), 2 ``probe`` calls of 100 queries each, then 2
   ``probe_batch`` calls mixing 10 distinct predicates; recall@10 against
   the plain masked op on the card: 0.99 on ExactScan rows, 0.90 on the
   beam bands.
5. The fresh tail: 16,384 rows appended without a refresh, 2 unfiltered
   ``probe`` calls and a heterogeneous filtered ``probe_batch``; every true
   neighbour that lies in the tail must be returned.
6. A small-shard catalog (131,072 x 128, 32 shards of 4,096 rows, PQ
   m = 32): PQScan, the ADC plane and the unified mixed-flavor batch,
   against ``force_split_flavors`` bit for bit; recall@10 of 0.90.
7. Quantized ExactScans on the phase-6 catalog (before any refresh): a
   ``price < 900`` probe (9 %: ExactScan on every 4,096-row shard, where
   the planner gives ExactScan its scan dtype) and batches of ten distinct
   ``price < 90..900`` predicates, 2 calls of 100 queries each, with
   ``scan_dtype`` bf16 and int8 (the bf16 / int8 scan at
   ``quant_guard_pool(k)``, then the full-precision ``gather_rerank``
   guard); recall@10 against the plain f32 masked op of 0.99.
8. Refresh of the 1M index: one of the 16 base files is deleted (62,500
   rows, about 6 % of a shard, under the 0.20 rebuild ratio) and
   ``compact_tail`` folds the 16,384 tail rows into the shards through
   ``refresh_index`` (tombstones plus ``insert_batch``); no deleted row
   may come back, the counts must equal the rows deleted and appended, and
   2 unfiltered probe calls must reach recall@10 0.90 over the live rows.
9. The serving tier.  (a) The phase-3 snapshot, opened by its id, its four
   shard graphs decoded from the Puffin file into a ``DeviceAnnIndex``
   (payload: global row numbers) and probed by ``make_probe_fn`` (k = 10,
   L = 100, oversample 2) in 10 calls of 100 of the phase-3 queries:
   recall@10 of 0.90 against phase 3's ground truth.  (b) A cold wave
   through ``ProbeMicroBatcher`` (max_batch 64, max_wait 2 ms, no cache) on
   the refreshed index: 1,000 submissions drawn from the first 1,000 phase-3
   queries by a Zipf law (exponent 1.1, from ``--seed``), tenants "a" and
   "b" alternating, a deadline of 10 s, one in four filtered by
   ``price < 200``, from 8 client threads with 8 submissions in flight
   each.  (c) The same submissions warm, with ``ShardProbeCache`` and
   ``SemanticResultCache`` attached: every answer bit for bit the cold
   one's, and p50 latency below the cold wave's.  (d) One file of 4,096
   rows appended, its first 10 rows copies of the 10 hottest queries: the
   warm batcher must answer each with its copy first (0 stale hits).  (e)
   200 submissions while one executor dies holding a fragment: none lost,
   each equal to a healthy ``probe_batch``.
10. The port's lifecycle examples (``examples/torch_quickstart.py``,
   ``torch_filtered_search.py``, ``torch_fault_tolerance_demo.py``, at the
   reference examples' own sizes) through ``main("cuda")``, every kernel
   call also run by its plain version and held to phase 2's tolerance:
   quickstart's scan recall@10 1.000 and diskann's 0.95, 800 rows
   inserted and 800 tombstoned, orphans reclaimed; filtered_search's
   recall@10 1.000 on each band and an identical replay; the fault demo's
   4 shards of 4,000 vectors and 4 result sets with an executor down.
   Then the fault demo once more as a process of its own: exit 0, no
   "terminate called", with its straggler's attempt still asleep.
11. kNN-LM serving.  (a) qwen2.5-3b at its published widths (36 layers,
   d 2,048, 16 heads / 2 KV heads of 128, d_ff 11,008, vocabulary 151,936,
   QKV bias; random bf16 weights from ``--seed``) built on the card; a
   corpus of 4,000 ``lm_head`` columns of random tokens plus N(0, 0.01^2),
   their tokens as payload, in a 4-file table, indexed by ``create_index``
   (the example's R = 16, L = 32, two partitions a shard, one pass), its
   Puffin shards decoded into a ``DeviceAnnIndex`` probed by
   ``make_probe_fn(k=8, L=32)``; 8 requests of 16 prompt and 32 greedy
   tokens served through ``make_serve_fns``, with and without retrieval
   (lambda 0.3): prefill and decode times beside the decode step's bound
   (the bf16 weights read once), prefill + decode logits against
   ``forward`` over the same 48 tokens within 0.06 of the logit scale,
   the retrieval step's logits finite and apart from lambda 0's, and
   recall@8 of 100 held-out-token columns (plus the same noise) against
   brute force: the device probe and ``Coordinator.probe`` each 0.90 at
   L = 512 (L = 32, the example's, printed beside it, with the decode
   steps' soft-embedding queries); a PQ twin of the corpus (m = 128) is
   probed too, so ``gather_rerank`` runs at D = 2,048 as
   ``kmeans_assign`` and ``rerank_distances`` do.  (b)
   ``examples/torch_serve_retrieval.py`` in-process: its printed lines and
   facts.  (c) ``python -m repro_torch.launch.serve --arch chatglm3-6b
   --retrieval`` as a process: exit 0.  Every kernel call of 11a and 11b
   is held against its plain version, as in phase 10.
12. kNN-LM serving by the other three decoder families, each as 11a
   (its own corpus of 4,000 ``lm_head`` columns, ``create_index`` with no
   PQ twin, the same 8 requests both ways, recall@8 of the device probe
   0.90 at L = 512, every kernel call held against its plain version),
   one model at a time: rwkv6-3b (32 layers, d 2,560, 40 wkv heads of 64,
   d_ff 8,960, vocabulary 65,536) and zamba2-1.2b (38 mamba2 layers, d
   2,048, state 64, the shared attention + MLP block after each full group
   of 6) whole, mixtral-8x7b at every published width (d 4,096, 32 / 8
   heads of 128, d_ff 14,336, 8 experts top 2, window 4,096, theta 1e6)
   with 8 of its 32 layers (46.7 B parameters, 93 GB in bf16, do not fit
   one card).  Decode against forward: the served bf16 steps are
   recorded; a twin at f32 compute on the same weights (mixtral's at the
   no-drop capacity 4.0, its two dispatches picking the same experts) is
   held within 0.06 of the logit scale.  ``kmeans_assign`` and
   ``rerank_distances`` run at D = 2,560, 2,048 and 4,096.

13. Training.  (a) One train step (2 microbatches, remat, AdamW) of each
   family's reduced config at f32 compute (qwen2.5-3b, mixtral-8x7b,
   rwkv6-3b, zamba2-1.2b, musicgen-medium) on the card against the same
   step on the CPU from the same weights: loss, grad norm, the gradient
   and the moments (v as sqrt(v)) within 1e-5 of scale (rwkv6 3e-5,
   zamba2 3e-4: its 12-layer scan differs by 9.3e-5 between two f32
   implementations on one CPU already), the params within
   1e-6 of the CPU's AdamW given the card's gradient.  (b) qwen2.5-3b at its
   published widths (f32 masters, bf16 compute, batch 8 x 128, 2
   microbatches, lr 1e-3): 12 steps on a memorisable pair of batches (the
   loss falls by more than 0.5), an async checkpoint of the whole state
   (~40.8 GB) at step 9 through the catalog, the state dropped and
   restored bit for bit, step 10 again within 1e-4 of its loss; step time
   beside its bounds, device busy time, peak memory, save and restore
   seconds.  (c) ``examples/torch_train_checkpointed.py`` in-process,
   then ``python -m repro_torch.launch.train`` twice on one warehouse (the
   second resumes from the committed step 10; both run beside phase 3,
   away from (b)'s 40.8 GB of disk writes).  No ANN kernel runs here.
14. Sharding and the dry-runs (``models/sharding.py``, ``launch/mesh.py``,
   the mesh forms of ``make_probe_fn`` / ``make_serve_fns`` /
   ``make_train_step``, ``launch/{dryrun,probe_dryrun}.py``).  (a) Right
   after 11a, on its model, weights, index and 8 requests: both serving
   runs again through ``make_serve_fns(model, make_debug_mesh(1, 1),
   SERVE_RULES, ...)`` with ``make_probe_fn(mesh, k=8, L=32)`` fused; the
   prefill and every decode step's logits, with and without retrieval,
   bit for bit 11a's (a one-rank mesh replicates everything and runs the
   same ops on the same local tensors); decode ms/step beside 11a's and
   the step's roofline bound from ``analysis/roofline.py``.  (b) Inside
   13b: the resume from the step-9 checkpoint restores into
   ``init_train_state(model, make_debug_mesh(1, 1), DEFAULT_RULES)``'s
   placed state and runs step 10 through ``make_train_step(model, mesh,
   DEFAULT_RULES, cfg)``: its loss bit for bit the first run's.  (c)
   ``python -m repro_torch.launch.probe_dryrun`` as a process (the paper's
   10^9-vector probe traced on the (16, 16) and (2, 16, 16) meshes over a
   fake group), then one device's share of that row on the card: a
   4,194,304 x 768 bf16 shard with a seeded random 64-out-neighbour int64
   adjacency, probed by 64 queries at k = 100, L = 100, oversample 2
   through ``make_probe_fn(make_debug_mesh(1, 1), ...)``; the memory it
   holds beside the row's ``hbm_per_chip_gb``, the probe's peak above its
   arguments (the counterpart of the reference's ``temp_bytes``) and its
   time beside the row's per-device ``t_memory`` / ``t_compute``; recall is
   not measured (the graph is random).  (d) ``python -m
   repro_torch.launch.dryrun --arch qwen2.5-3b --shape decode_32k`` and
   ``prefill_32k``, and ``--arch rwkv6-3b`` and ``zamba2-1.2b`` at
   ``decode_32k``, on the single-pod mesh as processes: rc 0, a row that is
   not an error; the two recurrent rows move at most 1.5x the reference's
   collective bytes, all-reduce the largest kind, nothing at the ops where
   the batch-only scan and the cache copy gathered, memory-bound.  The five
   dry-run processes use no card: they start before phase 3 and run beside
   it, and (c) and (d) read their rows.

Phase 2 also holds the quantized scans (bf16 and int8, row mask and
dedup'd plane, stored against fresh quantization) and the dense
``pq_scan`` (bit for bit) against their plain versions, and times each
exact scan (f32, bf16, int8) at k = 1, 40 and 160, with one row in 64
passing and under an all-zero mask (the k sweep: the 0 % mask is the
floor without scoring, one row in 64 adds the scoring, the 50 % mask the
select; the growth in k the select's and the merge's).  It times ``rerank_distances`` at Stage B (the small tile) and
at the ground-truth chunk (the large tile), ``gather_rerank`` at
search_pq's pool and at the quantized scan's guard, and ``kmeans_assign``
at shard ownership and at PQ encoding.  Every timed row has two times:
an event pair around one Python call (``ms``, ``plain_ms``,
``library_ms``: the host's dispatch included) and CUDA-graph replay
(``device_ms``, ``plain_device_ms``, ``library_device_ms``: the device
alone).  The masked rows also carry the device time of their two
launches apart (``pass_ms``, from ``torch.profiler``), row 5 (f32) is
timed again under phase 4's ``price < 4`` and ``price < 200`` bands, rows
5' (bf16) and 4 (int8) at phase 7's ``price < 900`` on 4,096 rows, row 6
(int8 plane) there under phase 7's ten bands, and rows 8, 8' and 9 (ADC,
ADC plane, unified) at phase 6's masks on 4,096 rows (``at_shapes``); the
ADC op has a k sweep too.
``--parent DIR`` then holds
``masked_topk.cu``, ``rerank.cu``, ``kmeans_assign.cu`` and ``pq_scan.cu``
of the checkout ``DIR`` against this one's (equal bits on every launch
name but the bf16 ones, which are held to the plain version's tolerance;
times in turns), and, without ``--only-kernels``, every
``gather_rerank``, ``kmeans_assign`` and ``rerank_distances`` call and
every int8, masked ADC and unified call of phases 3-9 too;
``--only-kernels`` stops after phase 2 without the result lines.

Every phase from 3 on sets the launch counts to 0 before it runs and reads
them after (``kmeans_assign`` also by (D, K), ``gather_rerank`` by
(P, k), ``rerank_distances`` by tile, where phases 3-9 must stay on the
shapes phase 2 checked; phase 3 counts its ground truth; phases 10 and 11
hold each call against the plain version instead, as does phase 12;
phase 13's training path, 13b and the 13c example, must launch none:
13a holds a step against the CPU's, as phase 2 holds a kernel);
each kernel but ``pq_scan`` must have run on these paths
(``pq_scan`` has no production caller, in this package or the reference,
so phase 2 alone holds it).  The line before the last is the ``kernels``
JSON; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE / "src"))

# H100 SXM published peaks (NVIDIA data sheet), kept in one place: f32
# outside the tensor cores, dense bf16 and int8 on the tensor cores, and
# HBM3 bandwidth
from repro_torch.analysis.roofline import HBM_BW as PEAK_BYTES  # noqa: E402
from repro_torch.analysis.roofline import PEAK_FLOPS as PEAK_BF16  # noqa: E402
from repro_torch.analysis.roofline import PEAK_FLOPS_F32 as PEAK_F32  # noqa: E402
from repro_torch.analysis.roofline import PEAK_FLOPS_INT8 as PEAK_INT8  # noqa: E402

MASKED_CU = "src/repro_torch/kernels/csrc/masked_topk.cu"
MASKED_PY = "src/repro/kernels/masked_topk.py"
KERNELS = {
    "rerank_distances": ("src/repro_torch/kernels/csrc/rerank.cu", "src/repro/kernels/rerank.py:90"),
    "gather_rerank": ("src/repro_torch/kernels/csrc/rerank.cu", "src/repro/kernels/rerank.py:175"),
    "kmeans_assign": (
        "src/repro_torch/kernels/csrc/kmeans_assign.cu",
        "src/repro/kernels/kmeans_assign.py:71",
    ),
    "masked_exact_topk": (MASKED_CU, f"{MASKED_PY}:304"),
    "masked_exact_topk_multi": (MASKED_CU, f"{MASKED_PY}:372"),
    "masked_pq_topk": (MASKED_CU, f"{MASKED_PY}:406"),
    "masked_pq_topk_multi": (MASKED_CU, f"{MASKED_PY}:590"),
    "unified_masked_topk": (MASKED_CU, f"{MASKED_PY}:539"),
    "masked_exact_topk_bf16": (MASKED_CU, f"{MASKED_PY}:304"),
    "masked_exact_topk_int8": (MASKED_CU, f"{MASKED_PY}:289"),
    "masked_exact_topk_multi_bf16": (MASKED_CU, f"{MASKED_PY}:372"),
    "masked_exact_topk_multi_int8": (MASKED_CU, f"{MASKED_PY}:357"),
    "pq_scan": ("src/repro_torch/kernels/csrc/pq_scan.cu", "src/repro/kernels/pq_scan.py:74"),
}
# no production caller in either package: held in phase 2 only
PHASE2_ONLY = ("pq_scan",)
QUANT = {"bf16": PEAK_BF16, "int8": PEAK_INT8}  # scan dtype -> peak operation rate
# the unfiltered build and probe of phase 3
MAIN_KERNELS = ("rerank_distances", "gather_rerank", "kmeans_assign")
PRICE_MAX = 10_000  # the price attribute is uniform on [0, PRICE_MAX)
TAIL_ROWS = 16_384  # phase 5: 4 row groups of 4,096
SMALL_SHARD = 4_096  # planner.EXACT_SCAN_MAX_ROWS: PQScan only up to this size

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
BUILD_BATCH = 2048


def log(msg: str) -> None:
    print(msg, flush=True)


class Beside:
    """Processes that need nothing of phases 3-9 (phase 10's fault demo, the
    launchers of 11c and 13c) run one after another on a thread beside
    phase 3, whose card is mostly idle while the host builds the graph;
    each phase then reads its own result.  ``stop`` kills the one running."""

    def __init__(self, jobs):
        self.jobs = jobs  # [(key, argv, cwd, env)]
        self.results = {}
        self.ready = {key: threading.Event() for key, *_ in jobs}
        self.lock = threading.Lock()
        self.proc = None
        self.stopping = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for key, argv, cwd, env in self.jobs:
                t0 = time.time()
                with self.lock:
                    if self.stopping:
                        break
                    self.proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True, cwd=cwd, env=env)
                try:
                    out, err = self.proc.communicate(timeout=600)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    out, err = self.proc.communicate()
                    err += "\nkilled after 600 s"
                self.results[key] = (self.proc.returncode, out, err, time.time() - t0)
                self.ready[key].set()
        finally:  # a job that could not start leaves the rest unrun, never a reader waiting
            for ev in self.ready.values():
                ev.set()

    def result(self, key):
        """(returncode, stdout, stderr, seconds) of the job ``key``."""
        self.ready[key].wait()
        return self.results.get(key, (None, "", "did not run: a job before it failed to start, or the smoke stopped", 0.0))

    def stop(self):
        with self.lock:
            self.stopping = True
            proc = self.proc
        if proc is not None and proc.poll() is None:
            proc.kill()
        self.thread.join()


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_F32) -> tuple:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
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


def device_ms(torch, fn, inner: int = 20, reps: int = 15) -> float:
    """Device time of one call of ``fn`` (ms): ``inner`` calls captured in one
    CUDA graph, the graph replayed ``reps`` times between CUDA events, the
    median over replays.  Replay leaves out the host's dispatch (Python,
    ctypes, the wrapper's checks), which an event pair around one call of a
    few-microsecond kernel (``time_ms``) measures instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    del graph
    return float(np.median(times))


def pass_split_ms(torch, fn, reps: int = 10):
    """Device time of a masked launch's two kernels apart (ms a call), from
    ``torch.profiler``: pass 1 (``chunk_topk_kernel``: mask, scoring and the
    chunk select) and pass 2 (``merge_kernel``).  (None, None) where the
    trace holds no device time for them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = [0.0, 0.0]
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if "chunk_topk_kernel" in e.key:
            split[0] += us
        elif "merge_kernel" in e.key:
            split[1] += us
    if not split[0]:
        return None, None
    return split[0] / reps / 1e3, split[1] / reps / 1e3


def _split_text(split) -> str:
    p1, p2 = split
    return "split not measured" if p1 is None else f"pass 1 {p1:.4f} + pass 2 {p2:.4f} ms"


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
    # the dry-runs' fake process group (phase 14) rests on this private module
    from torch.testing._internal.distributed.fake_pg import FakeStore

    log(f"fake process group store imports: {FakeStore.__module__}.{FakeStore.__name__}")
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


def distances_close(torch, q, x, got, want):
    torch.cuda.synchronize()
    # the expanded form cancels |q|^2 + |x|^2: tolerance scales with them
    return _close(got, want, atol=1e-5 * _scale(q, x))


def pooled_close(torch, q, x, got, want):
    """``gather_rerank``'s (dists, ids) against the plain version's."""
    torch.cuda.synchronize()
    # direct-form sums in another order: 1e-5 relative, plus 1e-6 of the
    # norms for distances near zero
    atol = 1e-6 * _scale(q, x)
    err = _close(got[0], want[0], atol=atol)
    finite = want[0][torch.isfinite(want[0])]
    top = float(finite.abs().max()) if finite.numel() else 0.0
    _ids_agree(got[1], want[1], want[0], tol=atol + 1e-5 * top)
    return err


def assigned_close(torch, ops, x, c, got, want):
    """``kmeans_assign``'s (ids, dists) against the plain version's."""
    torch.cuda.synchronize()
    tol = 1e-5 * _scale(x, c)
    err = _close(got[1], want[1], atol=tol)
    # assignments equal wherever the plain best-vs-second margin exceeds tol
    full = ops.exact_distances(x, c, backend="ref")
    two = torch.topk(full, min(2, c.shape[0]), dim=1, largest=False).values
    margin = (two[:, 1] - two[:, 0]) if c.shape[0] > 1 else torch.full_like(two[:, 0], float("inf"))
    bad = (got[0] != want[0]) & (margin > tol)
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} assignments differ outside near-ties")
    return err


def check_rerank_distances(torch, ops, dev, q, x, metric):
    from repro_torch.kernels.rerank import tile_class

    CHECKED["rerank_distances"].add(tile_class(q.shape[0], x.shape[0], q.shape[1]))
    return distances_close(torch, q, x, ops.exact_distances(q, x, metric=metric),
                           ops.exact_distances(q, x, metric=metric, backend="ref"))


# the shapes phase 2 held against the plain version: gather_rerank by
# (P, k), kmeans_assign by (D, K), rerank_distances by tile; every shape
# phases 3-9 launch must be here
CHECKED: dict = {"gather_rerank": set(), "kmeans_assign": set(), "rerank_distances": set()}
# graph-replay times of every row, beside its host-inclusive ms, plain_ms
# and library_ms
DEVICE_KEYS = ("device_ms", "plain_device_ms", "library_device_ms")


def check_gather_rerank(torch, ops, q, x, pids, k, metric):
    CHECKED["gather_rerank"].add((pids.shape[1], k))
    return pooled_close(torch, q, x, ops.gather_rerank(q, x, pids, k, metric=metric),
                        ops.gather_rerank(q, x, pids, k, metric=metric, backend="ref"))


def check_kmeans_assign(torch, ops, x, c):
    CHECKED["kmeans_assign"].add((x.shape[1], c.shape[0]))
    return assigned_close(torch, ops, x, c, ops.kmeans_assign(x, c),
                          ops.kmeans_assign(x, c, backend="ref"))


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
    # k*oversample = 40 candidates; the small tile), the ground-truth chunk
    # (1,000 queries x the 1M rows; the large tile), and the tiles' edges
    q, x = t(rng.normal(size=(100, 128))), t(rng.normal(size=(4000, 128)))
    err = check_rerank_distances(torch, ops, dev, q, x, "l2")
    for args in [((7, 33), (1000, 33), "l2"), ((1, 1), (1, 1), "ip"), ((65, 130), (129, 130), "ip"),
                 ((100, 128), (4000, 128), "ip"), ((300, 33), (20000, 33), "l2"),
                 ((33, 300), (5000, 300), "l2"), ((600, 33), (20000, 33), "l2"),
                 ((300, 130), (70000, 130), "ip")]:
        (qs, xs, metric) = args
        check_rerank_distances(torch, ops, dev, t(rng.normal(size=qs)), t(rng.normal(size=xs)), metric)
    def timings(kernel, plain, lib, slow=False):
        """Rows 1-3 are microsecond kernels.  ms, plain_ms and library_ms
        are host-inclusive (time_ms), as in every other row; the *device_ms
        twins are graph replay (device_ms), without the host's dispatch.
        ``slow``: calls of milliseconds that write gigabytes, timed fewer
        times, one call a graph."""
        if slow:
            return dict(ms=time_ms(torch, kernel, reps=5, warmup=1),
                        plain_ms=time_ms(torch, plain, reps=5, warmup=1),
                        library_ms=time_ms(torch, lib, reps=5, warmup=1),
                        device_ms=device_ms(torch, kernel, inner=1, reps=5),
                        plain_device_ms=device_ms(torch, plain, inner=1, reps=3),
                        library_device_ms=device_ms(torch, lib, inner=1, reps=3))
        return dict(ms=time_ms(torch, kernel), plain_ms=time_ms(torch, plain),
                    library_ms=time_ms(torch, lib), device_ms=device_ms(torch, kernel),
                    plain_device_ms=device_ms(torch, plain), library_device_ms=device_ms(torch, lib))

    def rerank_row(q, x, err, slow=False):
        from repro_torch.kernels.rerank import tile_class

        (nq, d), n = q.shape, x.shape[0]

        def lib():
            q2 = (q * q).sum(1, keepdim=True)
            x2 = (x * x).sum(1)[None, :]
            return torch.addmm(q2 + x2, q, x.T, alpha=-2.0)

        times = timings(lambda: ops.exact_distances(q, x), lambda: ops.exact_distances(q, x, backend="ref"),
                        lib, slow=slow)
        b, by = bound_ms(2 * nq * n * d, 4 * (nq + n) * d + 4 * nq * n)
        tile = tile_class(nq, n, d)
        return dict(max_abs_err=err, **times, bound_ms=b, bound_by=by,
                    shape=f"Q={nq} N={n} D={d} l2, {tile[0]} tile", launch_shape=tile)

    main = rerank_row(q, x, err)
    gq, gx = t(rng.normal(size=(1000, 128))), t(rng.normal(size=(shard_n * 4, 128)))
    g_err = check_rerank_distances(torch, ops, dev, gq, gx, "l2")
    check_rerank_distances(torch, ops, dev, gq[:50], gx, "ip")
    rows["rerank_distances"] = dict(main, shapes=[main, rerank_row(gq, gx, g_err, slow=True)])
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
        # a pool past one warp's sort (the block sorts it), k past P
        big = _pool_ids(torch, rng, 8, shard_n, 600, dev)
        check_gather_rerank(torch, ops, qq[:8].contiguous(), pts, big, 40, metric)
        check_gather_rerank(torch, ops, qq[:8].contiguous(), pts, big, 605, metric)
        # the filtered beams' reranks: P = 298 (a warp sorts 16 keys a lane)
        # at k = 160, and Stage A at k = 80
        check_gather_rerank(torch, ops, qq, pts, _pool_ids(torch, rng, 64, shard_n, 298, dev), 160, metric)
        check_gather_rerank(torch, ops, qq, pts, pids, 80, metric)

    def gather_row(qq, pts, pids, k, err):
        n = pts.shape[0]

        def lib():
            safe = pids.clamp(0, n - 1).long()
            v = pts[safe]
            d = (v * v).sum(-1) - 2 * torch.einsum("qpd,qd->qp", v, qq) + (qq * qq).sum(-1, keepdim=True)
            d = torch.where((pids < 0) | (pids >= n), float("inf"), d)
            return torch.topk(d, k, dim=1, largest=False)

        times = timings(lambda: ops.gather_rerank(qq, pts, pids, k),
                        lambda: ops.gather_rerank(qq, pts, pids, k, backend="ref"), lib)
        # every live slot is scored (duplicates twice, as the reference does),
        # but each distinct row need only be read once
        (nq, p), d = pids.shape, qq.shape[1]
        in_range = (pids >= 0) & (pids < n)
        live, rows_read = int(in_range.sum()), int(torch.unique(pids[in_range]).numel())
        b, by = bound_ms(3 * live * d, 4 * rows_read * d + 4 * nq * d + 4 * nq * p + 8 * nq * k)
        return dict(max_abs_err=err, **times, bound_ms=b, bound_by=by,
                    shape=f"Q={nq} P={p} D={d} k={k} N={n}", launch_shape=(p, k))

    main = gather_row(qq, pts, pids, 40, err)
    # the quantized scan's full-precision guard (phase 7): quant_guard_pool(40)
    # = 160 candidates of a 4,096-row shard, 100 queries
    gpts, gq = t(rng.normal(size=(SMALL_SHARD, 128))), t(rng.normal(size=(100, 128)))
    gpids = _pool_ids(torch, rng, 100, SMALL_SHARD, 160, dev)
    g_err = check_gather_rerank(torch, ops, gq, gpts, gpids, 40, "l2")
    check_gather_rerank(torch, ops, gq, gpts, gpids, 40, "ip")
    rows["gather_rerank"] = dict(main, shapes=[main, gather_row(gq, gpts, gpids, 40, g_err)])
    del pts

    # ---- kmeans_assign: shard ownership (one executor's scan, K = 16 at
    # D = 128), and PQ encoding (an 8,192-row batch, K = 256 at D = 4)
    def kmeans_row(xs, cs, err):
        (n, d), k = xs.shape, cs.shape[0]
        times = timings(lambda: ops.kmeans_assign(xs, cs), lambda: ops.kmeans_assign(xs, cs, backend="ref"),
                        lambda: torch.cdist(xs, cs).argmin(1))
        b, by = bound_ms(2 * n * k * d, 4 * n * d + 4 * k * d + 8 * n)
        return dict(max_abs_err=err, **times, bound_ms=b, bound_by=by, shape=f"N={n} K={k} D={d}",
                    launch_shape=(d, k))

    xs = t(rng.normal(size=(shard_n, 128)))
    cs = t(rng.normal(size=(16, 128)))
    err = check_kmeans_assign(torch, ops, xs, cs)
    # (8192, 128, 128): Stage 0 of the small-shard catalog (32 shards x 4
    # partitions on the 8,192-row sample), centroids in two shared-memory
    # tiles; (8192, 32, 128): the same in the cut rehearsal (--small-n 32768)
    for n, k, d in [(1, 1, 1), (1000, 300, 33), (777, 5, 70), (4097, 17, 128), (3000, 16, 130),
                    (2000, 16, 400), (8192, 128, 128), (8192, 32, 128)]:
        check_kmeans_assign(torch, ops, t(rng.normal(size=(n, d))), t(rng.normal(size=(k, d))))
    ex, ec = t(rng.normal(size=(8192, 4))), t(rng.normal(size=(256, 4)))
    main = kmeans_row(xs, cs, err)
    rows["kmeans_assign"] = dict(main, shapes=[main, kmeans_row(ex, ec, check_kmeans_assign(torch, ops, ex, ec))])
    for name, row in rows.items():
        for r in row.get("shapes", [row]):
            log(f"{name} [{r['shape']}]: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                f"{r['library_ms']:.4f} ms (with the host's dispatch); on the device (graph replay) kernel "
                f"{r['device_ms']:.4f} ms, plain {r['plain_device_ms']:.4f} ms, library "
                f"{r['library_device_ms']:.4f} ms; bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
                f"max abs err {r['max_abs_err']:.3g}")
    return rows


def _check_topk(torch, got, want, atol, what):
    """Kernel (dists, ids) against the plain version's: distances within
    ``atol`` (1e-5 relative on top), the same +inf sentinels with id -1,
    ids equal except on ties within the tolerance."""
    gd, gi = got
    wd, wi = want
    torch.cuda.synchronize()
    try:
        err = _close(gd, wd, atol=atol)
        if not torch.equal(gi < 0, torch.isinf(gd)) or not torch.equal(wi < 0, torch.isinf(wd)):
            raise AssertionError("(+inf, -1) sentinels do not pair up")
        finite = wd[torch.isfinite(wd)]
        top = float(finite.abs().max()) if finite.numel() else 0.0
        _ids_agree(gi, wi, wd, tol=atol + 1e-5 * top)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None
    return err


def _masked_case(torch, dev, rng, q, n, d, frac, ints=False, m=32, kc=256):
    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    if ints:  # integer values: exact sums, and duplicated rows tie exactly
        x = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
        x[n // 2 :] = x[: n - n // 2]
        qs = rng.integers(-2, 3, size=(q, d)).astype(np.float32)
        luts = rng.integers(0, 4, size=(q, m, kc)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        qs = rng.normal(size=(q, d)).astype(np.float32)
        luts = rng.random((q, m, kc)).astype(np.float32)
    codes = rng.integers(0, kc, size=(n, m)).astype(np.uint8)
    plane = rng.random((q, n)) < frac
    return t(qs), t(x), t(luts), t(codes), t(plane)


def _masked_checks(torch, ops, q, x, luts, codes, plane, k, what, metrics=("l2", "ip"), k_adc=None):
    """Every masked op, kernel against plain, on one input; the unified op
    also against the split kernels bit for bit.  The exact ops take ``k``,
    the ADC and unified ops ``k_adc`` (default ``k``), as the main path
    gives the PQ pool and the unified call a wider k.  Returns max errors."""
    from repro_torch.kernels import masked_topk as km

    k_adc = k if k_adc is None else k_adc
    errs = {}
    atol = 1e-5 * _scale(q, x)
    n_q = q.shape[0]
    rows = torch.arange(n_q, dtype=torch.int32, device=q.device)
    uniq = plane[: max(1, n_q // 2)]
    idx = torch.as_tensor(np.arange(n_q) % uniq.shape[0]).to(q.device)
    for metric in metrics:
        for name, fn, args in (
            ("masked_exact_topk", ops.masked_exact_topk, (q, x, plane[0], k)),
            ("masked_exact_topk_multi", ops.masked_exact_topk_multi, (q, x, plane, k)),
            ("masked_exact_topk_multi", ops.masked_exact_topk_dedup, (q, x, uniq, idx, k)),
        ):
            e = _check_topk(torch, fn(*args, metric=metric), fn(*args, metric=metric, backend="ref"),
                            atol, f"{what} {name} {metric}")
            errs[name] = max(errs.get(name, 0.0), e)
    # ADC sums run in the plain version's order: the bound is loose on purpose
    satol = 1e-5 * float(luts.amax(2).sum(1).max()) if luts.numel() else 0.0
    for name, fn, args in (
        ("masked_pq_topk", ops.masked_pq_topk, (luts, codes, plane[0], k_adc)),
        ("masked_pq_topk_multi", ops.masked_pq_topk_multi, (luts, codes, plane, k_adc)),
        ("masked_pq_topk_multi", ops.masked_pq_topk_dedup, (luts, codes, uniq, idx, k_adc)),
    ):
        e = _check_topk(torch, fn(*args), fn(*args, backend="ref"), satol, f"{what} {name}")
        errs[name] = max(errs.get(name, 0.0), e)
    for kind in ("exact", "adc", "mixed"):
        fl = {"exact": torch.zeros(n_q, dtype=torch.bool), "adc": torch.ones(n_q, dtype=torch.bool),
              "mixed": torch.arange(n_q) % 2 == 1}[kind].to(q.device)
        for metric in metrics:
            args = (q, x, luts, codes, plane, fl, k_adc)
            got = ops.unified_masked_topk(*args, metric=metric)
            e = _check_topk(torch, got, ops.unified_masked_topk(*args, metric=metric, backend="ref"),
                            max(atol, satol), f"{what} unified {kind} {metric}")
            errs["unified_masked_topk"] = max(errs.get("unified_masked_topk", 0.0), e)
            ex = km.masked_exact_topk(q, x, plane.to(torch.uint8), rows, k_adc, metric=metric)
            pq = km.masked_pq_topk(luts, codes, plane.to(torch.uint8), rows, k_adc)
            for a, b, c in zip(got, ex, pq):
                if not torch.equal(a, torch.where(fl[:, None], c, b)):
                    raise AssertionError(f"{what}: unified {kind} {metric} differs from split bit for bit")
            dd = ops.unified_masked_topk_dedup(q, x, luts, codes, uniq, idx, fl, k_adc, metric=metric)
            dense = ops.unified_masked_topk(q, x, luts, codes, uniq[idx], fl, k_adc, metric=metric)
            if not (torch.equal(dd[0], dense[0]) and torch.equal(dd[1], dense[1])):
                raise AssertionError(f"{what}: unified dedup {kind} {metric} differs from dense")
    return errs


SWEEP_K = (1, 40, 160)


def _sweep_masks(mask):
    """The k sweep's two other masks: one row in 64 passing (every 64-row
    step is scored, the select sees 8 live rows a chunk) and none (no step
    is scored: the mask pass, the sentinels and the merge)."""
    sparse = mask.new_zeros(mask.shape)
    sparse[..., ::64] = True
    return {"1 row in 64": sparse, "mask 0%": mask.new_zeros(mask.shape)}


def _k_sweep(torch, name, fn, mask, shape):
    """Times (ms) of one exact scan ``fn(mask, k)`` at k = 1, 40 and 160 on
    ``mask``, and at k = 160 with one row in 64 passing and with none, each
    beside its pass-1 / pass-2 split on the device.  The 0 % mask is the
    floor without scoring (mask pass, sentinels, merge), one row in 64 adds
    the scoring of every row with almost no select, and ``mask`` adds the
    select; the growth in k is the select's and the merge's.  Logs one
    line."""
    calls = {f"k={k}": (mask, k) for k in SWEEP_K}
    calls.update({f"{label} k={SWEEP_K[-1]}": (m, SWEEP_K[-1]) for label, m in _sweep_masks(mask).items()})
    parts = []
    for label, (m, k) in calls.items():
        ms = time_ms(torch, lambda m=m, k=k: fn(m, k))
        parts.append(f"{label} {ms:.4f} ms ({_split_text(pass_split_ms(torch, lambda m=m, k=k: fn(m, k)))})")
    log(f"k sweep {name} [{shape}]: " + ", ".join(parts))


def _masked_bound(q_rows, plane, d, m, kc, k, flavor, elem=4, peak=PEAK_F32):
    """Least time for a masked top-k: each row that passes for some query
    read once (D values of ``elem`` bytes for exact rows, m code bytes for
    ADC rows), the masks and queries read once, the outputs written once;
    operations 2 D per passing (query, row) cell for exact at ``peak``, m
    adds for ADC."""
    cells = plane.sum(1).double()
    rows = int(plane.any(0).sum())
    ex, adc = ~flavor, flavor
    flops = 2 * d * float(cells[ex].sum()) + m * float(cells[adc].sum())
    nbytes = (elem * d * rows * bool(ex.any()) + m * rows * bool(adc.any())
              + plane.shape[1] * q_rows + elem * d * int(ex.sum()) + 4 * m * kc * int(adc.sum())
              + 8 * plane.shape[0] * k)
    return bound_ms(flops, nbytes, peak)


def phase_masked_kernels(torch, dev, shard_n: int, seed: int):
    """The masked kernels against their plain versions at the main-path
    shapes (Q = 100 queries on one shard; the filtered probes of phases 4
    to 6) and at their edge cases; times beside bounds and yardsticks."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed + 2)
    errs: dict = {}

    def merge(e):
        for key, v in e.items():
            errs[key] = max(errs.get(key, 0.0), v)

    # edge cases (a small m K keeps the plain ADC versions cheap)
    edge = [
        ("all masked", dict(q=4, n=600, d=16, frac=0.0), 10),
        ("k > N", dict(q=3, n=7, d=8, frac=1.0), 12),
        ("k > passing", dict(q=4, n=700, d=16, frac=0.005), 10),
        ("ties", dict(q=4, n=400, d=8, frac=0.8, ints=True), 12),
        ("ragged Q/N/D", dict(q=3, n=1301, d=33, frac=0.6), 9),
        ("Q = 1", dict(q=1, n=1000, d=128, frac=0.5), 40),
        ("k > chunk", dict(q=3, n=1300, d=8, frac=0.7), 600),
        ("plane, repeated rows", dict(q=37, n=5000, d=64, frac=0.3), 40),
    ]
    for what, kw, k in edge:
        q, x, luts, codes, plane = _masked_case(torch, dev, rng, m=8, kc=16, **kw)
        merge(_masked_checks(torch, ops, q, x, luts, codes, plane, k, what))
    log(f"masked kernels: {len(edge)} edge cases match their plain versions")

    # main-path shapes: Q = 100 queries, D = 128, k = 40 exact; the ADC
    # pool and the unified call at k = 160 (m = 32, K = 256).  On one
    # 250k-row shard (phases 4 and 5) and on one 4,096-row shard (phase 6,
    # where PQScan and the unified kernel run)
    Q, D, M, KC = 100, 128, 32, 256
    thresholds = (2, 3, 4, 5, 6, 100, 325, 550, 775, 1000)
    small_n = 4096
    q, x, luts, codes, _ = _masked_case(torch, dev, rng, Q, small_n, D, 0.0, m=M, kc=KC)
    price = torch.as_tensor(rng.integers(0, PRICE_MAX, size=small_n)).to(dev)
    plane = torch.stack([price < 3000 + 500 * (i % 8) for i in range(Q)])
    merge(_masked_checks(torch, ops, q, x, luts, codes, plane, 40, f"main shape N={small_n}",
                         metrics=("l2",), k_adc=160))
    small = _phase6_rows(torch, ops, q, x, luts, codes, price)

    q, x, luts, codes, _ = _masked_case(torch, dev, rng, Q, shard_n, D, 0.0, m=M, kc=KC)
    price = torch.as_tensor(rng.integers(0, PRICE_MAX, size=shard_n)).to(dev)
    # masks as the filtered phases make them: price < t for ten thresholds
    uniq = torch.stack([price < t for t in thresholds])
    wide = price < 5000
    idx = torch.as_tensor(np.arange(Q) % uniq.shape[0]).to(dev)
    flavor = torch.arange(Q, device=dev) % 2 == 1
    none, allq = torch.zeros(Q, dtype=torch.bool, device=dev), torch.ones(Q, dtype=torch.bool, device=dev)
    merge(_masked_checks(torch, ops, q, x, luts, codes, uniq[idx], 40, f"main shape N={shard_n}",
                         metrics=("l2",), k_adc=160))
    atol = 1e-5 * _scale(q, x)
    satol = 1e-5 * float(luts.amax(2).sum(1).max())

    def lib_exact(mask):
        q2 = (q * q).sum(1, keepdim=True)
        x2 = (x * x).sum(1)[None, :]
        d = torch.addmm(q2 + x2, q, x.T, alpha=-2.0).masked_fill_(~mask, float("inf"))
        return torch.topk(d, 40, dim=1, largest=False)

    lg = codes.T.long()[None].expand(Q, M, shard_n)

    def lib_adc(mask, k):
        d = torch.gather(luts, 2, lg).sum(1).masked_fill_(~mask, float("inf"))
        return torch.topk(d, k, dim=1, largest=False)

    plane_bcast = wide[None, :].expand(Q, -1)
    _k_sweep(torch, "masked_exact_topk", lambda m, k: ops.masked_exact_topk(q, x, m, k), wide,
             f"Q=100 N={shard_n} D=128 mask 50%")
    _k_sweep(torch, "masked_pq_topk", lambda m, k: ops.masked_pq_topk(luts, codes, m, k), wide,
             f"Q=100 N={shard_n} m=32 K=256 mask 50%")
    cases = {
        "masked_exact_topk": (
            lambda b: ops.masked_exact_topk(q, x, wide, 40, backend=b),
            lambda: lib_exact(wide), (1, plane_bcast, none, 40), atol,
            "Q=100 N=%d D=128 k=40 mask 50%%"),
        "masked_exact_topk_multi": (
            lambda b: ops.masked_exact_topk_dedup(q, x, uniq, idx, 40, backend=b),
            lambda: lib_exact(uniq[idx]), (uniq.shape[0], uniq[idx], none, 40), atol,
            "Q=100 N=%d D=128 k=40 plane of 10 price masks"),
        "masked_pq_topk": (
            lambda b: ops.masked_pq_topk(luts, codes, wide, 160, backend=b),
            lambda: lib_adc(wide, 160), (1, plane_bcast, allq, 160), satol,
            "Q=100 N=%d m=32 K=256 k=160 mask 50%%"),
        "masked_pq_topk_multi": (
            lambda b: ops.masked_pq_topk_dedup(luts, codes, uniq, idx, 160, backend=b),
            lambda: lib_adc(uniq[idx], 160), (uniq.shape[0], uniq[idx], allq, 160), satol,
            "Q=100 N=%d m=32 K=256 k=160 plane of 10 price masks"),
        "unified_masked_topk": (
            lambda b: ops.unified_masked_topk_dedup(q, x, luts, codes, uniq, idx, flavor, 160, backend=b),
            None, (uniq.shape[0], uniq[idx], flavor, 160), max(atol, satol),
            "Q=100 (50 exact, 50 ADC) N=%d D=128 m=32 K=256 k=160 plane of 10 price masks"),
    }
    rows = {}
    # the unified wrapper reads the exact-query count back from the card, a
    # host sync that a CUDA graph cannot capture: its device time is the
    # launch with that count worked out once (the same call, bit for bit)
    captured = {"unified_masked_topk": _unified_launch(torch, q, x, luts, codes, uniq, idx, flavor, 160)}
    for name, (fn, lib, (q_rows, plane, fl, k), tol, shape) in cases.items():
        rows[name] = _masked_row(torch, name, fn, lib, _masked_bound(q_rows, plane, D, M, KC, k, fl), tol,
                                 shape % shard_n, kernel=captured.get(name))
        log(f"{name} [{rows[name]['shape']}]: {_times_line(rows[name])}, max abs err "
            f"{rows[name]['max_abs_err']:.3g} (over every check of phase 2: {errs[name]:.3g})")
    # row 5 where the main path runs it: 100 queries on a 250k-row shard
    # under phase 4's ExactScan band (price < 4) and MaskedBeam's fallback
    # band (price < 200), k = 40
    at = []
    for thr in PROD_F32_BANDS:
        band = price < thr
        at.append(_masked_row(
            torch, "masked_exact_topk", lambda b, m=band: ops.masked_exact_topk(q, x, m, 40, backend=b),
            lambda m=band: lib_exact(m), _masked_bound(1, band[None, :].expand(Q, -1), D, M, KC, 40, none),
            atol, f"Q=100 N={shard_n} D=128 k=40 price < {thr}"))
        log(f"masked_exact_topk [{at[-1]['shape']}]: {_times_line(at[-1])}, max abs err "
            f"{at[-1]['max_abs_err']:.3g}")
    rows["masked_exact_topk"]["at_shapes"] = at
    for name, row in small.items():
        rows[name]["at_shapes"] = [row]
    del lg
    return rows


# phase 4's price bands where row 5 (f32) runs on 250k-row shards: ExactScan
# (price < 4) and the MaskedBeam fallbacks (price < 200)
PROD_F32_BANDS = (4, 200)
# phase 7's band where rows 5' (bf16) and 4 (int8) run on 4,096-row shards,
# and its batches' ten bands (row 6 there)
PROD_BF16_BAND = 900
PROD_QUANT_BANDS = tuple(90 * (j + 1) for j in range(10))
# phase 6 on 4,096-row shards: the PQScan band (row 8), the plane of eight
# bands (row 8'), and the unified batch's exact band beside that plane (row 9)
PROD_PQ_BAND = 3000
PROD_PQ_PLANE = tuple(3000 + 500 * j for j in range(8))
PROD_UNIFIED_EXACT_BAND = 20


def phase6_masks(torch, price, q_count):
    """Phase 6's masks on one shard as (unique rows, row index, flavor) for
    each ADC row: the PQScan band for every query, the eight-band plane
    (query i under band i % 8), and the unified batch (even queries exact
    under price < 20, odd ones ADC under band (i // 2) % 8)."""
    dev = price.device
    i = np.arange(q_count)
    band = torch.stack([price < PROD_PQ_BAND])
    plane = torch.stack([price < t for t in PROD_PQ_PLANE])
    mixed = torch.stack([price < PROD_UNIFIED_EXACT_BAND] + [price < t for t in PROD_PQ_PLANE])
    mixed_idx = np.where(i % 2 == 0, 0, 1 + (i // 2) % 8)
    return {
        "masked_pq_topk": (band, torch.zeros(q_count, dtype=torch.int64, device=dev), None),
        "masked_pq_topk_multi": (plane, torch.as_tensor(i % 8).to(dev), None),
        "unified_masked_topk": (mixed, torch.as_tensor(mixed_idx).to(dev),
                                torch.as_tensor(i % 2 == 1).to(dev)),
    }


def _phase6_rows(torch, ops, q, x, luts, codes, price) -> dict:
    """Rows 8, 8' and 9 where phase 6 runs them: Q = 100 on one 4,096-row
    shard, m = 32, K = 256, k = 160, under phase 6's masks (phase6_masks),
    each timed as its phase-2 row is."""
    Q, n, D = q.shape[0], x.shape[0], q.shape[1]
    M, KC = luts.shape[1], luts.shape[2]
    k = 160
    lg = codes.T.long()[None].expand(Q, M, n)
    satol = 1e-5 * float(luts.amax(2).sum(1).max())
    atol = max(1e-5 * _scale(q, x), satol)
    allq = torch.ones(Q, dtype=torch.bool, device=q.device)
    masks = phase6_masks(torch, price, Q)

    def lib_adc(plane):
        d = torch.gather(luts, 2, lg).sum(1).masked_fill_(~plane, float("inf"))
        return torch.topk(d, k, dim=1, largest=False)

    rows = {}
    for name, (uniq, idx, flavor) in masks.items():
        plane = uniq[idx]
        if name == "masked_pq_topk":
            fn = (lambda b, m=uniq[0]: ops.masked_pq_topk(luts, codes, m, k, backend=b))
            bound, lib, kernel, what = (_masked_bound(1, plane, D, M, KC, k, allq), lambda p=plane: lib_adc(p),
                                        None, f"price < {PROD_PQ_BAND}")
        elif name == "masked_pq_topk_multi":
            fn = (lambda b, u=uniq, i=idx: ops.masked_pq_topk_dedup(luts, codes, u, i, k, backend=b))
            bound, lib, kernel, what = (_masked_bound(uniq.shape[0], plane, D, M, KC, k, allq),
                                        lambda p=plane: lib_adc(p), None,
                                        f"plane of price < {PROD_PQ_PLANE[0]}..{PROD_PQ_PLANE[-1]}")
        else:
            fn = (lambda b, u=uniq, i=idx, f=flavor: ops.unified_masked_topk_dedup(
                q, x, luts, codes, u, i, f, k, backend=b))
            bound = _masked_bound(uniq.shape[0], plane, D, M, KC, k, flavor)
            lib, kernel = None, _unified_launch(torch, q, x, luts, codes, uniq, idx, flavor, k)
            what = (f"{Q // 2} exact under price < {PROD_UNIFIED_EXACT_BAND}, {Q - Q // 2} ADC under "
                    f"the plane of price < {PROD_PQ_PLANE[0]}..{PROD_PQ_PLANE[-1]}")
        shape = f"Q={Q} N={n} m={M} K={KC} k={k} {what} (phase 6)"
        rows[name] = _masked_row(torch, name, fn, lib, bound, atol if flavor is not None else satol, shape,
                                 kernel=kernel)
        log(f"{name} [{shape}]: {_times_line(rows[name])}, max abs err {rows[name]['max_abs_err']:.3g}")
    return rows


def _masked_row(torch, name, fn, lib, bound, tol, shape, kernel=None, plain=None) -> dict:
    """One timed masked row: ``fn(backend)`` checked against its plain
    version (the error reported is this call's), host-inclusive and
    graph-replay times of the kernel and the plain version (``kernel`` and
    ``plain``, default ``fn("auto")`` and ``fn("ref")``, each checked to
    give the wrapper's bits) and of the library call ``lib`` (or None), the
    pass-1 / pass-2 split, and ``bound``."""
    err = _check_topk(torch, fn("auto"), fn("ref"), tol, f"timed {name} [{shape}]")
    kernel = kernel or (lambda: fn("auto"))
    plain = plain or (lambda: fn("ref"))
    _same_call(torch, kernel(), fn("auto"), name)
    _same_call(torch, plain(), fn("ref"), f"{name} (plain)")
    split = pass_split_ms(torch, kernel)
    return dict(max_abs_err=err, ms=time_ms(torch, lambda: fn("auto")),
                plain_ms=time_ms(torch, lambda: fn("ref"), reps=5, warmup=1),
                library_ms=time_ms(torch, lib, reps=5, warmup=1) if lib is not None else None,
                **_device_times(torch, kernel, plain, lib),
                pass_ms=list(split), bound_ms=bound[0], bound_by=bound[1], shape=shape)


def _device_times(torch, kernel, plain, lib) -> dict:
    """device_ms, plain_device_ms and library_device_ms (None without a
    library call) of a masked or quantized row, by CUDA-graph replay;
    millisecond calls, so fewer of them a replay than rows 1-3."""
    return dict(device_ms=device_ms(torch, kernel, inner=5, reps=10),
                plain_device_ms=device_ms(torch, plain, inner=2, reps=5),
                library_device_ms=None if lib is None else device_ms(torch, lib, inner=2, reps=5))


def _times_line(r) -> str:
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    lib_dev = "none" if r["library_device_ms"] is None else f"{r['library_device_ms']:.4f} ms"
    split = f" ({_split_text(r['pass_ms'])})" if "pass_ms" in r else ""
    return (f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib} (with the host's "
            f"dispatch); on the device (graph replay) kernel {r['device_ms']:.4f} ms{split}, plain "
            f"{r['plain_device_ms']:.4f} ms, library {lib_dev}; bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")


def _same_call(torch, got, want, name) -> None:
    """The call timed on the device gives the wrapper's outputs bit for bit."""
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name}: the call timed on the device differs from the wrapper's")


def _unified_launch(torch, q, x, luts, codes, uniq, idx, flavor, k):
    """The launch ``ops.unified_masked_topk_dedup`` makes, with the flavor
    order and the exact-query count (which the wrapper reads from the card)
    worked out here once, at the tile the autotuner gives the call."""
    from repro_torch.kernels import masked_topk as km
    from repro_torch.kernels import ops

    masks = (uniq != 0).to(torch.uint8).contiguous()
    rows = idx.to(torch.int32).contiguous()
    qperm = torch.sort(flavor.to(torch.int32), stable=True).indices.to(torch.int32).contiguous()
    n_exact = q.shape[0] - int(flavor.sum())
    tile_q = ops._tiles(None, None, x.shape[0], x.shape[1], "unified")
    return lambda: km._launch(
        "unified_masked_topk", q.shape[0], x.shape[0], k, device=q.device, queries=q, points=x,
        luts=luts, codes=codes, mask_rows=masks, row_index=rows, qperm=qperm, n_exact=n_exact,
        tile_q=tile_q)


def _quant_checks(torch, ops, q, x, plane, k, what, metrics=("l2", "ip")):
    """Every quantized scan, kernel against plain, on one input: the row
    mask, the dedup'd plane and the dense plane, on the stored matrix; and
    f32 points quantized in the call equal the stored ones bit for bit.
    Returns max errors by launch name."""
    from repro_torch.kernels import ref

    errs = {}
    n_q = q.shape[0]
    uniq = plane[: max(1, n_q // 2)]
    idx = torch.as_tensor(np.arange(n_q) % uniq.shape[0]).to(q.device)
    # bf16 sums run in another order than the plain dot, int8 crosses are
    # exact and scaled once: both within 1e-5 of |q|^2 + |x|^2 (+1 for x = 0)
    atol = 1e-5 * (_scale(q, x) + 1.0)
    for dtype in QUANT:
        stored, x_scale = ref.quantize_points(x, dtype)
        if not bool(x.any()) and x_scale != 1.0:
            raise AssertionError(f"{what}: all-zero points quantize with scale {x_scale}, not 1.0")
        for metric in metrics:
            for name, fn, args in (
                (f"masked_exact_topk_{dtype}", ops.masked_exact_topk, (q, stored, plane[0], k)),
                (f"masked_exact_topk_multi_{dtype}", ops.masked_exact_topk_multi, (q, stored, plane, k)),
                (f"masked_exact_topk_multi_{dtype}", ops.masked_exact_topk_dedup,
                 (q, stored, uniq, idx, k)),
            ):
                kw = dict(metric=metric, dtype=dtype, x_scale=x_scale)
                e = _check_topk(torch, fn(*args, **kw), fn(*args, **kw, backend="ref"), atol,
                                f"{what} {name} {metric}")
                errs[name] = max(errs.get(name, 0.0), e)
            a = ops.masked_exact_topk_dedup(q, x, uniq, idx, k, metric=metric, dtype=dtype)
            b = ops.masked_exact_topk_dedup(q, stored, uniq, idx, k, metric=metric, dtype=dtype,
                                            x_scale=x_scale)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"{what}: {dtype} {metric} fresh quantization differs from stored")
    return errs


def _pq_scan_check(torch, ops, luts, codes, what):
    """pq_scan against its plain version, bit for bit; returns max |diff|."""
    got = ops.pq_scan(luts, codes)
    want = ops.pq_scan(luts, codes, backend="ref")
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: pq_scan differs from its plain version")
    return float((got - want).abs().max()) if got.numel() else 0.0


def phase_quant_kernels(torch, dev, shard_n: int, seed: int):
    """The bf16 / int8 masked scans and the dense ``pq_scan`` against their
    plain versions at the main path's shapes (Q = 100, D = 128, the
    quantized pool k = quant_guard_pool(40) = 160; ``pq_scan`` at m = 32,
    K = 256) on one 250k-row shard and on N = 4,096, and at their edge
    cases; times beside bounds and yardsticks."""
    from repro_torch.kernels import ops, ref
    from repro_torch.runtime import planner

    rng = np.random.default_rng(seed + 3)
    errs: dict = {}

    def merge(e):
        for key, v in e.items():
            errs[key] = max(errs.get(key, 0.0), v)

    edge = [
        ("all masked", dict(q=4, n=600, d=16, frac=0.0), 10),
        ("k > N", dict(q=3, n=7, d=8, frac=1.0), 12),
        ("k > passing", dict(q=4, n=700, d=16, frac=0.005), 10),
        ("ties", dict(q=4, n=400, d=8, frac=0.8, ints=True), 12),
        ("ragged Q/N/D", dict(q=3, n=1301, d=33, frac=0.6), 9),
        ("Q = 1", dict(q=1, n=1000, d=128, frac=0.5), 40),
        ("plane, repeated rows", dict(q=37, n=5000, d=64, frac=0.3), 40),
    ]
    for what, kw, k in edge:
        q, x, _l, _c, plane = _masked_case(torch, dev, rng, m=8, kc=16, **kw)
        merge(_quant_checks(torch, ops, q, x, plane, k, what))
    q, x, _l, _c, plane = _masked_case(torch, dev, rng, 5, 300, 16, 0.7, m=8, kc=16)
    merge(_quant_checks(torch, ops, q, torch.zeros_like(x), plane, 10, "all-zero points"))
    for qn, n, m, kc in [(5, 700, 8, 256), (1, 1, 4, 16), (9, 2049, 3, 7), (3, 4097, 32, 256)]:
        _pq_scan_check(torch, ops, torch.rand((qn, m, kc), device=dev),
                       torch.as_tensor(rng.integers(0, kc, size=(n, m)).astype(np.uint8)).to(dev),
                       f"pq_scan edge Q={qn} N={n} m={m} K={kc}")
    log(f"quantized scans and pq_scan: {len(edge) + 5} edge cases match their plain versions")

    Q, D, M, KC = 100, 128, 32, 256
    k = planner.quant_guard_pool(40)
    thresholds = (2, 3, 4, 5, 6, 100, 325, 550, 775, 1000)
    for n in (SMALL_SHARD, shard_n):
        q, x, luts, codes, _ = _masked_case(torch, dev, rng, Q, n, D, 0.0, m=M, kc=KC)
        price = torch.as_tensor(rng.integers(0, PRICE_MAX, size=n)).to(dev)
        uniq = torch.stack([price < t for t in thresholds])
        idx = torch.as_tensor(np.arange(Q) % uniq.shape[0]).to(dev)
        merge(_quant_checks(torch, ops, q, x, uniq[idx], k, f"main shape N={n}", metrics=("l2",)))
        pq_err = _pq_scan_check(torch, ops, luts, codes, f"pq_scan main shape N={n}")
        if n == SMALL_SHARD:
            small = (q, x, price)
    # the last (one-shard) inputs are timed; pq_err is their pq_scan check's
    wide = price < 5000
    none = torch.zeros(Q, dtype=torch.bool, device=dev)
    rows = {}
    for dtype, peak in QUANT.items():
        stored, x_scale = ref.quantize_points(x, dtype)
        qs, q_scale = ref.quantize_points(q, dtype)
        elem = 2 if dtype == "bf16" else 1

        def lib(mask, stored=stored, qs=qs, dtype=dtype, x_scale=x_scale, q_scale=q_scale):
            if dtype == "int8":
                cross = torch._int_mm(qs, stored.T).float() * (q_scale * x_scale)
                xf, qf = stored.float() * x_scale, qs.float() * q_scale
            else:
                cross = torch.mm(qs, stored.T).float()
                xf, qf = stored.float(), qs.float()
            d = (qf * qf).sum(1, keepdim=True) - 2 * cross + (xf * xf).sum(1)[None, :]
            return torch.topk(d.masked_fill_(~mask, float("inf")), k, dim=1, largest=False)

        cases = {
            f"masked_exact_topk_{dtype}": (
                lambda b, s=stored, xs=x_scale, dt=dtype: ops.masked_exact_topk(
                    q, s, wide, k, backend=b, dtype=dt, x_scale=xs),
                lambda lib=lib: lib(wide), 1, wide[None, :].expand(Q, -1),
                f"Q=100 N={shard_n} D=128 k={k} mask 50%"),
            f"masked_exact_topk_multi_{dtype}": (
                lambda b, s=stored, xs=x_scale, dt=dtype: ops.masked_exact_topk_dedup(
                    q, s, uniq, idx, k, backend=b, dtype=dt, x_scale=xs),
                lambda lib=lib: lib(uniq[idx]), uniq.shape[0], uniq[idx],
                f"Q=100 N={shard_n} D=128 k={k} plane of 10 price masks"),
        }
        _k_sweep(torch, f"masked_exact_topk_{dtype}",
                 lambda m, kk, s=stored, xs=x_scale, dt=dtype: ops.masked_exact_topk(
                     q, s, m, kk, dtype=dt, x_scale=xs),
                 wide, f"Q=100 N={shard_n} D=128 mask 50%")
        atol = 1e-5 * _scale(q, x)
        captured = {}
        if dtype == "int8":
            # the int8 wrappers quantize the queries in the call, reading the
            # scale back from the card (a host sync a CUDA graph cannot
            # capture): the device times take them quantized once, the
            # kernel through its wrapper, the plain version as its oracle
            # computes after quantizing (the same calls, bit for bit)
            from repro_torch.kernels import masked_topk as km

            sc = (q_scale, x_scale)
            wide_u8 = wide.to(torch.uint8).reshape(1, -1).contiguous()
            uniq_u8, idx32 = uniq.to(torch.uint8).contiguous(), idx.to(torch.int32).contiguous()

            def deq(stored=stored, qs=qs, sc=sc):
                return ref.dequantize_points(qs, sc[0]), ref.dequantize_points(stored, sc[1])

            captured = {
                "masked_exact_topk_int8": (
                    lambda s=stored, qs=qs, sc=sc: km.masked_exact_topk(qs, s, wide_u8, None, k, scales=sc),
                    lambda deq=deq: ref.masked_exact_topk(*deq(), wide, k)),
                "masked_exact_topk_multi_int8": (
                    lambda s=stored, qs=qs, sc=sc: km.masked_exact_topk(qs, s, uniq_u8, idx32, k, scales=sc),
                    lambda deq=deq: ref.masked_exact_topk_multi(*deq(), uniq[idx], k)),
            }
        for name, (fn, yard, q_rows, plane, shape) in cases.items():
            kernel, plain_fn = captured.get(name, (None, None))
            rows[name] = _masked_row(
                torch, name, fn, yard, _masked_bound(q_rows, plane, D, M, KC, k, none, elem=elem, peak=peak),
                atol, shape, kernel=kernel, plain=plain_fn)

    # row 5' where the main path runs it: phase 7's ExactScan of a 4,096-row
    # shard, 100 queries under price < 900, the quantized pool k = 160
    sq, sx, sprice = small
    band = sprice < PROD_BF16_BAND
    sstored, _ = ref.quantize_points(sx, "bf16")
    sqs, _ = ref.quantize_points(sq, "bf16")

    def small_lib():
        d = ((sqs.float() ** 2).sum(1, keepdim=True) - 2 * torch.mm(sqs, sstored.T).float()
             + (sstored.float() ** 2).sum(1)[None, :])
        return torch.topk(d.masked_fill_(~band, float("inf")), k, dim=1, largest=False)

    rows["masked_exact_topk_bf16"]["at_shapes"] = [_masked_row(
        torch, "masked_exact_topk_bf16",
        lambda b: ops.masked_exact_topk(sq, sstored, band, k, backend=b, dtype="bf16", x_scale=1.0),
        small_lib, _masked_bound(1, band[None, :].expand(Q, -1), D, M, KC, k, none, elem=2, peak=PEAK_BF16),
        1e-5 * _scale(sq, sx), f"Q=100 N={SMALL_SHARD} D=128 k={k} price < {PROD_BF16_BAND}")]
    # rows 4 and 6 where phase 7 runs them: the same shard under price < 900,
    # and its batches' ten bands (query i under band i % 10)
    for name, row in _phase7_int8_rows(torch, ops, ref, sq, sx, sprice, k).items():
        rows[name]["at_shapes"] = [row]

    lg = codes.T.long()[None].expand(Q, M, shard_n)

    def kernel():
        return ops.pq_scan(luts, codes)

    def plain():
        return ops.pq_scan(luts, codes, backend="ref")

    def yard():
        return torch.gather(luts, 2, lg).sum(1)

    b, by = bound_ms(Q * shard_n * M, 4 * Q * shard_n + M * shard_n + 4 * Q * M * KC)
    rows["pq_scan"] = dict(
        max_abs_err=pq_err, ms=time_ms(torch, kernel), plain_ms=time_ms(torch, plain, reps=5, warmup=1),
        library_ms=time_ms(torch, yard, reps=5, warmup=1), device_ms=device_ms(torch, kernel),
        plain_device_ms=device_ms(torch, plain, inner=2, reps=5),
        library_device_ms=device_ms(torch, yard, inner=2, reps=5),
        bound_ms=b, bound_by=by, shape=f"Q=100 N={shard_n} m=32 K=256, (Q, N) out")
    del lg
    for name, r in rows.items():
        log(f"{name} [{r['shape']}]: {_times_line(r)}, max abs err {r['max_abs_err']:.3g} (over every "
            f"check of phase 2: {errs.get(name, 0.0):.3g})")
        for a in r.get("at_shapes", []):
            log(f"{name} [{a['shape']}]: {_times_line(a)}, max abs err {a['max_abs_err']:.3g}")
    return rows


def _phase7_int8_rows(torch, ops, ref, q, x, price, k) -> dict:
    """Rows 4 and 6 where phase 7 runs them: Q = 100 on one 4,096-row
    shard, k = 160, under price < 900 (row 4) and under the ten bands of
    phase 7's batches (row 6), each timed as its phase-2 row is (device
    times on queries quantized once)."""
    from repro_torch.kernels import masked_topk as km

    Q, D = q.shape
    dev = q.device
    stored, x_scale = ref.quantize_points(x, "int8")
    qs, q_scale = ref.quantize_points(q, "int8")
    sc = (q_scale, x_scale)
    band = price < PROD_BF16_BAND
    uniq = torch.stack([price < t for t in PROD_QUANT_BANDS])
    idx = torch.as_tensor(np.arange(Q) % len(PROD_QUANT_BANDS)).to(dev)
    band_u8 = band.to(torch.uint8).reshape(1, -1).contiguous()
    uniq_u8, idx32 = uniq.to(torch.uint8).contiguous(), idx.to(torch.int32).contiguous()
    none = torch.zeros(Q, dtype=torch.bool, device=dev)
    atol = 1e-5 * _scale(q, x)
    xf, qf = stored.float() * x_scale, qs.float() * q_scale

    def lib(mask):
        cross = torch._int_mm(qs, stored.T).float() * (q_scale * x_scale)
        d = (qf * qf).sum(1, keepdim=True) - 2 * cross + (xf * xf).sum(1)[None, :]
        return torch.topk(d.masked_fill_(~mask, float("inf")), k, dim=1, largest=False)

    def deq():
        return ref.dequantize_points(qs, q_scale), ref.dequantize_points(stored, x_scale)

    cases = {
        "masked_exact_topk_int8": (
            lambda b: ops.masked_exact_topk(q, stored, band, k, backend=b, dtype="int8", x_scale=x_scale),
            lambda: lib(band), 1, band[None, :].expand(Q, -1),
            lambda: km.masked_exact_topk(qs, stored, band_u8, None, k, scales=sc),
            lambda: ref.masked_exact_topk(*deq(), band, k), f"price < {PROD_BF16_BAND}"),
        "masked_exact_topk_multi_int8": (
            lambda b: ops.masked_exact_topk_dedup(q, stored, uniq, idx, k, backend=b, dtype="int8",
                                                  x_scale=x_scale),
            lambda: lib(uniq[idx]), uniq.shape[0], uniq[idx],
            lambda: km.masked_exact_topk(qs, stored, uniq_u8, idx32, k, scales=sc),
            lambda: ref.masked_exact_topk_multi(*deq(), uniq[idx], k),
            f"plane of price < {PROD_QUANT_BANDS[0]}..{PROD_QUANT_BANDS[-1]}"),
    }
    rows = {}
    for name, (fn, yard, q_rows, plane, kernel, plain, what) in cases.items():
        rows[name] = _masked_row(
            torch, name, fn, yard, _masked_bound(q_rows, plane, D, 0, 0, k, none, elem=1, peak=PEAK_INT8),
            atol, f"Q={Q} N={x.shape[0]} D={D} k={k} {what} (phase 7)", kernel=kernel, plain=plain)
    return rows


# -- --parent: the kernels of another checkout beside this one's ---------------

# every launch name of csrc/masked_topk.cu
# the (phase, flavor, shard rows) the main path's masked calls take at D = 128
# (phase 6's PQ codes m = 32 land in the same D bucket): phase 4's ExactScan
# on phase 3's 250k-row shards, phase 6's and 7's on 4,096-row shards
MAIN_PATH_TILES = (("4", "exact", 250_000), ("6", "exact", SMALL_SHARD), ("6", "pq", SMALL_SHARD),
                   ("6", "unified", SMALL_SHARD), ("7", "exact_bf16", SMALL_SHARD),
                   ("7", "exact_int8", SMALL_SHARD))


def _tile_calls(torch, ops, flavor, q, x, luts, codes, plane, k):
    """The masked ops of ``flavor`` on one input set, as fn(tile_q): the
    shared-mask and the dedup'd-plane forms (unified: the plane)."""
    uniq, idx = plane
    mask = uniq[0]
    if flavor.startswith("exact"):
        dt = {"exact": "f32", "exact_bf16": "bf16", "exact_int8": "int8"}[flavor]
        return [lambda t: ops.masked_exact_topk(q, x, mask, k, dtype=dt, tile_q=t),
                lambda t: ops.masked_exact_topk_dedup(q, x, uniq, idx, k, dtype=dt, tile_q=t)]
    if flavor == "pq":
        return [lambda t: ops.masked_pq_topk(luts, codes, mask, k, tile_q=t),
                lambda t: ops.masked_pq_topk_dedup(luts, codes, uniq, idx, k, tile_q=t)]
    fl = torch.arange(q.shape[0], device=q.device) % 2 == 1
    return [lambda t: ops.unified_masked_topk_dedup(q, x, luts, codes, uniq, idx, fl, k, tile_q=t)]


def phase_autotune(torch, dev, shard_n: int, seed: int):
    """2b: the autotuner's knob.  ``autotune.sweep`` at one small point
    (2,048 rows, D = 128) for every flavor into a temporary file (its
    ``sweep_point`` holds each candidate's bits against the default's);
    then every candidate tile of every masked flavor against the default
    tile, bit for bit (dists as int32 views, ids), at phase 2's masked
    shapes (Q = 100, D = 128, one 250k-row shard and N = 4,096; the 50 %
    mask and the dedup'd plane of ten price masks; k = 40 and 160); last,
    the tile the committed cache picks at each main-path shape
    (MAIN_PATH_TILES) with its device ms beside the default's (CUDA-graph
    replay, 100 queries)."""
    from repro_torch.kernels import autotune, ops

    with tempfile.TemporaryDirectory() as tmp:
        picked = autotune.sweep(out_path=Path(tmp) / "autotune_cache.json", row_counts=(2048,),
                                dims=(128,), repeat=2)
    log(f"2b sweep at 2,048 rows, D = 128 (each candidate's bits held to the default's): {picked}")
    rng = np.random.default_rng(seed + 7)
    Q, D, M, KC = 100, 128, 32, 256
    checked = 0
    for n in (SMALL_SHARD, shard_n):
        q, x, luts, codes, _ = _masked_case(torch, dev, rng, Q, n, D, 0.0, m=M, kc=KC)
        price = torch.as_tensor(rng.integers(0, PRICE_MAX, size=n)).to(dev)
        uniq = torch.stack([price < 5000] + [price < t for t in (2, 3, 4, 5, 6, 100, 325, 550, 1000)])
        plane = (uniq, torch.as_tensor(np.arange(Q) % uniq.shape[0]).to(dev))
        for k in (40, 160):
            for flavor in autotune.FLAVORS[:-1]:  # gather_rerank has no knob
                for fn in _tile_calls(torch, ops, flavor, q, x, luts, codes, plane, k):
                    base = fn(0)
                    for tq, _tn in autotune.FLAVOR_CANDIDATES[flavor][1:]:
                        got = fn(tq)
                        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                                   for a, b in zip(got, base)):
                            raise AssertionError(f"2b: {flavor} at tile_q={tq} changes the answer "
                                                 f"(N = {n}, k = {k})")
                        checked += 1
    torch.cuda.synchronize()
    log(f"2b every candidate tile of every masked flavor gives the default's bits: {checked} calls "
        f"at Q = {Q}, N = {SMALL_SHARD} and {shard_n}, k = 40 and 160")
    autotune.clear_cache()
    lines = []
    for phase, flavor, n in MAIN_PATH_TILES:
        tiles = autotune.get_tiles(n, M if flavor == "pq" else D, flavor)
        work = autotune._workload(flavor, n, D, seed=seed, device=dev, q_n=Q, m_sub=M)
        base = autotune._time_ms(lambda: autotune._dispatch(flavor, work, *autotune.DEFAULT_TILES))
        t = base if tiles == autotune.DEFAULT_TILES else autotune._time_ms(
            lambda: autotune._dispatch(flavor, work, *tiles))
        lines.append(f"phase {phase} {flavor} N={n}: {tiles} {t:.4f} ms (default {base:.4f} ms)")
    log("2b the committed cache's tiles at the main path's shapes, device ms by graph replay, "
        "Q = 100, k = 32, PQ m = 32: " + "; ".join(lines))


MASKED_NAMES = tuple(n for n, (src, _) in KERNELS.items() if src == MASKED_CU)
# the sources --parent builds from the other checkout
PARENT_SOURCES = ("masked_topk", "kmeans_assign", "rerank", "pq_scan")


class _NoTileKnob:
    """A parent's ``masked_topk.cu`` from before the query-tile knob: its
    ``masked_topk`` takes no ``tile_q``, so a call drops it and the parent
    launches by its own rule (what ``tile_q = 0`` asks of this checkout's;
    a tile never changes a bit)."""

    def __init__(self, lib):
        import ctypes

        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.masked_topk.argtypes = [vp] * 7 + [ci] * 9 + [cf] * 2 + [vp] * 4 + [vp]
        lib.masked_topk.restype = ci
        lib.masked_topk_chunk_rows.argtypes = []
        lib.masked_topk_chunk_rows.restype = ci
        lib.masked_topk_adc_tile.argtypes = [ci, ci]
        lib.masked_topk_adc_tile.restype = ci
        self._lib, self._typed = lib, True

    def masked_topk(self, *args):
        return self._lib.masked_topk(*args[:16], *args[17:])  # args[16] is tile_q

    def __getattr__(self, name):
        return getattr(self._lib, name)


def _parent_libs(parent: str) -> dict:
    """``csrc/<name>.cu`` of the checkout ``parent`` for each of
    PARENT_SOURCES, built with the package's own nvcc flags (one nvcc a
    source, all started together) into ``build/`` and loaded beside this
    checkout's libraries, each under its own name."""
    import ctypes

    from repro_torch.kernels import _build

    out_dir = _build.BUILD_DIR / "parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in PARENT_SOURCES:
        src = Path(parent).resolve() / f"src/repro_torch/kernels/csrc/{name}.cu"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu:\n{log_text}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        if name == "masked_topk" and "int kind, int tile_q" not in src.read_text():
            lib = _NoTileKnob(lib)
        if name == "rerank" and not hasattr(lib, "rerank_tile"):
            # a rerank.cu from before the two tiles: its launches are
            # labelled by this checkout's tile rule
            lib.rerank_tile = _build.load("rerank").rerank_tile
        libs[name] = lib
    return libs


def _launching(name: str, lib) -> None:
    """Make the wrappers of ``csrc/<name>.cu`` launch from ``lib``."""
    from repro_torch.kernels import _build

    with _build._lock:
        _build._libs[name] = lib


def _turns(torch, name: str, old, new, fn, timer=None):
    """(parent ms, change ms) of ``fn``, each the mean of two medians timed
    by ``timer`` (default ``time_ms``) in turns (parent, change, change,
    parent) with ``csrc/<name>.cu`` from ``old`` and ``new``."""
    timer = timer or time_ms
    t = []
    for lib in (old, new, new, old):
        _launching(name, lib)
        t.append(timer(torch, fn))
    _launching(name, new)
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def _same_bits(torch, name: str, old, new, calls, what: str) -> dict:
    """Run ``calls`` (label, fn) with ``csrc/<name>.cu`` from ``old`` and
    then ``new``; every output pair must have equal bits (f32 outputs
    compared as int32 views), and the calls must launch at least once
    each.  Returns the launch counts by name."""
    from repro_torch.kernels import _build

    outs = {}
    for lib, who in ((old, "parent"), (new, "change")):
        _launching(name, lib)
        _build.reset_launch_counts()
        outs[who] = [fn() for _label, fn in calls]
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        launched = sum(counts.values())
        if launched < len(calls):
            raise AssertionError(f"--parent {what}: the {who} build launched {launched} of {len(calls)}")
    _launching(name, new)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    bad = [label for (label, _), a, b in zip(calls, outs["parent"], outs["change"])
           if not all(torch.equal(bits(u), bits(v)) for u, v in zip(a, b))]
    if bad:
        raise AssertionError(f"--parent {what}: outputs differ from the parent's: {bad}")
    log(f"parent vs change {what}: {len(calls)} calls over {len(counts)} launch names give equal bits "
        f"(f32 as int32 views) and ids")
    return counts


def _same_tolerance(torch, name: str, old, new, calls, atol, what: str) -> dict:
    """Run ``calls`` (label, fn(backend)) with ``csrc/<name>.cu`` from
    ``old`` and then ``new``; each build's outputs must agree with the plain
    version (``_check_topk``: distances within ``atol``, the same
    sentinels, ids equal outside ties), for a change whose scores round
    apart from its parent's.  Returns the launch counts by name."""
    from repro_torch.kernels import _build

    err = {}
    for lib, who in ((old, "parent"), (new, "change")):
        _launching(name, lib)
        _build.reset_launch_counts()
        got = [fn("auto") for _label, fn in calls]
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        if sum(counts.values()) < len(calls):
            raise AssertionError(f"--parent {what}: the {who} build launched {sum(counts.values())} of "
                                 f"{len(calls)}")
        err[who] = max((_check_topk(torch, g, fn("ref"), atol, f"--parent {what} {who} {label}")
                        for g, (label, fn) in zip(got, calls)), default=0.0)
    _launching(name, new)
    log(f"parent vs change {what}: {len(calls)} calls over {len(counts)} launch names within the plain "
        f"version's tolerance (atol {atol:.3g}): max abs err parent {err['parent']:.3g}, change "
        f"{err['change']:.3g}")
    return counts


def _parent_rerank_kmeans(torch, dev, shard_n: int, seed: int, libs: dict, old: dict) -> None:
    """gather_rerank (csrc/rerank.cu) and kmeans_assign
    (csrc/kmeans_assign.cu) of the parent against this checkout's: equal
    bits on seeded inputs, then the phase-2 timed shapes in turns."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed + 5)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(dev)

    # ---- gather_rerank: pools as search_pq's (sorted, some sentinels,
    # duplicates and ids >= N) at P = 1, 160, 238, 298, 600, k = 1, 40,
    # 160, P + 5
    calls = []
    data = {}
    for n in (SMALL_SHARD, shard_n):
        pts = t(rng.normal(size=(n, 128)))
        for p in (1, 160, 238, 298, 600):
            q = t(rng.normal(size=(64, 128)))
            pids = _pool_ids(torch, rng, 64, n, p, dev)
            data[(n, p)] = (q, pts, pids)
            for k in (1, 40, 160, p + 5):
                for metric in ("l2", "ip"):
                    calls.append((f"N={n} P={p} k={k} {metric}", lambda q=q, x=pts, i=pids, k=k, m=metric:
                                  ops.gather_rerank(q, x, i, k, metric=m)))
    small, sq = t(rng.normal(size=(50, 16))), t(rng.normal(size=(4, 16)))
    sent = torch.full((4, 8), -1, dtype=torch.int32, device=dev)
    sent[0, :3] = torch.tensor([5, 7, 50])
    sent[1, 0] = 999
    dup = _pool_ids(torch, rng, 4, 50, 12, dev, dup_frac=0.5)
    odd_q, odd_x = t(rng.normal(size=(5, 33))), t(rng.normal(size=(70, 33)))
    odd_p = _pool_ids(torch, rng, 5, 70, 19, dev)
    for metric in ("l2", "ip"):
        calls += [
            (f"sentinels {metric}", lambda m=metric: ops.gather_rerank(sq, small, sent, 8, metric=m)),
            (f"k > P {metric}", lambda m=metric: ops.gather_rerank(sq, small, sent[:, :3].contiguous(), 10, metric=m)),
            (f"k > N {metric}", lambda m=metric: ops.gather_rerank(sq, small[:4].contiguous(), sent.clamp(max=5), 9, metric=m)),
            (f"duplicates {metric}", lambda m=metric: ops.gather_rerank(sq, small, dup, 5, metric=m)),
            (f"D=33 {metric}", lambda m=metric: ops.gather_rerank(odd_q, odd_x, odd_p, 7, metric=m)),
        ]
    _same_bits(torch, "rerank", old["rerank"], libs["rerank"], calls, "gather_rerank")

    # ---- kmeans_assign: the PQ shape, small D at ragged K, and D >= 64
    kcalls = []
    shapes = [(8192, 256, 4)] + [(4097, k, d) for d in (1, 4, 33) for k in (1, 5, 256, 300)]
    shapes += [(shard_n, 16, 128), (8192, 128, 128), (4097, 17, 128), (1000, 300, 128), (777, 5, 70),
               (3000, 16, 130), (2000, 16, 400)]
    kdata = {}
    for n, k, d in shapes:
        x, c = t(rng.normal(size=(n, d))), t(rng.normal(size=(k, d)))
        kdata[(n, k, d)] = (x, c)
        kcalls.append((f"N={n} K={k} D={d}", lambda x=x, c=c: ops.kmeans_assign(x, c)))
    _same_bits(torch, "kmeans_assign", old["kmeans_assign"], libs["kmeans_assign"], kcalls,
               "kmeans_assign")

    # ---- the phase-2 timed shapes, in turns
    q, pts, pids = data[(shard_n, 238)]
    timed = [("gather_rerank", "rerank", f"Q=64 P=238 D=128 k={k} N={shard_n}",
              lambda k=k: ops.gather_rerank(q, pts, pids, k)) for k in SWEEP_K]
    gq, gpts = t(rng.normal(size=(100, 128))), t(rng.normal(size=(SMALL_SHARD, 128)))
    gpids = _pool_ids(torch, rng, 100, SMALL_SHARD, 160, dev)
    timed.append(("gather_rerank", "rerank", f"Q=100 P=160 D=128 k=40 N={SMALL_SHARD} (guard)",
                  lambda: ops.gather_rerank(gq, gpts, gpids, 40)))
    for shape in ((shard_n, 16, 128), (8192, 256, 4), (8192, 128, 128)):
        x, c = kdata[shape]
        timed.append(("kmeans_assign", "kmeans_assign", f"N={shape[0]} K={shape[1]} D={shape[2]}",
                      lambda x=x, c=c: ops.kmeans_assign(x, c)))
    for name, src, shape, fn in timed:
        a, b = _turns(torch, src, old[src], libs[src], fn, timer=device_ms)
        ha, hb = _turns(torch, src, old[src], libs[src], fn)
        log(f"parent vs change {name} [{shape}]: parent {a:.4f} ms, change {b:.4f} ms, "
            f"change/parent {b / a:.3f} (device); with the host's dispatch {ha:.4f} / {hb:.4f} ms")


# rerank_distances shapes held against the parent: Stage B and the tiles'
# ragged edges (small tile), and ragged Q / N / D, D > 256 and one query
# against many rows (large tile); (Q, N, D)
PARENT_RERANK = [(100, 4000, 128), (1, 1, 1), (1, 1, 128), (7, 1000, 33), (33, 130, 70),
                 (65, 257, 130), (1, 129, 33), (300, 20000, 33), (33, 5000, 300),
                 (257, 40001, 70), (600, 20000, 33), (300, 70000, 130), (1, 300000, 1),
                 (2200, 4000, 128)]
# pq_scan shapes held against the parent: (Q, N, m, K)
PARENT_PQ = [(5, 700, 8, 256), (1, 1, 4, 16), (9, 2049, 3, 7), (3, 4097, 32, 256),
             (7, 5000, 16, 256), (7, 5000, 64, 256), (100, 1023, 32, 256), (100, 1025, 32, 256),
             (100, 2047, 32, 256), (100, 2049, 32, 256)]


def _parent_rerank_pq(torch, dev, shard_n: int, seed: int, libs: dict, old: dict) -> None:
    """rerank_distances (csrc/rerank.cu) and pq_scan (csrc/pq_scan.cu) of
    the parent against this checkout's: equal bits on seeded inputs (the
    main path's shapes, both metrics, and the edges), then Stage B, the
    ground-truth chunk and the phase-2 pq_scan call timed in turns."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed + 6)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32)).to(dev)

    def codes_of(n, m, kc):
        return torch.as_tensor(rng.integers(0, kc, size=(n, m)).astype(np.uint8)).to(dev)

    data = {}
    calls = []
    for shape in PARENT_RERANK + [(1000, shard_n * 4, 128)]:
        nq, n, d = shape
        q, x = t(rng.normal(size=(nq, d))), t(rng.normal(size=(n, d)))
        data[shape] = (q, x)
        for metric in ("l2", "ip"):
            calls.append((f"Q={nq} N={n} D={d} {metric}",
                          lambda q=q, x=x, m=metric: (ops.exact_distances(q, x, metric=m),)))
    _same_bits(torch, "rerank", old["rerank"], libs["rerank"], calls, "rerank_distances")
    del calls

    pcalls = []
    for nq, n, m, kc in PARENT_PQ + [(100, shard_n, 32, 256)]:
        luts, codes = torch.rand((nq, m, kc), device=dev), codes_of(n, m, kc)
        data[(nq, n, m, kc)] = (luts, codes)
        pcalls.append((f"Q={nq} N={n} m={m} K={kc}", lambda lt=luts, c=codes: (ops.pq_scan(lt, c),)))
    _same_bits(torch, "pq_scan", old["pq_scan"], libs["pq_scan"], pcalls, "pq_scan")

    sq, sx = data[(100, 4000, 128)]
    gq, gx = data[(1000, shard_n * 4, 128)]
    luts, codes = data[(100, shard_n, 32, 256)]
    # (name, source, shape, call, a 4 GB output timed fewer times)
    timed = [("rerank_distances", "rerank", "Q=100 N=4000 D=128 (Stage B)",
              lambda: ops.exact_distances(sq, sx), False),
             ("rerank_distances", "rerank", f"Q=1000 N={gx.shape[0]} D=128 (ground truth)",
              lambda: ops.exact_distances(gq, gx), True),
             ("pq_scan", "pq_scan", f"Q=100 N={shard_n} m=32 K=256",
              lambda: ops.pq_scan(luts, codes), False)]
    for name, src, shape, fn, big in timed:
        a, b = _turns(torch, src, old[src], libs[src], fn, timer=lambda torch, fn: device_ms(
            torch, fn, inner=1 if big else 20, reps=5 if big else 15))
        ha, hb = _turns(torch, src, old[src], libs[src], fn, timer=lambda torch, fn: time_ms(
            torch, fn, reps=5 if big else 30, warmup=1))
        log(f"parent vs change {name} [{shape}]: parent {a:.4f} ms, change {b:.4f} ms, "
            f"change/parent {b / a:.3f} (device); with the host's dispatch {ha:.4f} / {hb:.4f} ms")


def phase_parent(torch, dev, shard_n: int, seed: int, parent: str):
    """``--parent DIR``: this checkout's kernels of ``masked_topk.cu``,
    ``rerank.cu``, ``kmeans_assign.cu`` and ``pq_scan.cu`` against those of
    ``DIR`` (an earlier commit's tree).  Every f32, int8, ADC and unified
    launch name of ``masked_topk.cu`` on seeded phase-2 inputs (N = 4,096
    and one shard; both metrics, the 50 % row mask and the dedup'd plane of
    ten price masks, k = 40 and 160, and for the int8, ADC and unified
    names also k = 1 and 600, past the chunk) gives the same distance bits
    and ids from both builds; the bf16 names, whose tile may round apart from its
    parent's, are held to the plain version's tolerance and ids from both
    builds instead.  So are ``gather_rerank`` and ``kmeans_assign`` (see
    ``_parent_rerank_kmeans``), ``rerank_distances`` and ``pq_scan`` (see
    ``_parent_rerank_pq``), bit for bit.  Then every masked launch name at
    its phase-2 timed shape, row 5 under the main path's price bands, rows
    5', 4 and 6 at phase 7's shape, rows 8, 8' and 9 at phase 6's (device
    and host-inclusive times) and the k sweeps (exact and ADC) are timed in
    turns (parent, change, change, parent) on this card.  Returns the
    parent's libraries by source name."""
    from repro_torch.kernels import _build, autotune

    old_libs = _parent_libs(parent)
    libs = {name: _build.load(name) for name in PARENT_SOURCES}
    # this checkout's masked launches at tile_q = 0 (the launch's own rule,
    # as the parent has no other): the autotuner sees no fixture here
    cache_path = autotune._CACHE_PATH
    autotune._CACHE_PATH = Path(tempfile.gettempdir()) / "no-autotune-cache.json"
    autotune.clear_cache()
    try:
        return _phase_parent(torch, dev, shard_n, seed, old_libs, libs)
    finally:
        autotune._CACHE_PATH = cache_path
        autotune.clear_cache()


def _phase_parent(torch, dev, shard_n: int, seed: int, old_libs: dict, libs: dict):
    from repro_torch.kernels import _build, ops, ref

    _parent_rerank_kmeans(torch, dev, shard_n, seed, libs, old_libs)
    _parent_rerank_pq(torch, dev, shard_n, seed, libs, old_libs)
    new, old = libs["masked_topk"], old_libs["masked_topk"]
    rng = np.random.default_rng(seed + 4)
    Q, D, M, KC = 100, 128, 32, 256
    thresholds = (2, 3, 4, 5, 6, 100, 325, 550, 775, 1000)
    data = {}
    for n in (SMALL_SHARD, shard_n):
        q, x, luts, codes, _ = _masked_case(torch, dev, rng, Q, n, D, 0.0, m=M, kc=KC)
        price = torch.as_tensor(rng.integers(0, PRICE_MAX, size=n)).to(dev)
        uniq = torch.stack([price < t for t in thresholds])
        idx = torch.as_tensor(np.arange(Q) % uniq.shape[0]).to(dev)
        wide = price < 5000
        flavor = torch.arange(Q, device=dev) % 2 == 1
        quant = {dt: ref.quantize_points(x, dt) for dt in QUANT}
        data[n] = (q, x, price, quant, luts, codes)
        # calls held bit for bit (f32, int8, ADC, unified) and, for bf16,
        # whose tile scores on the tensor cores in another order, to the
        # plain version's tolerance (each call takes its backend)
        calls, close = [], []
        for k in (40, 160):
            calls += [
                (f"masked_pq_topk k={k}", lambda k=k: ops.masked_pq_topk(luts, codes, wide, k)),
                (f"masked_pq_topk_multi k={k}",
                 lambda k=k: ops.masked_pq_topk_dedup(luts, codes, uniq, idx, k)),
            ]
            for metric in ("l2", "ip"):
                calls += [
                    (f"masked_exact_topk k={k} {metric}",
                     lambda k=k, mt=metric: ops.masked_exact_topk(q, x, wide, k, metric=mt)),
                    (f"masked_exact_topk_multi k={k} {metric}",
                     lambda k=k, mt=metric: ops.masked_exact_topk_dedup(q, x, uniq, idx, k, metric=mt)),
                    (f"unified_masked_topk k={k} {metric}",
                     lambda k=k, mt=metric: ops.unified_masked_topk_dedup(
                         q, x, luts, codes, uniq, idx, flavor, k, metric=mt)),
                ]
                for dt, (st, xs) in quant.items():
                    kw = dict(metric=metric, dtype=dt, x_scale=xs)
                    pair = [
                        (f"masked_exact_topk_{dt} k={k} {metric}",
                         lambda b, k=k, st=st, kw=kw: ops.masked_exact_topk(q, st, wide, k, backend=b, **kw)),
                        (f"masked_exact_topk_multi_{dt} k={k} {metric}",
                         lambda b, k=k, st=st, kw=kw: ops.masked_exact_topk_dedup(
                             q, st, uniq, idx, k, backend=b, **kw)),
                    ]
                    if dt == "bf16":
                        close += pair
                    else:
                        calls += [(label, lambda fn=fn: fn("auto")) for label, fn in pair]
        # the int8, ADC and unified names (this change's tiles) also at k = 1
        # and past the 512-row chunk
        st, xs = quant["int8"]
        for k in (1, 600):
            calls += [
                (f"masked_pq_topk k={k}", lambda k=k: ops.masked_pq_topk(luts, codes, wide, k)),
                (f"masked_pq_topk_multi k={k}",
                 lambda k=k: ops.masked_pq_topk_dedup(luts, codes, uniq, idx, k)),
            ]
            for metric in ("l2", "ip"):
                kw = dict(metric=metric, dtype="int8", x_scale=xs)
                calls += [
                    (f"unified_masked_topk k={k} {metric}",
                     lambda k=k, mt=metric: ops.unified_masked_topk_dedup(
                         q, x, luts, codes, uniq, idx, flavor, k, metric=mt)),
                    (f"masked_exact_topk_int8 k={k} {metric}",
                     lambda k=k, kw=kw: ops.masked_exact_topk(q, st, wide, k, **kw)),
                    (f"masked_exact_topk_multi_int8 k={k} {metric}",
                     lambda k=k, kw=kw: ops.masked_exact_topk_dedup(q, st, uniq, idx, k, **kw)),
                ]
        counts = _same_bits(torch, "masked_topk", old, new, calls, f"masked_topk.cu N={n}")
        counts.update(_same_tolerance(torch, "masked_topk", old, new, close, 1e-5 * (_scale(q, x) + 1.0),
                                      f"masked_topk.cu bf16 N={n}"))
        if set(counts) != set(MASKED_NAMES):
            raise AssertionError(f"--parent N={n}: launched {sorted(counts)}, not every masked launch name")

    # the phase-2 timed calls (one shard), row 5 under the main path's bands
    # and row 5' at phase 7's shape; (host-timed call, device-timed call):
    # the int8 and unified wrappers read a value back from the card, so
    # their device times take the launch with it worked out once
    from repro_torch.kernels import masked_topk as km

    q, x, price, quant, luts, codes = data[shard_n]
    sq, sx, sprice, squant, sluts, scodes = data[SMALL_SHARD]
    timed = {
        "masked_exact_topk": lambda: ops.masked_exact_topk(q, x, wide, 40),
        "masked_exact_topk_multi": lambda: ops.masked_exact_topk_dedup(q, x, uniq, idx, 40),
        "masked_pq_topk": lambda: ops.masked_pq_topk(luts, codes, wide, 160),
        "masked_pq_topk_multi": lambda: ops.masked_pq_topk_dedup(luts, codes, uniq, idx, 160),
    }
    timed = {f"{name} [phase-2 timed shape, N={shard_n}]": (fn, fn) for name, fn in timed.items()}
    timed[f"unified_masked_topk [phase-2 timed shape, N={shard_n}]"] = (
        lambda: ops.unified_masked_topk_dedup(q, x, luts, codes, uniq, idx, flavor, 160),
        _unified_launch(torch, q, x, luts, codes, uniq, idx, flavor, 160))
    wide_u8 = wide.to(torch.uint8).reshape(1, -1).contiguous()
    uniq_u8, idx32 = uniq.to(torch.uint8).contiguous(), idx.to(torch.int32).contiguous()
    for dt, (s, xs) in quant.items():
        qs, q_scale = ref.quantize_points(q, dt)
        sc = (q_scale, xs) if dt == "int8" else None
        timed[f"masked_exact_topk_{dt} [phase-2 timed shape, N={shard_n}]"] = (
            lambda s=s, xs=xs, dt=dt: ops.masked_exact_topk(q, s, wide, 160, dtype=dt, x_scale=xs),
            lambda s=s, qs=qs, sc=sc: km.masked_exact_topk(qs, s, wide_u8, None, 160, scales=sc))
        timed[f"masked_exact_topk_multi_{dt} [phase-2 timed shape, N={shard_n}]"] = (
            lambda s=s, xs=xs, dt=dt: ops.masked_exact_topk_dedup(q, s, uniq, idx, 160, dtype=dt, x_scale=xs),
            lambda s=s, qs=qs, sc=sc: km.masked_exact_topk(qs, s, uniq_u8, idx32, 160, scales=sc))
    for thr in PROD_F32_BANDS:
        fn = (lambda m=price < thr: ops.masked_exact_topk(q, x, m, 40))
        timed[f"masked_exact_topk [Q=100 N={shard_n} k=40 price < {thr}]"] = (fn, fn)
    fn = (lambda m=sprice < PROD_BF16_BAND, s=squant["bf16"][0]: ops.masked_exact_topk(
        sq, s, m, 160, dtype="bf16", x_scale=1.0))
    timed[f"masked_exact_topk_bf16 [Q=100 N={SMALL_SHARD} k=160 price < {PROD_BF16_BAND}]"] = (fn, fn)
    # rows 4 and 6 at phase 7's shape, rows 8, 8' and 9 at phase 6's
    s8, sxs = squant["int8"]
    sqs, sq_scale = ref.quantize_points(sq, "int8")
    band = sprice < PROD_BF16_BAND
    suniq = torch.stack([sprice < t for t in PROD_QUANT_BANDS])
    sidx = torch.as_tensor(np.arange(Q) % len(PROD_QUANT_BANDS)).to(dev)
    timed[f"masked_exact_topk_int8 [Q=100 N={SMALL_SHARD} k=160 price < {PROD_BF16_BAND}]"] = (
        lambda: ops.masked_exact_topk(sq, s8, band, 160, dtype="int8", x_scale=sxs),
        lambda: km.masked_exact_topk(sqs, s8, band.to(torch.uint8).reshape(1, -1).contiguous(), None, 160,
                                     scales=(sq_scale, sxs)))
    timed[f"masked_exact_topk_multi_int8 [Q=100 N={SMALL_SHARD} k=160 ten phase-7 bands]"] = (
        lambda: ops.masked_exact_topk_dedup(sq, s8, suniq, sidx, 160, dtype="int8", x_scale=sxs),
        lambda: km.masked_exact_topk(sqs, s8, suniq.to(torch.uint8).contiguous(),
                                     sidx.to(torch.int32).contiguous(), 160, scales=(sq_scale, sxs)))
    for name, (uniq6, idx6, fl6) in phase6_masks(torch, sprice, Q).items():
        label = f"{name} [Q=100 N={SMALL_SHARD} m=32 K=256 k=160 phase 6's masks]"
        if name == "unified_masked_topk":
            timed[label] = (
                lambda u=uniq6, i=idx6, f=fl6: ops.unified_masked_topk_dedup(sq, sx, sluts, scodes, u, i, f, 160),
                _unified_launch(torch, sq, sx, sluts, scodes, uniq6, idx6, fl6, 160))
        else:
            fn = (lambda u=uniq6, i=idx6: ops.masked_pq_topk_dedup(sluts, scodes, u, i, 160)
                  if u.shape[0] > 1 else ops.masked_pq_topk(sluts, scodes, u[0], 160))
            timed[label] = (fn, fn)
    for label, (host, dev_fn) in timed.items():
        a, b = _turns(torch, "masked_topk", old, new, dev_fn,
                      timer=lambda torch, fn: device_ms(torch, fn, inner=5, reps=10))
        ha, hb = _turns(torch, "masked_topk", old, new, host)
        log(f"parent vs change {label}: parent {a:.4f} ms, change {b:.4f} ms, change/parent {b / a:.3f} "
            f"(device); with the host's dispatch {ha:.4f} / {hb:.4f} ms")
    for dt in ("f32",) + tuple(QUANT):
        s, xs = (x, None) if dt == "f32" else quant[dt]
        kw = {} if dt == "f32" else dict(dtype=dt, x_scale=xs)
        parts = []
        sweep = [(f"k={k}", wide, k) for k in SWEEP_K]
        sweep += [(f"{label} k=160", m, 160) for label, m in _sweep_masks(wide).items()]
        for label, mask, k in sweep:
            a, b = _turns(torch, "masked_topk", old, new,
                          lambda mask=mask, k=k: ops.masked_exact_topk(q, s, mask, k, **kw))
            parts.append(f"{label} {a:.4f} / {b:.4f}")
        name = "masked_exact_topk" + ("" if dt == "f32" else f"_{dt}")
        log(f"parent vs change k sweep {name} [Q=100 N={shard_n} D=128 mask 50%], parent / change ms "
            "(with the host's dispatch): " + ", ".join(parts))
    parts = []
    for label, mask, k in sweep:
        a, b = _turns(torch, "masked_topk", old, new, lambda mask=mask, k=k: ops.masked_pq_topk(luts, codes, mask, k))
        parts.append(f"{label} {a:.4f} / {b:.4f}")
    log(f"parent vs change k sweep masked_pq_topk [Q=100 N={shard_n} m=32 K=256 mask 50%], parent / change "
        "ms (with the host's dispatch): " + ", ".join(parts))
    return old_libs


def _shadow_main_path(torch, old_libs: dict) -> dict:
    """``--parent DIR`` with the main path: from here on every
    ``gather_rerank``, ``kmeans_assign`` and ``exact_distances``
    (``rerank_distances``) call on a CUDA tensor, and every int8 exact
    scan, masked ADC and unified call (``masked_topk.cu``), also runs the
    parent's build of its source, on the same inputs and thread and
    uncounted, and the two outputs are compared bit for bit.  Returns the
    tally {name: [calls, calls whose bits differ]} (SHADOWED names),
    filled as phases 3-9 run."""
    import threading

    from repro_torch.kernels import _build, ops

    local = threading.local()
    load, count = _build.load, _build.count_launch

    def shadow_load(name):
        sub = getattr(local, "libs", None)
        return sub[name] if sub and name in sub else load(name)

    def shadow_count(name, shape=None):
        if not getattr(local, "libs", None):
            count(name, shape)

    _build.load, _build.count_launch = shadow_load, shadow_count
    tally: dict = {}
    lock = threading.Lock()

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def wrap(name, src, fn, when=None):
        def call(*a, **kw):
            # an op that another wrapped op calls runs as it is, once
            if getattr(local, "active", False):
                return fn(*a, **kw)
            local.active = True
            try:
                out = fn(*a, **kw)
                outs = out if isinstance(out, tuple) else (out,)
                if (kw.get("backend", "auto") == "ref" or not outs[0].is_cuda
                        or (when is not None and not when(kw))):
                    return out
                local.libs = {src: old_libs[src]}
                try:
                    old = fn(*a, **kw)
                finally:
                    local.libs = None
            finally:
                local.active = False
            olds = old if isinstance(old, tuple) else (old,)
            same = all(torch.equal(bits(u), bits(v)) for u, v in zip(outs, olds))
            with lock:
                t = tally.setdefault(name, [0, 0])
                t[0] += 1
                t[1] += not same
            return out
        return call

    def int8(kw):
        return kw.get("dtype") == "int8"

    ops.gather_rerank = wrap("gather_rerank", "rerank", ops.gather_rerank)
    ops.kmeans_assign = wrap("kmeans_assign", "kmeans_assign", ops.kmeans_assign)
    ops.exact_distances = wrap("rerank_distances", "rerank", ops.exact_distances)
    # the masked launch names whose tiles this change rebuilt: int8 and ADC
    ops.masked_exact_topk = wrap("masked_exact_topk_int8", "masked_topk", ops.masked_exact_topk, int8)
    ops.masked_exact_topk_dedup = wrap("masked_exact_topk_multi_int8", "masked_topk",
                                       ops.masked_exact_topk_dedup, int8)
    ops.masked_pq_topk = wrap("masked_pq_topk", "masked_topk", ops.masked_pq_topk)
    ops.masked_pq_topk_dedup = wrap("masked_pq_topk_multi", "masked_topk", ops.masked_pq_topk_dedup)
    ops.unified_masked_topk_dedup = wrap("unified_masked_topk", "masked_topk", ops.unified_masked_topk_dedup)
    return tally


# every launch name _shadow_main_path holds against the parent's build
SHADOWED = ("gather_rerank", "kmeans_assign", "masked_exact_topk_int8", "masked_exact_topk_multi_int8",
            "masked_pq_topk", "masked_pq_topk_multi", "rerank_distances", "unified_masked_topk")


# -- phase 3 -------------------------------------------------------------------

def hit_rows(table, hits, rows_per_group: int, k: int = 10, expect=None) -> np.ndarray:
    """(Q, k) global row indices of each query's hits (files in append
    order; -1 pads), after checking each query got ``expect[q]`` (default
    k) finite, ascending hits."""
    starts, base = {}, 0
    for f in table.current_files():
        starts[f.path] = base
        base += f.record_count
    got = np.full((len(hits), k), -1, np.int64)
    for qi, hs in enumerate(hits):
        want = k if expect is None else int(expect[qi])
        if len(hs) != want or not all(np.isfinite(h.distance) for h in hs):
            raise AssertionError(f"query {qi}: {len(hs)} hits (expected {want}) or non-finite distances")
        if any(a.distance > b.distance for a, b in zip(hs, hs[1:])):
            raise AssertionError(f"query {qi}: hits not ascending")
        got[qi, : len(hs)] = [starts[h.file_path] + h.row_group * rows_per_group + h.row_offset
                              for h in hs]
    return got


def _expect(price, thr, k=10):
    """Hits each query must get: k, or fewer when fewer rows pass."""
    thr = np.asarray(thr)
    passing = {int(t): int((price < t).sum()) for t in np.unique(thr)}
    return np.array([min(k, passing[int(t)]) for t in thr.reshape(-1)])


def _passes(price, got, thr) -> bool:
    ok = got < 0
    safe = np.where(ok, 0, got)
    return bool((ok | (price[safe] < np.asarray(thr).reshape(-1, 1))).all())


def phase_main_path(torch, n: int, n_queries: int, seed: int, workdir: str):
    from repro_torch.core.vamana import brute_force_topk
    from repro_torch.kernels import _build
    from repro_torch.lakehouse.table import LakehouseTable
    from repro_torch.runtime.cluster import make_local_cluster
    from repro_torch.runtime.coordinator import IndexConfig

    rng = np.random.default_rng(seed)
    t0 = time.time()
    # the base rows, the queries and the rows phase 5 appends, one mixture
    data = mixture(n + n_queries + TAIL_ROWS, 128, rng)
    X, Q, T = data[:n], data[n : n + n_queries], data[n + n_queries :]
    price = rng.integers(0, PRICE_MAX, size=n + TAIL_ROWS).astype(np.int64)
    log(f"data: N={n} x 128 f32 + {n_queries} queries + {TAIL_ROWS} tail rows, Gaussian mixture "
        f"of {MIX_COMPONENTS} components (centers N(0,{MIX_CENTER_SCALE}^2), rank-{MIX_RANK} "
        f"covariance, noise {MIX_NOISE}), int64 price uniform on [0, {PRICE_MAX}), "
        f"{time.time() - t0:.1f} s")

    cluster = make_local_cluster(workdir, num_executors=4)
    table = LakehouseTable(cluster.catalog, "sift")
    table.create(dim=128)
    rows_per_group = 4096
    t0 = time.time()
    table.append_vectors(X, num_files=16, rows_per_group=rows_per_group,
                         attributes={"price": price[:n]})
    log(f"table: 16 files written in {time.time() - t0:.1f} s")
    # build_batch 2048 (IndexConfig's default is 128): an existing user
    # setting that cuts a 250k-point shard's build to ~123 batches a pass
    cfg = IndexConfig(name="idx", R=64, L=100, alpha=1.2, pq_m=32, pq_nbits=8,
                      build_batch=BUILD_BATCH)

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.time()
    rep = cluster.coordinator.create_index("sift", cfg)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    build_launches = _build.launch_counts()
    _add_shapes("3", _build.launch_shapes())
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
    _add_shapes("3", _build.launch_shapes())
    launches = {k: build_launches.get(k, 0) + probe_launches.get(k, 0) for k in MAIN_KERNELS}
    log(f"probe: {calls} calls x 100 queries in {probe_s:.1f} s = {calls * 100 / probe_s:.1f} QPS; "
        f"stage A {stage_a:.1f} s, stage B+C {stage_b:.1f} s")
    log(f"launches: build {build_launches}, probe {probe_launches} "
        f"(per probe call {({k: v / calls for k, v in probe_launches.items()})})")
    for name in MAIN_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")

    # recall@10 against brute force (the rerank_distances kernel, 1,000
    # queries a chunk, counted with phase 3's launches); hits map back to
    # row indices through the file layout
    got = hit_rows(table, hits, rows_per_group)
    truth_d = np.empty((len(hits), 10), np.float32)
    truth = np.empty((len(hits), 10), np.int64)
    _build.reset_launch_counts()
    t0 = time.time()
    for s in range(0, len(hits), 1000):
        truth_d[s : s + 1000], truth[s : s + 1000] = brute_force_topk(X, Q[s : s + 1000], 10)
    torch.cuda.synchronize()
    gt_s = time.time() - t0
    _add(launches, {k: v for k, v in _build.launch_counts().items() if k in MAIN_KERNELS})
    _add_shapes("3", _build.launch_shapes())
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
    # phase 9 opens this snapshot again by its id (with its files' first row
    # numbers) and scores against this truth
    starts, base = {}, 0
    for f in table.current_files():
        starts[f.path] = base
        base += f.record_count
    ctx = dict(cluster=cluster, table=table, X=X, Q=Q, T=T, price=price,
               rows_per_group=rows_per_group, device=cluster.device, truth=truth,
               snapshot_id=table.metadata().current_snapshot_id, starts=starts)
    return launches, dict(build_s=build_s, probe_s=probe_s, recall=recall), ctx


# -- phases 4 to 6 -----------------------------------------------------------------

def _truth(torch, ops, vecs_dev, queries, unique_masks_dev, row_index, k=10, chunk=100):
    """Filtered ground truth: the plain masked op on the card (each query
    under its own mask row), chunk by chunk."""
    out = np.empty((queries.shape[0], k), np.int64)
    for s in range(0, queries.shape[0], chunk):
        q = torch.as_tensor(queries[s : s + chunk]).to(vecs_dev.device)
        idx = torch.as_tensor(row_index[s : s + chunk]).to(vecs_dev.device)
        _, ids = ops.masked_exact_topk_dedup(q, vecs_dev, unique_masks_dev, idx, k, backend="ref")
        out[s : s + chunk] = ids.cpu().numpy()
    return out


def _recall(got, truth) -> float:
    per = [len(set(g) & set(t[t >= 0])) / max(int((t >= 0).sum()), 1) for g, t in zip(got, truth)]
    return float(np.mean(per))


def _run(torch, what, calls):
    """Run ``calls`` (callables returning ProbeReports) with the launch
    counts set to 0 before and read after; returns (reports, seconds,
    launches)."""
    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.time()
    reports = [c() for c in calls]
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = _build.launch_counts()
    _add_shapes(what.split()[1], _build.launch_shapes())
    r0 = reports[0]
    if hasattr(r0, "plan"):
        log(f"{what}: {len(calls)} calls in {secs:.2f} s; plan "
            f"{r0.plan.summary() if r0.plan else None}; kernel_dispatches "
            f"{sum(r.kernel_dispatches for r in reports)}, masked_beam rows "
            f"{sum(r.masked_beam_rows for r in reports)} / fallbacks "
            f"{sum(r.masked_beam_fallbacks for r in reports)}; launches {launches}")
    else:
        log(f"{what}: {secs:.2f} s; launches {launches}")
    return reports, secs, launches


# launches by phase, kernel and shape: kmeans_assign by (D, K),
# gather_rerank by (P, k)
SHAPES: dict = {}


def _add_shapes(phase: str, shapes) -> None:
    for name, by_shape in shapes.items():
        into = SHAPES.setdefault(phase, {}).setdefault(name, {})
        for shape, count in by_shape.items():
            into[shape] = into.get(shape, 0) + count


def _shape_totals(name: str) -> dict:
    """Launches of ``name`` over phases 3-9, by shape."""
    out: dict = {}
    for by_kernel in SHAPES.values():
        for shape, count in by_kernel.get(name, {}).items():
            out[shape] = out.get(shape, 0) + count
    return out


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def _need(launches, names, what):
    for name in names:
        if launches.get(name, 0) == 0:
            raise AssertionError(f"{what}: kernel {name} was not launched")


TIGHT = [2, 3, 4, 5, 6]  # price < t: 0.02-0.06 %, ExactScan once resolved
WIDE = [100, 325, 550, 775, 1000]  # price < t: 1-10 %, MaskedBeam on 250k-row shards


def phase_filtered(torch, ctx, n_calls: int):
    """Filtered probes on the phase-3 index: one predicate per band, then
    heterogeneous batches."""
    from repro_torch.kernels import ops

    coord, table = ctx["cluster"].coordinator, ctx["table"]
    X, Q, price, rpg = ctx["X"], ctx["Q"], ctx["price"][: ctx["X"].shape[0]], ctx["rows_per_group"]
    dev = ctx["device"]
    x_dev = torch.as_tensor(X).to(dev)
    price_dev = torch.as_tensor(price).to(dev)
    total, stats = {}, {}
    nq = n_calls * 100
    bands = [("price < 4", "exact", 0.99), ("price < 200", "mbeam", 0.90),
             ("price < 9000", "postfilter", 0.90)]
    for where, band, floor in bands:
        thr = int(where.split("<")[1])
        reps, secs, launches = _run(torch, f"phase 4 probe(filter={where!r})", [
            (lambda c=c: coord.probe("sift", Q[c * 100 : (c + 1) * 100], 10, strategy="diskann",
                                     filter=where)) for c in range(n_calls)])
        _add(total, launches)
        hits = [h for r in reps for h in r.hits]
        got = hit_rows(table, hits, rpg, expect=_expect(price, np.full(nq, thr)))
        if not _passes(price, got, np.full(nq, thr)):
            raise AssertionError(f"{where}: a hit fails the predicate")
        truth = _truth(torch, ops, x_dev, Q[:nq], (price_dev < thr)[None], np.zeros(nq, np.int64))
        recall = _recall(got, truth)
        summary = reps[0].plan.summary()
        mb_rows = sum(r.masked_beam_rows for r in reps)
        fb = sum(r.masked_beam_fallbacks for r in reps)
        log(f"  {where}: recall@10 {recall:.4f} over {nq} queries, {nq / secs:.1f} QPS, "
            f"plan {summary}, passing rows {int((price < thr).sum())}")
        if band == "exact":
            _need(launches, ["masked_exact_topk"], where)
            if mb_rows:
                raise AssertionError(f"{where}: expected ExactScan after resolution, got MaskedBeam rows")
        elif band == "mbeam":
            if "mbeam" not in summary or mb_rows == 0:
                raise AssertionError(f"{where}: MaskedBeam did not run ({summary}, rows {mb_rows})")
        elif "postfilter" not in summary:
            raise AssertionError(f"{where}: expected PostfilterBeam, plan {summary}")
        if recall < floor:
            raise AssertionError(f"{where}: recall@10 {recall:.4f} < {floor}")
        stats[where] = dict(seconds=secs, recall=recall, plan=summary, mbeam_rows=mb_rows,
                            mbeam_fallbacks=fb)

    # heterogeneous batches: ten distinct predicates, query i under preds[i % 10]
    preds = [f"price < {t}" for t in TIGHT] + [f"price < {t}" for t in WIDE]
    thr = np.array(TIGHT + WIDE)
    row_index = np.arange(nq) % len(preds)
    reps, secs, launches = _run(torch, "phase 4 probe_batch(10 predicates)", [
        (lambda c=c: coord.probe_batch("sift", Q[c * 100 : (c + 1) * 100], 10, strategy="diskann",
                                       filter=[preds[i % len(preds)] for i in range(100)]))
        for c in range(n_calls)])
    _add(total, launches)
    got = hit_rows(table, [h for r in reps for h in r.hits], rpg,
                   expect=_expect(price, thr[row_index]))
    if not _passes(price, got, thr[row_index]):
        raise AssertionError("probe_batch: a hit fails its query's predicate")
    uniq = torch.stack([price_dev < int(t) for t in thr])
    truth = _truth(torch, ops, x_dev, Q[:nq], uniq, row_index)
    tight = row_index < len(TIGHT)
    r_tight, r_wide = _recall(got[tight], truth[tight]), _recall(got[~tight], truth[~tight])
    mb_rows = sum(r.masked_beam_rows for r in reps)
    log(f"  probe_batch: recall@10 {r_tight:.4f} (ExactScan rows), {r_wide:.4f} (MaskedBeam rows), "
        f"{nq / secs:.1f} QPS, plan {reps[0].plan.summary()}")
    _need(launches, ["masked_exact_topk_multi"], "probe_batch")
    if mb_rows == 0:
        raise AssertionError("probe_batch: no MaskedBeam rows")
    if r_tight < 0.99 or r_wide < 0.90:
        raise AssertionError(f"probe_batch recall {r_tight:.4f} / {r_wide:.4f} under 0.99 / 0.90")
    stats["probe_batch"] = dict(seconds=secs, recall_exact=r_tight, recall_beam=r_wide,
                                mbeam_rows=mb_rows,
                                mbeam_fallbacks=sum(r.masked_beam_fallbacks for r in reps))
    del x_dev
    return total, stats, (preds, thr)


def phase_tail(torch, ctx, n_calls: int, preds_thr):
    """Append TAIL_ROWS rows without a refresh; unfiltered probes and one
    heterogeneous filtered batch must return every true neighbour that lies
    in the tail."""
    from repro_torch.core.vamana import brute_force_topk
    from repro_torch.kernels import ops

    coord, table = ctx["cluster"].coordinator, ctx["table"]
    X, Q, T, price, rpg = ctx["X"], ctx["Q"], ctx["T"], ctx["price"], ctx["rows_per_group"]
    n = X.shape[0]
    t0 = time.time()
    table.append_vectors(T, num_files=4, rows_per_group=rpg, file_prefix="tail",
                         attributes={"price": price[n:]})
    log(f"phase 5: appended {T.shape[0]} rows ({T.shape[0] // rpg} row groups) in "
        f"{time.time() - t0:.1f} s, no refresh")
    XT = np.concatenate([X, T])
    nq = n_calls * 100
    reps, secs, launches = _run(torch, "phase 5 probe (fresh tail)", [
        (lambda c=c: coord.probe("sift", Q[c * 100 : (c + 1) * 100], 10, strategy="diskann"))
        for c in range(n_calls)])
    total = dict(launches)
    for r in reps:
        if r.tail_rows != T.shape[0] or r.unindexed_rows != 0:
            raise AssertionError(f"tail_rows {r.tail_rows}, unindexed_rows {r.unindexed_rows}")
    got = hit_rows(table, [h for r in reps for h in r.hits], rpg)
    truth = brute_force_topk(XT, Q[:nq], 10, device=ctx["device"])[1]
    in_tail = truth >= n
    missed = sum(int(np.sum(~np.isin(t[m], g))) for g, t, m in zip(got, truth, in_tail))
    log(f"  tail probe: {int(in_tail.sum())} true neighbours in the tail, {missed} missed; "
        f"recall@10 {_recall(got, truth):.4f}; plan {reps[0].plan.summary()}")
    _need(launches, ["masked_exact_topk"], "tail probe")
    if missed:
        raise AssertionError(f"{missed} true neighbours in the tail were not returned")
    tail_in = int(in_tail.sum())

    preds, thr = preds_thr
    row_index = np.arange(100) % len(preds)
    reps, secs_b, launches = _run(torch, "phase 5 probe_batch (fresh tail, 10 predicates)", [
        lambda: coord.probe_batch("sift", Q[:100], 10, strategy="diskann",
                                  filter=[preds[i] for i in row_index])])
    _add(total, launches)
    r = reps[0]
    if r.tail_rows != T.shape[0] or r.unindexed_rows != 0:
        raise AssertionError(f"tail_rows {r.tail_rows}, unindexed_rows {r.unindexed_rows}")
    got = hit_rows(table, r.hits, rpg, expect=_expect(price, thr[row_index]))
    dev = ctx["device"]
    price_dev = torch.as_tensor(price).to(dev)
    uniq = torch.stack([price_dev < int(t) for t in thr])
    truth = _truth(torch, ops, torch.as_tensor(XT).to(dev), Q[:100], uniq, row_index)
    in_tail = truth >= n
    missed = sum(int(np.sum(~np.isin(t[m], g))) for g, t, m in zip(got, truth, in_tail))
    log(f"  tail probe_batch: {int(in_tail.sum())} true filtered neighbours in the tail, {missed} "
        f"missed; plan {r.plan.summary()}")
    _need(launches, ["masked_exact_topk_multi"], "tail probe_batch")
    if missed:
        raise AssertionError(f"{missed} true filtered neighbours in the tail were not returned")
    return total, dict(seconds=secs + secs_b, tail_neighbours=tail_in,
                       tail_filtered_neighbours=int(in_tail.sum()))


def phase_small_shards(torch, ctx, small_n: int, seed: int):
    """A second table cut into shards of at most SMALL_SHARD rows, where the
    planner plans PQScan: the masked ADC kernels, the ADC plane and the
    unified mixed-flavor batch, against force_split_flavors."""
    from repro_torch.core.blobs import ROUTING_BLOB_TYPE, decode_routing_blob
    from repro_torch.kernels import ops
    from repro_torch.lakehouse.table import LakehouseTable
    from repro_torch.runtime.coordinator import IndexConfig

    cluster = ctx["cluster"]
    coord = cluster.coordinator
    rng = np.random.default_rng(seed + 6)
    # 1,000 queries: the first 100 for this phase, all of them for phase 7
    data = mixture(small_n + 1000, 128, rng)
    X2, Q2 = data[:small_n], data[small_n : small_n + 100]
    price = rng.integers(0, PRICE_MAX, size=small_n).astype(np.int64)
    shards = -(-small_n // SMALL_SHARD)
    t2 = LakehouseTable(cluster.catalog, "small")
    t2.create(dim=128)
    t2.append_vectors(X2, num_files=shards, rows_per_group=SMALL_SHARD, attributes={"price": price})
    cfg = IndexConfig(name="small_idx", R=64, L=100, alpha=1.2, pq_m=32, pq_nbits=8,
                      num_shards=shards, partition_mode="file", build_batch=BUILD_BATCH)
    reps, build_s, total = _run(torch, "phase 6 create_index (small shards)",
                                [lambda: coord.create_index("small", cfg)])
    _meta, _snap, _path, reader = coord._resolve_index("small", None, None)
    routing = decode_routing_blob(reader.read_first(ROUTING_BLOB_TYPE))
    sizes = [s.vector_count for s in routing.shards]
    log(f"  {len(sizes)} shards of {min(sizes)}-{max(sizes)} rows, {build_s:.1f} s")
    if max(sizes) > SMALL_SHARD or sum(sizes) != small_n:
        raise AssertionError(f"shard sizes {sizes} exceed {SMALL_SHARD} or miss rows")

    dev = ctx["device"]
    x_dev, price_dev = torch.as_tensor(X2).to(dev), torch.as_tensor(price).to(dev)
    stats = dict(build_s=build_s, shards=len(sizes))
    ctx["small"] = dict(table=t2, X=X2, Q=data[small_n:], price=price)

    def check(what, report, thr, floor=0.90):
        got = hit_rows(t2, report.hits, SMALL_SHARD, expect=_expect(price, thr))
        if not _passes(price, got, thr):
            raise AssertionError(f"{what}: a hit fails its predicate")
        uniq, row_index = np.unique(thr, return_inverse=True)
        truth = _truth(torch, ops, x_dev, Q2, torch.stack([price_dev < int(t) for t in uniq]),
                       row_index.reshape(-1))
        recall = _recall(got, truth)
        log(f"  {what}: recall@10 {recall:.4f}, plan {report.plan.summary()}, kernel_dispatches "
            f"{report.kernel_dispatches} over {report.probe_fragments} fragments")
        if recall < floor:
            raise AssertionError(f"{what}: recall@10 {recall:.4f} < {floor}")
        stats[what] = recall

    reps, secs, launches = _run(torch, "phase 6 probe(filter='price < 3000')", [
        lambda: coord.probe("small", Q2, 10, strategy="diskann", filter="price < 3000")])
    _add(total, launches)
    _need(launches, ["masked_pq_topk", "gather_rerank"], "PQScan probe")
    check("PQScan probe", reps[0], np.full(100, 3000))

    wide = [3000 + 500 * j for j in range(8)]
    thr = np.array([wide[i % 8] for i in range(100)])
    reps, secs, launches = _run(torch, "phase 6 probe_batch(8 PQScan predicates)", [
        lambda: coord.probe_batch("small", Q2, 10, strategy="diskann",
                                  filter=[f"price < {t}" for t in thr])])
    _add(total, launches)
    _need(launches, ["masked_pq_topk_multi"], "PQScan plane")
    check("PQScan plane batch", reps[0], thr)

    thr = np.array([20 if i % 2 == 0 else wide[(i // 2) % 8] for i in range(100)])
    filters = [f"price < {t}" for t in thr]
    reps, secs, launches = _run(torch, "phase 6 probe_batch(mixed flavors, unified)", [
        lambda: coord.probe_batch("small", Q2, 10, strategy="diskann", filter=filters)])
    _add(total, launches)
    uni = reps[0]
    _need(launches, ["unified_masked_topk"], "mixed-flavor batch")
    if uni.kernel_dispatches != uni.probe_fragments:
        raise AssertionError(f"unified: {uni.kernel_dispatches} dispatches over "
                             f"{uni.probe_fragments} fragments")
    check("mixed-flavor batch", uni, thr)
    for ex in cluster.executors:
        ex.force_split_flavors = True
    try:
        reps, secs, launches = _run(torch, "phase 6 probe_batch(mixed flavors, split)", [
            lambda: coord.probe_batch("small", Q2, 10, strategy="diskann", filter=filters)])
    finally:
        for ex in cluster.executors:
            ex.force_split_flavors = False
    _add(total, launches)
    split = reps[0]
    if split.kernel_dispatches != 2 * split.probe_fragments:
        raise AssertionError(f"split: {split.kernel_dispatches} dispatches over "
                             f"{split.probe_fragments} fragments")
    same = all(
        [(h.file_path, h.row_group, h.row_offset, h.distance) for h in a]
        == [(h.file_path, h.row_group, h.row_offset, h.distance) for h in b]
        for a, b in zip(uni.hits, split.hits)
    )
    log(f"  unified vs split: hits bit-identical {same}")
    if not same:
        raise AssertionError("unified and split-flavor hits differ")
    return total, stats


# -- phases 7 and 8 ---------------------------------------------------------------

def phase_quantized(torch, ctx, n_calls: int):
    """Quantized ExactScans on the phase-6 catalog: a 9 % predicate on
    every 4,096-row shard, and batches of ten distinct 0.9-9 % predicates,
    with ``scan_dtype`` bf16 and int8.  The planner plans a scan dtype only
    on ExactScan ops, and only shards of at most EXACT_SCAN_MAX_ROWS rows
    get one (a selective predicate on a bigger shard plans MaskedBeam, and a
    MaskedBeam that collapses to ExactScan scores f32, as in the
    reference), so these are the shards where the quantized scans run."""
    from repro_torch.kernels import ops

    coord = ctx["cluster"].coordinator
    sm = ctx["small"]
    t2, X2, Qs, price = sm["table"], sm["X"], sm["Q"], sm["price"]
    dev = ctx["device"]
    nq = n_calls * 100
    x_dev, price_dev = torch.as_tensor(X2).to(dev), torch.as_tensor(price).to(dev)
    thr = np.array([90 * (j + 1) for j in range(10)])
    preds = [f"price < {t}" for t in thr]
    row_index = np.arange(nq) % len(preds)
    truth_one = _truth(torch, ops, x_dev, Qs[:nq], (price_dev < 900)[None], np.zeros(nq, np.int64))
    truth_batch = _truth(torch, ops, x_dev, Qs[:nq], torch.stack([price_dev < int(t) for t in thr]),
                         row_index)
    total, stats = {}, {}
    for dt in QUANT:
        reps, secs, launches = _run(torch, f"phase 7 probe(filter='price < 900', scan_dtype={dt!r})", [
            (lambda c=c: coord.probe("small", Qs[c * 100 : (c + 1) * 100], 10, strategy="diskann",
                                     filter="price < 900", scan_dtype=dt)) for c in range(n_calls)])
        _add(total, launches)
        ops_ = [op for per in reps[0].plan.ops for op in per.values()]
        if not ops_ or any(type(op).__name__ != "ExactScan" or op.dtype != dt for op in ops_):
            raise AssertionError(f"price < 900 ({dt}): expected {dt} ExactScan on every shard, "
                                 f"got {ops_[:3]}")
        got = hit_rows(t2, [h for r in reps for h in r.hits], SMALL_SHARD,
                       expect=_expect(price, np.full(nq, 900)))
        if not _passes(price, got, np.full(nq, 900)):
            raise AssertionError(f"price < 900 ({dt}): a hit fails the predicate")
        recall = _recall(got, truth_one)
        log(f"  price < 900 ({dt}): recall@10 {recall:.4f} over {nq} queries, {nq / secs:.1f} QPS")
        _need(launches, [f"masked_exact_topk_{dt}", "gather_rerank"], f"price < 900 ({dt})")
        if recall < 0.99:
            raise AssertionError(f"price < 900 ({dt}): recall@10 {recall:.4f} < 0.99")
        reps, secs_b, launches = _run(torch, f"phase 7 probe_batch(10 predicates, {dt})", [
            (lambda c=c: coord.probe_batch("small", Qs[c * 100 : (c + 1) * 100], 10,
                                           strategy="diskann", scan_dtype=dt,
                                           filter=[preds[i % len(preds)] for i in range(100)]))
            for c in range(n_calls)])
        _add(total, launches)
        got = hit_rows(t2, [h for r in reps for h in r.hits], SMALL_SHARD,
                       expect=_expect(price, thr[row_index]))
        if not _passes(price, got, thr[row_index]):
            raise AssertionError(f"probe_batch ({dt}): a hit fails its query's predicate")
        r_batch = _recall(got, truth_batch)
        log(f"  probe_batch ({dt}): recall@10 {r_batch:.4f} (every row ExactScan), "
            f"{nq / secs_b:.1f} QPS")
        _need(launches, [f"masked_exact_topk_multi_{dt}"], f"probe_batch ({dt})")
        if r_batch < 0.99:
            raise AssertionError(f"probe_batch ({dt}) recall@10 {r_batch:.4f} < 0.99")
        stats[dt] = dict(seconds=secs, recall=recall, batch_seconds=secs_b, recall_batch=r_batch)
    del x_dev
    return total, stats


def _time_beam_capture(torch, dev, n: int) -> float:
    """Seconds to build a beam runner at one shard's size (the insert's and
    the probes' batch of 64, L = 100): on a card that captures 8 steps as a
    CUDA graph, which a new device adjacency forces once per insert."""
    from repro_torch.core.vamana import _Beam

    vec = torch.randn((n, 128), device=dev)
    adj = torch.randint(0, n, (n, 64), device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    _Beam(vec, adj, n, 0, (64, 128), 100, 138, "l2", False)
    torch.cuda.synchronize()
    return time.time() - t0


def phase_refresh(torch, ctx, n_calls: int):
    """Delete one base file and fold the tail into the 1M index through
    ``compact_tail`` -> ``refresh_index``; then unfiltered probes over the
    live rows."""
    from repro_torch.core.vamana import brute_force_topk

    cluster, table = ctx["cluster"], ctx["table"]
    coord = cluster.coordinator
    X, Q, T, rpg = ctx["X"], ctx["Q"], ctx["T"], ctx["rows_per_group"]
    XT = np.concatenate([X, T])
    files = table.current_files()
    starts, base = {}, 0
    for f in files:
        starts[f.path] = (base, f.record_count)
        base += f.record_count
    base_files = [f for f in files if "tail" not in f.path]
    doomed = base_files[len(base_files) // 2]
    table.delete_files([doomed.path])
    per_shard = []
    for ex in cluster.executors:  # record each shard's refresh as it returns

        def wrapped(task, _f=ex._refresh_shard):
            r = _f(task)
            per_shard.append(r)
            return r

        ex._refresh_shard = wrapped
    try:
        reps, secs, launches = _run(torch, "phase 8 compact_tail (refresh_index)", [
            lambda: coord.compact_tail("sift", "idx")])
    finally:
        for ex in cluster.executors:
            del ex._refresh_shard  # the class's method again
    rr = reps[0]
    if rr is None:
        raise AssertionError("compact_tail did not refresh (no tail, or under its threshold)")
    for r in sorted(per_shard, key=lambda r: r.shard_id):
        log(f"  shard {r.shard_id}: {r.refresh_seconds:.2f} s, inserted {r.inserted}, tombstoned "
            f"{r.tombstoned}, rows {r.vector_count}, tombstone ratio {r.tombstone_ratio:.4f}")
    log(f"  refresh: {rr.seconds:.2f} s in all, inserted {rr.inserted}, tombstoned "
        f"{rr.tombstoned}, shards refreshed {rr.shards_refreshed}, rebuilt {rr.shards_rebuilt}")
    if rr.inserted != T.shape[0] or rr.tombstoned != doomed.record_count:
        raise AssertionError(f"refresh inserted {rr.inserted} (expected {T.shape[0]}) and "
                             f"tombstoned {rr.tombstoned} (expected {doomed.record_count})")
    if rr.shards_rebuilt:
        raise AssertionError(f"{rr.shards_rebuilt} shards rebuilt under the 0.20 ratio")
    _need(launches, ["kmeans_assign"], "refresh")
    capture = _time_beam_capture(torch, ctx["device"], X.shape[0] // 4)
    log(f"  beam runner capture at one shard's size (once per insert_batch): {capture:.3f} s")

    nq = n_calls * 100
    preps, psecs, plaunches = _run(torch, "phase 8 probe (refreshed index)", [
        (lambda c=c: coord.probe("sift", Q[c * 100 : (c + 1) * 100], 10, strategy="diskann"))
        for c in range(n_calls)])
    _add(launches, plaunches)
    hits = [h for r in preps for h in r.hits]
    if any(h.file_path == doomed.path for hs in hits for h in hs):
        raise AssertionError("a row of the deleted file was returned")
    for r in preps:
        if r.tail_rows or r.unindexed_rows:
            raise AssertionError(f"after compaction: tail_rows {r.tail_rows}, unindexed "
                                 f"{r.unindexed_rows}")
    live = np.concatenate([XT[starts[f.path][0] : starts[f.path][0] + starts[f.path][1]]
                           for f in table.current_files()])
    got = hit_rows(table, hits, rpg)
    truth = np.empty((nq, 10), np.int64)
    for s0 in range(0, nq, 1000):
        truth[s0 : s0 + 1000] = brute_force_topk(live, Q[s0 : min(s0 + 1000, nq)], 10)[1]
    recall = _recall(got, truth)
    log(f"  refreshed probe: recall@10 {recall:.4f} over {nq} queries against {live.shape[0]} "
        f"live rows, {nq / psecs:.1f} QPS")
    _need(plaunches, ["gather_rerank", "rerank_distances"], "refreshed probe")
    if recall < 0.90:
        raise AssertionError(f"recall@10 {recall:.4f} < 0.90 after the refresh")
    return launches, dict(refresh_s=rr.seconds, per_shard_s=[r.refresh_seconds for r in per_shard],
                          beam_capture_s=capture, recall=recall)


# -- phase 9 ----------------------------------------------------------------------

SERVE_POOL = 1_000  # phase 9's queries: the first 1,000 of phase 3
SERVE_SUBMISSIONS = 1_000  # per wave
SERVE_CLIENTS = 8  # client threads
SERVE_WINDOW = 8  # submissions a client keeps in flight
SERVE_ZIPF = 1.1  # exponent of the law that draws a submission's query
SERVE_DEADLINE_MS = 10_000
SERVE_FILTER = "price < 200"  # phase 4's MaskedBeam band, on one submission in four
FAILOVER_SUBMISSIONS = 200
FAILOVER_HOLD_S = 0.5


def phase_device_probe(torch, ctx, n_queries: int = SERVE_POOL, per_call: int = 100):
    """9a: the phase-3 snapshot (by its id, so phase 8's tombstones do not
    apply), its shard graphs decoded from the Puffin file into a
    ``DeviceAnnIndex``, probed with ``make_probe_fn`` (k = 10, L = 100,
    oversample 2) against phase 3's ground truth."""
    from repro_torch.core.blobs import SHARD_BLOB_TYPE, decode_shard_blob
    from repro_torch.iceberg.puffin import PuffinReader
    from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn

    cluster, rpg, dev = ctx["cluster"], ctx["rows_per_group"], ctx["device"]
    t0 = time.time()
    snap = cluster.catalog.load_table("sift").snapshot_by_id(ctx["snapshot_id"])
    store = cluster.store
    reader = PuffinReader(store.stat(snap.statistics_file).size, store.range_reader(snap.statistics_file))
    graphs, payloads, starts = [], [], ctx["starts"]
    blobs = sorted(reader.blobs_of_type(SHARD_BLOB_TYPE), key=lambda b: int(b.properties["shard-id"]))
    for b in blobs:
        g, loc = decode_shard_blob(reader.read_blob(b), device=dev)
        first = np.array([starts[p] for p in loc.file_paths], np.int64)
        graphs.append(g)
        payloads.append(first[loc.file_idx[: g.n].astype(np.int64)]
                        + loc.row_group[: g.n].astype(np.int64) * rpg + loc.row_offset[: g.n])
    decode_s = time.time() - t0
    t0 = time.time()
    index = DeviceAnnIndex.from_graphs(graphs, payloads=payloads, device=dev)
    torch.cuda.synchronize()
    upload_s = time.time() - t0
    del graphs
    probe = make_probe_fn(k=10, L=100, oversample=2, device=dev)
    Q, truth = ctx["Q"][:n_queries], ctx["truth"][:n_queries]
    got = np.empty((n_queries, 10), np.int64)
    call_s = []
    for s0 in range(0, n_queries, per_call):
        t0 = time.time()
        d, p = probe(index, Q[s0 : s0 + per_call])
        torch.cuda.synchronize()
        call_s.append(time.time() - t0)
        got[s0 : s0 + per_call] = p.cpu().numpy()
        if not bool(torch.isfinite(d).all()) or bool((d[:, 1:] < d[:, :-1]).any()):
            raise AssertionError("device probe: non-finite or unsorted distances")
    recall = _recall(got, truth)
    secs = sum(call_s)
    log(f"phase 9a device probe: snapshot {ctx['snapshot_id']} ({len(blobs)} shards of "
        f"{[int(c) for c in index.counts.cpu()]} rows, cap {index.vectors.shape[1]}), decoded in "
        f"{decode_s:.2f} s, uploaded in {upload_s:.2f} s; {len(call_s)} calls x {per_call} queries in "
        f"{secs:.2f} s = {n_queries / secs:.1f} QPS (first call {call_s[0]:.3f} s, building "
        f"{index.n_shards} beam runners, then {np.median(call_s[1:]):.3f} s a call); recall@10 "
        f"{recall:.4f}")
    if recall < 0.90:
        raise AssertionError(f"device probe recall@10 {recall:.4f} < 0.90")
    return dict(decode_s=decode_s, upload_s=upload_s, seconds=secs, qps=n_queries / secs,
                recall=recall)


def _wave(batcher, subs, clients: int = SERVE_CLIENTS, window: int = SERVE_WINDOW):
    """``clients`` threads, thread j submitting ``subs[j::clients]`` with at
    most ``window`` in flight (submit a window, wait for it, go on).
    Returns (answers, latencies ms from submit to the Future's completion,
    whether each was answered at the door (done when ``submit`` returned: a
    semantic-cache hit), failures (index, exception), seconds)."""
    import threading

    answers, lat, failures = [None] * len(subs), np.full(len(subs), np.nan), []
    door = np.zeros(len(subs), bool)

    def client(j):
        mine = list(range(j, len(subs), clients))
        for s0 in range(0, len(mine), window):
            futs = []
            for i in mine[s0 : s0 + window]:
                q, tenant, flt = subs[i]
                t0 = time.perf_counter()
                fut = batcher.submit(q, 10, filter=flt, tenant=tenant, deadline_ms=SERVE_DEADLINE_MS)
                door[i] = fut.done()
                fut.add_done_callback(lambda _f, i=i, t0=t0: lat.__setitem__(
                    i, (time.perf_counter() - t0) * 1e3))
                futs.append((i, fut))
            for i, fut in futs:
                try:
                    answers[i] = fut.result(timeout=600)
                except Exception as exc:  # noqa: BLE001 - counted and reported by the caller
                    failures.append((i, exc))

    threads = [threading.Thread(target=client, args=(j,)) for j in range(clients)]
    t0 = time.time()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return answers, lat, door, failures, time.time() - t0


def _hits_key(hits):
    return [(h.file_path, h.row_group, h.row_offset, h.distance) for h in hits]


def _wave_line(what, subs, lat, door, secs, stats, failures) -> str:
    split = ""
    if door.any():
        split = (f" (answered at the door {int(door.sum())}: p50 {np.nanpercentile(lat[door], 50):.2f} "
                 f"ms, p99 {np.nanpercentile(lat[door], 99):.2f} ms; probed {int((~door).sum())}: p50 "
                 f"{np.nanpercentile(lat[~door], 50):.2f} ms, p99 {np.nanpercentile(lat[~door], 99):.2f} ms)")
    return (f"{what}: {len(subs)} submissions in {secs:.2f} s = {len(subs) / secs:.1f} QPS; latency "
            f"p50 {np.nanpercentile(lat, 50):.2f} ms, p99 {np.nanpercentile(lat, 99):.2f} ms{split}; batches "
            f"{stats.batches} (largest {stats.max_batch_seen}), queries probed {stats.queries}, "
            f"kernel_dispatches {stats.kernel_dispatches}, deadline misses {stats.deadline_misses}, "
            f"failed {len(failures)}")


def phase_serving(torch, ctx, seed: int, n_subs: int = SERVE_SUBMISSIONS,
                  n_failover: int = FAILOVER_SUBMISSIONS):
    """9b-9e: Zipf-skewed traffic of two tenants, a quarter filtered,
    through ``ProbeMicroBatcher`` on the refreshed 1M index: a cold wave
    with no cache, the same submissions warm with ``ShardProbeCache`` and
    ``SemanticResultCache`` (bit for bit the cold answers), an append that
    the warm batcher must serve at once, and a wave through an executor
    that dies holding a fragment."""
    from repro_torch.kernels import _build
    from repro_torch.serving.cache import SemanticResultCache, ShardProbeCache
    from repro_torch.serving.serve_loop import ProbeMicroBatcher

    cluster, table, rpg = ctx["cluster"], ctx["table"], ctx["rows_per_group"]
    coord = cluster.coordinator
    pool = ctx["Q"][:SERVE_POOL]
    rng = np.random.default_rng(seed + 9)
    weights = 1.0 / np.arange(1, SERVE_POOL + 1) ** SERVE_ZIPF
    draws = rng.choice(SERVE_POOL, size=n_subs, p=weights / weights.sum())
    subs = [(pool[d], "ab"[i % 2], SERVE_FILTER if i % 4 == 0 else None) for i, d in enumerate(draws)]
    log(f"phase 9 traffic: {n_subs} submissions over {len(np.unique(draws))} distinct pool queries "
        f"(Zipf {SERVE_ZIPF} over {SERVE_POOL}), {len(set((d, i % 2, i % 4 == 0) for i, d in enumerate(draws)))} "
        f"distinct (query, tenant, filter) keys; {SERVE_CLIENTS} clients x {SERVE_WINDOW} in flight")
    launches: dict = {}
    out = {}

    def drive(what, batcher, wave_subs):
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        answers, lat, door, failures, secs = _wave(batcher, wave_subs)
        torch.cuda.synchronize()
        got = _build.launch_counts()
        _add(launches, got)
        _add_shapes("9", _build.launch_shapes())
        log(_wave_line(what, wave_subs, lat, door, secs, batcher.stats, failures) + f"; launches {got}")
        if failures:
            raise AssertionError(f"{what}: {len(failures)} submissions failed, first {failures[0]!r}")
        return answers, lat, secs, got

    coord.probe_cache = None
    with ProbeMicroBatcher(coord, "sift", max_batch=64, max_wait_s=0.002) as cold_mb:
        cold, cold_lat, cold_s, got = drive("phase 9b cold wave", cold_mb, subs)
    masked = sum(v for name, v in got.items() if name.startswith("masked_exact_topk"))
    _need(dict(got, masked_exact_topk_any=masked),
          ["gather_rerank", "rerank_distances", "masked_exact_topk_any"], "cold wave")
    out["cold"] = dict(seconds=cold_s, p50=float(np.percentile(cold_lat, 50)),
                       p99=float(np.percentile(cold_lat, 99)), batches=cold_mb.stats.batches)

    shard_cache = ShardProbeCache(max_bytes=512 << 20)
    semantic = SemanticResultCache(max_bytes=256 << 20)
    coord.probe_cache = shard_cache
    warm_mb = ProbeMicroBatcher(coord, "sift", max_batch=64, max_wait_s=0.002,
                                semantic_cache=semantic).start()
    try:
        warm, warm_lat, warm_s, _ = drive("phase 9c warm wave", warm_mb, subs)
        st = warm_mb.stats
        sem_rate = st.semantic_hits / max(1, st.semantic_hits + st.semantic_misses)
        sc = shard_cache.stats
        shard_rate = sc.hits / max(1, sc.hits + sc.misses)
        differ = [i for i in range(n_subs) if _hits_key(warm[i]) != _hits_key(cold[i])]
        t0 = time.perf_counter()
        for _ in range(100):
            warm_mb._snapshot_id()
        read_ms = (time.perf_counter() - t0) * 10
        log(f"  warm: semantic cache {st.semantic_hits} hits / {st.semantic_misses} misses "
            f"({sem_rate:.4f}), shard cache {sc.hits} hits / {sc.misses} misses ({shard_rate:.4f}, "
            f"{len(shard_cache)} entries, {shard_cache.total_bytes} bytes, {sc.evictions} evictions); "
            f"answers differing from the cold wave's: {len(differ)} of {n_subs}; the snapshot read at "
            f"submit, idle: {read_ms:.3f} ms")
        if differ:
            i = differ[0]
            raise AssertionError(f"warm answer {i} differs from the cold one:\n{_hits_key(warm[i])}\n"
                                 f"{_hits_key(cold[i])}")
        warm_p50, cold_p50 = float(np.percentile(warm_lat, 50)), out["cold"]["p50"]
        if not warm_p50 < cold_p50:
            raise AssertionError(f"warm p50 {warm_p50:.2f} ms is not below cold p50 {cold_p50:.2f} ms")
        out["warm"] = dict(seconds=warm_s, p50=warm_p50, p99=float(np.percentile(warm_lat, 99)),
                           semantic_hit_rate=sem_rate, shard_hit_rate=shard_rate)

        # 9d: an append outside the coordinator, served by the warm batcher
        counts = np.bincount(draws, minlength=SERVE_POOL)
        hot = np.argsort(-counts, kind="stable")[:10]
        cached = sum(semantic.lookup(t, pool[h], 10, None) is not None for h in hot for t in "ab")
        rows = np.concatenate([pool[hot], mixture(SMALL_SHARD - 10, 128, np.random.default_rng(seed + 10))])
        price = np.random.default_rng(seed + 11).integers(0, PRICE_MAX, size=len(rows)).astype(np.int64)
        table.append_vectors(rows, num_files=1, rows_per_group=rpg, file_prefix="late",
                             attributes={"price": price})
        late = table.current_files()[-1].path
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        stale, worst = 0, 0.0
        for j, h in enumerate(hot):
            hits = warm_mb.submit(pool[h], 10, tenant="ab"[j % 2]).result(timeout=600)
            first = hits[0]
            ok = (first.file_path, first.row_group, first.row_offset) == (late, 0, j)
            norm = float(pool[h] @ pool[h])
            if not ok or abs(first.distance) > 1e-5 * norm:
                stale += 1
            worst = max(worst, abs(first.distance))
        got = _build.launch_counts()
        _add(launches, got)
        _add_shapes("9", _build.launch_shapes())
        log(f"phase 9d staleness: appended {len(rows)} rows ({late.split('/')[-1]}), the first 10 "
            f"copies of the 10 hottest queries ({cached} of 20 (query, tenant) answers cached before); "
            f"stale hits {stale} of 10 (max |distance| of the new row {worst:.3g}); semantic hits "
            f"{warm_mb.stats.semantic_hits}, invalidations {semantic.stats.invalidations}; launches {got}")
        if stale:
            raise AssertionError(f"{stale} of 10 hot queries missed their appended copy (stale hits)")
        out["stale_hits"] = stale
    finally:
        warm_mb.stop()
        coord.probe_cache = None

    # 9e: a wave while one executor holds a fragment and goes dark
    fsubs = subs[:n_failover]
    healthy = coord.probe_batch("sift", np.stack([q for q, _, _ in fsubs]), 10,
                                filter=[f for _, _, f in fsubs])
    redispatches = coord.scheduler.stats.redispatches
    doomed = cluster.executors[1]
    try:
        doomed.kill_next(1, hold_s=FAILOVER_HOLD_S)
        with ProbeMicroBatcher(coord, "sift", max_batch=64, max_wait_s=0.002) as fmb:
            chaos, _lat, _s, _ = drive("phase 9e failover wave", fmb, fsubs)
    finally:
        doomed.revive()
    # the dead executor's held attempt may still sleep: nothing joins it
    # (the fragment is re-dispatched once, and no attempt of the wave is
    # computing when it returns; see runtime/scheduler.py)
    redone = coord.scheduler.stats.redispatches - redispatches
    lost = sum(a is None for a in chaos)
    differ = sum(_hits_key(a) != _hits_key(b) for a, b in zip(chaos, healthy.hits) if a is not None)
    log(f"  failover: {lost} lost, {differ} differing from a healthy probe_batch of the same "
        f"{n_failover} queries; redispatches {redone}")
    if lost or differ or redone == 0:
        raise AssertionError(f"failover: {lost} lost, {differ} differing, {redone} redispatches")
    out["failover"] = dict(lost=lost, differ=differ, redispatches=redone)
    return launches, out


# -- phase 10 ---------------------------------------------------------------------

EXAMPLES = ("quickstart", "filtered_search", "fault_tolerance_demo")


def _hold_ops_to_plain(torch, by_dim=None):
    """Phase 10's check that each kernel is right at the shapes the examples
    give it: from here on every ``ops`` call on CUDA tensors also runs its
    plain version on the same inputs (no kernel launch, so nothing is
    counted) and is held to phase 2's tolerance for its kind.  Returns the
    tally {op: [calls, max abs err]} and a function that restores ``ops``;
    with a dict ``by_dim``, also counts the held calls by (op, feature
    width D of the first argument)."""
    import threading

    from repro_torch.kernels import ops

    local = threading.local()
    lock = threading.Lock()
    tally: dict = {}
    saved: dict = {}

    def exact_atol(a):
        return 1e-5 * _scale(a[0], a[1])

    def adc_atol(luts):
        # as phase 2's: ADC sums run in the plain version's order
        return 1e-5 * float(luts.amax(2).sum(1).max()) if luts.numel() else 0.0

    def topk(atol_of):
        return lambda a, got, want: _check_topk(torch, got, want, atol_of(a), "top-k")

    checks = {
        "exact_distances": lambda a, got, want: distances_close(torch, a[0], a[1], got, want),
        "gather_rerank": lambda a, got, want: pooled_close(torch, a[0], a[1], got, want),
        "kmeans_assign": lambda a, got, want: assigned_close(torch, ops, a[0], a[1], got, want),
        "masked_exact_topk": topk(exact_atol),
        "masked_exact_topk_multi": topk(exact_atol),
        "masked_exact_topk_dedup": topk(exact_atol),
        "masked_pq_topk": topk(lambda a: adc_atol(a[0])),
        "masked_pq_topk_multi": topk(lambda a: adc_atol(a[0])),
        "masked_pq_topk_dedup": topk(lambda a: adc_atol(a[0])),
        "unified_masked_topk": topk(lambda a: max(exact_atol(a), adc_atol(a[2]))),
        "unified_masked_topk_dedup": topk(lambda a: max(exact_atol(a), adc_atol(a[2]))),
    }

    def wrap(attr, check):
        fn = saved[attr] = getattr(ops, attr)

        def call(*a, **kw):
            # an op that another held op calls runs as it is, once
            if getattr(local, "active", False) or kw.get("backend", "auto") == "ref":
                return fn(*a, **kw)
            local.active = True
            try:
                out = fn(*a, **kw)
                if not (out[0] if isinstance(out, tuple) else out).is_cuda:
                    return out
                want = fn(*a, **{**kw, "backend": "ref"})
            finally:
                local.active = False
            what = attr if kw.get("dtype", "f32") == "f32" else f"{attr} {kw['dtype']}"
            try:
                err = check(a, out, want)
            except AssertionError as e:
                raise AssertionError(f"phase 10 {what}: {e}") from None
            with lock:
                t = tally.setdefault(what, [0, 0.0])
                t[0] += 1
                t[1] = max(t[1], err)
                if by_dim is not None:
                    key = (what, int(a[0].shape[-1]))
                    by_dim[key] = by_dim.get(key, 0) + 1
            return out
        setattr(ops, attr, call)

    for attr, check in checks.items():
        wrap(attr, check)

    def restore():
        for attr, fn in saved.items():
            setattr(ops, attr, fn)

    return tally, restore


def _example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", HERE / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fault_demo_job():
    return ("fault_demo", [sys.executable, str(HERE / "examples" / "torch_fault_tolerance_demo.py")],
            None, None)


def phase_examples(torch, beside):
    """10: the port's three lifecycle examples on the card, in-process
    through ``main()``, each with the launch counts set to 0 before it and
    read after, every kernel call held against its plain version; then the
    fault-tolerance demo once more as a process of its own (run beside
    phase 3), which must exit 0 with its straggler's attempt still asleep."""
    from repro_torch.kernels import _build

    launches: dict = {}
    facts: dict = {}
    tally, restore = _hold_ops_to_plain(torch)
    try:
        for name in EXAMPLES:
            main_fn = _example(name).main
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0 = time.time()
            facts[name] = main_fn("cuda")
            torch.cuda.synchronize()
            secs = time.time() - t0
            got = _build.launch_counts()
            _add(launches, got)
            log(f"phase 10 {name}: {secs:.2f} s; launches {got}; by shape {_build.launch_shapes()}")
            facts[name]["seconds"] = secs
    finally:
        restore()
    log(f"phase 10 held against the plain version: "
        f"{ {k: f'{n} calls, max abs err {e:.3g}' for k, (n, e) in sorted(tally.items())} }")
    q, f, d = facts["quickstart"], facts["filtered_search"], facts["fault_tolerance_demo"]
    rec = {s: r["recall"] for s, r in q["probe"].items()}
    if rec["scan"] != 1.0 or rec["diskann"] < 0.95:
        raise AssertionError(f"quickstart recalls {rec}: scan must be 1.000, diskann >= 0.95")
    if not q["inserted"] == q["tombstoned"] == 800 or q["orphans"] <= 0:
        raise AssertionError(f"quickstart refresh inserted {q['inserted']}, tombstoned "
                             f"{q['tombstoned']}, orphans {q['orphans']}")
    bands = {w: b["recall"] for w, b in f["bands"].items()}
    if any(r != 1.0 for r in bands.values()) or not f["replay_identical"]:
        raise AssertionError(f"filtered_search recall@10 {bands}, replay identical "
                             f"{f['replay_identical']}")
    if (d["shards"], d["vectors"], d["dead_result_sets"]) != (4, 4000, 4):
        raise AssertionError(f"fault demo: {d['shards']} shards / {d['vectors']} vectors, "
                             f"{d['dead_result_sets']} result sets with ex-0 down")
    _need(launches, MAIN_KERNELS, "phase 10")
    rc, out, err, sub_s = beside.result("fault_demo")
    log(f"phase 10 fault demo as a process (beside phase 3): rc {rc} in {sub_s:.2f} s; "
        f"{out.strip().splitlines()[-1:]}")
    if rc != 0 or "terminate called" in err:
        raise AssertionError(f"fault demo process: rc {rc}, stderr {err[-2000:]}")
    return launches, dict(seconds={n: facts[n]["seconds"] for n in EXAMPLES}, process_s=sub_s,
                          recall=rec, bands=bands)


# -- phase 11 ---------------------------------------------------------------------

LM_ARCH = "qwen2.5-3b"  # its published config, configs/qwen2_5_3b.py (hf:Qwen/Qwen2.5-3B)
LM_BATCH, LM_PROMPT, LM_GEN = 8, 16, 32  # examples/serve_retrieval.py's requests
LM_LAMBDA = 0.3
LM_CORPUS, LM_FILES, LM_QUERIES = 4_000, 4, 100
LM_ROWS_PER_FILE = LM_CORPUS // LM_FILES  # one row group a file
LM_K, LM_L = 8, 32  # the example's make_probe_fn(k=8, L=32)
# the recall gate's beam: on these near-equidistant 2,048-wide columns the
# example's L = 32 reaches recall@8 of about 0.7 (printed beside the gate)
LM_RECALL_L = 512
LM_PQ_M = 128  # the PQ twin's subspaces: d / 16, build_vamana's default
LM_INDEX = dict(R=16, L=32, partitions_per_shard=2, build_passes=1, build_batch=256)


def _lm_graphs(torch, cluster, rep, files, dev):
    """The snapshot's shard graphs decoded from its Puffin file, and each
    indexed vector's global row, found through the shard's own file list
    (the partitioner's order, not the table's)."""
    from repro_torch.core.blobs import SHARD_BLOB_TYPE, decode_shard_blob
    from repro_torch.iceberg.puffin import PuffinReader

    store = cluster.store
    reader = PuffinReader(store.stat(rep.puffin_path).size, store.range_reader(rep.puffin_path))
    graphs, rows = [], []
    for bm in reader.blobs_of_type(SHARD_BLOB_TYPE):
        g, loc = decode_shard_blob(reader.read_blob(bm), device=dev)
        file_no = np.array([files.index(p) for p in loc.file_paths], np.int64)
        graphs.append(g)
        rows.append(LM_ROWS_PER_FILE * file_no[loc.file_idx[: g.n].astype(np.int64)]
                    + loc.row_offset[: g.n].astype(np.int64))
    return graphs, rows


def _hit_rows(files, report) -> np.ndarray:
    return np.array([[LM_ROWS_PER_FILE * files.index(h.file_path) + h.row_offset for h in hs]
                     + [-1] * (LM_K - len(hs)) for hs in report.hits], np.int64)


def _whole(t):
    """A DTensor's whole value (a one-rank mesh's local tensor), else ``t``."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _serve(torch, model, params, prompts, retrieval=None, index=None, mesh=None):
    """Prefill ``prompts`` and decode LM_GEN greedy steps through
    ``make_serve_fns`` (on ``mesh`` with ``SERVE_RULES`` when given);
    returns (timings, prefill logits, each step's logits, each step's input
    tokens, a copy of the first step's cache and token), whole tensors."""
    from repro_torch.launch.specs import SERVE_RULES
    from repro_torch.serving.serve_loop import ServeConfig, make_serve_fns

    prefill, decode, sample, _ = make_serve_fns(
        model, mesh, SERVE_RULES if mesh is not None else None,
        cfg=ServeConfig(knn_lambda=LM_LAMBDA if retrieval else 0.0),
        retrieval=retrieval, index_template=index if retrieval else None,
        batch_hint=LM_BATCH, max_len_hint=LM_PROMPT + LM_GEN, device=model.device)
    cache = model.init_cache(LM_BATCH, LM_PROMPT + LM_GEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_p, cache = prefill(params, prompts, cache)
    tok = sample(logits_p)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    first = dict(cache={k: _whole(v).clone() for k, v in cache.items()}, tok=tok.clone())
    steps, fed = [], []
    t0 = time.perf_counter()
    for t in range(LM_PROMPT, LM_PROMPT + LM_GEN):
        fed.append(tok)
        logits, cache = decode(params, tok, cache, t, index)
        steps.append(_whole(logits))
        tok = sample(logits)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    times = dict(prefill_ms=prefill_s * 1e3, prefill_tok_s=LM_BATCH * LM_PROMPT / prefill_s,
                 decode_ms_step=decode_s / LM_GEN * 1e3, decode_tok_s=LM_BATCH * LM_GEN / decode_s)
    return times, _whole(logits_p), steps, fed, first


def decode_profile(torch, step, n_steps: int = 2):
    """Kernels and device busy time a decode step, from ``torch.profiler``
    over ``n_steps`` calls of ``step(i)`` (the device events' own time, the
    host's dispatch not included; device activity only, so the trace stays
    small); (None, None) where the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n_steps):
            step(i)
        torch.cuda.synchronize()
    busy_us, kernels = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        busy_us += us if us is not None else getattr(e, "self_cuda_time_total", 0.0)
        kernels += e.count
    if not kernels:
        return None, None
    return kernels / n_steps, busy_us / n_steps / 1e3


def phase_lm_serving(torch, dev, seed: int, workdir: str):
    """11a: qwen2.5-3b at its published widths, random bf16 weights from
    ``seed``, serving 8 requests of 16 prompt and 32 generated tokens over
    a Puffin-backed kNN-LM index of 4,000 lm_head columns built by
    ``create_index``, with and without retrieval; decode against forward,
    retrieval against lambda = 0, the device probe and ``Coordinator.probe``
    against brute force, every kernel call held against its plain
    version.  A PQ twin of the corpus (m = 128) runs ``search_pq``, so
    ``gather_rerank`` runs at D = 2,048 too (the example's index has no PQ).
    Returns (launches, facts)."""
    from repro_torch.configs import get_config
    from repro_torch.core.vamana import brute_force_topk
    from repro_torch.kernels import _build
    from repro_torch.lakehouse.table import LakehouseTable
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import build_model, torch_dtype
    from repro_torch.runtime.cluster import make_local_cluster
    from repro_torch.runtime.coordinator import IndexConfig
    from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn
    from repro_torch.serving.serve_loop import ServeConfig, make_serve_fns

    facts: dict = {}
    by_dim: dict = {}
    tally, restore = _hold_ops_to_plain(torch, by_dim)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t_phase = time.time()
    try:
        # -- the model at its published widths -----------------------------
        t0 = time.time()
        cfg = get_config(LM_ARCH)
        model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
        params = model.init(dtype=torch_dtype(ServeConfig().param_dtype))
        torch.cuda.synchronize()
        n_params = model.param_count(params)
        param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        bound_ms = param_bytes / PEAK_BYTES * 1e3
        log(f"phase 11a {LM_ARCH}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} heads / "
            f"{cfg.num_kv_heads} KV of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
            f"theta {cfg.rope_theta:g}, qkv bias {cfg.qkv_bias}; {n_params:,} params (the "
            f"config's count without norms and biases: {cfg.param_count():,}; "
            f"{param_bytes / 1e9:.3f} GB bf16) built in {time.time() - t0:.2f} s; decode bound "
            f"(weights read once a step at {PEAK_BYTES / 1e12:.2f} TB/s) {bound_ms:.3f} ms")

        # -- corpus -> lakehouse -> create_index -> Puffin -> device ---------
        rng = np.random.default_rng(seed)
        head = params["lm_head"]  # (d, V) bf16
        V, d = cfg.vocab_size, cfg.d_model
        corpus_tokens = rng.integers(0, V, size=LM_CORPUS).astype(np.int64)
        held = np.setdiff1d(rng.integers(0, V, size=4 * LM_QUERIES), corpus_tokens)
        q_tokens = rng.permutation(held)[:LM_QUERIES]

        def columns(tokens):
            cols = head[:, torch.from_numpy(tokens).to(dev)].T.float().cpu().numpy()
            return (cols + 0.01 * rng.normal(size=cols.shape)).astype(np.float32)

        X, Q = columns(corpus_tokens), columns(q_tokens)
        cluster = make_local_cluster(str(Path(workdir) / "lm"), num_executors=2, device=dev)
        reps, tables = {}, {}
        for name, extra in (("memories", {}), ("memories_pq", dict(pq_m=LM_PQ_M))):
            t0 = time.time()
            table = LakehouseTable(cluster.catalog, name)
            table.create(dim=d)
            table.append_vectors(X, num_files=LM_FILES)
            reps[name] = cluster.coordinator.create_index(
                name, IndexConfig(name=f"{name}_idx", **LM_INDEX, **extra))
            tables[name] = [f.path for f in table.current_files()]
            log(f"phase 11a create_index {name} ({extra or 'no PQ'}): {reps[name].num_shards} shards "
                f"in {time.time() - t0:.2f} s")
        rep, files = reps["memories"], tables["memories"]
        graphs, rows = _lm_graphs(torch, cluster, rep, files, dev)
        index = DeviceAnnIndex.from_graphs(graphs, payloads=[corpus_tokens[r] for r in rows],
                                           device=dev)
        by_row = DeviceAnnIndex.from_graphs(graphs, payloads=rows, device=dev)
        probe = make_probe_fn(k=LM_K, L=LM_L, device=dev)
        queries = []

        def retrieval(idx, q):
            queries.append(q.detach().clone())
            return probe(idx, q)

        # -- serve both ways ---------------------------------------------------
        prompts = torch.from_numpy(rng.integers(0, V, size=(LM_BATCH, LM_PROMPT))).to(dev)
        # warm-up, untimed: cuBLAS handles, the allocator, the probe's beam
        # runners for the decode's query shape (their CUDA graphs)
        prefill_w, decode_w, sample_w, _ = make_serve_fns(model, device=dev)
        cache = model.init_cache(LM_BATCH, LM_PROMPT + LM_GEN)
        logits, cache = prefill_w(params, prompts, cache)
        for t in range(LM_PROMPT, LM_PROMPT + 2):
            logits, cache = decode_w(params, sample_w(logits), cache, t)
        probe(index, Q[:LM_BATCH])
        plain, lp, steps, fed, _ = _serve(torch, model, params, prompts)
        knn, _lp, knn_steps, _fed, first = _serve(torch, model, params, prompts, retrieval, index)
        for what, tm in (("decode", plain), ("decode + kNN-LM probe", knn)):
            log(f"phase 11a {what:22s}: prefill {tm['prefill_ms']:.2f} ms "
                f"({tm['prefill_tok_s']:.1f} tok/s); decode {tm['decode_ms_step']:.3f} ms/step "
                f"({tm['decode_tok_s']:.1f} tok/s, batch {LM_BATCH}); bound {bound_ms:.3f} ms/step")
        facts.update(plain=plain, knn=knn, bound_ms=bound_ms, params=n_params, d=d)
        # what phase 14a serves again on a one-rank mesh
        facts["for_14a"] = dict(model=model, params=params, prompts=prompts, index=index,
                                logits={"plain": (lp, steps), "knn": (_lp, knn_steps)},
                                times={"plain": plain, "knn": knn}, param_bytes=param_bytes)
        # where a step's time goes: device events against the host's clock
        for what, tm, ret in (("decode", plain, None), ("decode + kNN-LM probe", knn, probe)):
            prefill_p, decode_p, sample_p, _ = make_serve_fns(
                model, cfg=ServeConfig(knn_lambda=LM_LAMBDA if ret else 0.0), retrieval=ret,
                device=dev)
            cache = model.init_cache(LM_BATCH, LM_PROMPT + LM_GEN)
            logits, cache = prefill_p(params, prompts, cache)
            tok = [sample_p(logits)]

            def step(i):
                out, _ = decode_p(params, tok[0], cache, LM_PROMPT + i, index if ret else None)
                tok[0] = sample_p(out)

            per_step, busy = decode_profile(torch, step)
            tm.update(events_step=per_step, busy_ms_step=busy)
            log(f"phase 11a {what:22s}: profiled, " + (
                "no device events in the trace: device busy not measured" if busy is None else
                f"{per_step:.1f} device events a step, device busy {busy:.3f} ms a step = "
                f"{busy / tm['decode_ms_step']:.3f} of the timed {tm['decode_ms_step']:.3f} ms "
                f"(idle share {1 - busy / tm['decode_ms_step']:.3f})"))

        # check 1: prefill + decode against forward over the same 48 tokens
        ids = torch.cat([prompts] + fed, dim=1)
        full, _ = model.forward(params, ids)
        scale = max(float(full.abs().max()), 1.0)
        errs = [float((lp[:, 0].float() - full[:, LM_PROMPT - 1].float()).abs().max())]
        errs += [float((s[:, 0].float() - full[:, t].float()).abs().max())
                 for t, s in zip(range(LM_PROMPT, LM_PROMPT + LM_GEN), steps)]
        log(f"phase 11a decode vs forward over {ids.shape[1]} tokens: max abs err {max(errs):.4f} "
            f"(prefill {errs[0]:.4f}), logit scale {scale:.3f}, bound 0.06 x scale")
        if max(errs) >= 0.06 * scale:
            raise AssertionError(f"decode vs forward: {max(errs)} >= 0.06 x {scale}")
        del full

        # check 2: retrieval changes the logits (lambda 0.3 against 0 from the
        # same cache and token)
        _prefill, decode0, _, _ = make_serve_fns(model, cfg=ServeConfig(knn_lambda=0.0),
                                              retrieval=probe, device=dev)
        l0, _ = decode0(params, first["tok"], first["cache"], LM_PROMPT, index)
        mixed = knn_steps[0]
        shift = float((mixed - l0).abs().max())
        log(f"phase 11a retrieval: first step finite {bool(torch.isfinite(mixed).all())}, "
            f"max |lambda 0.3 - lambda 0| {shift:.4f}")
        if not bool(torch.isfinite(mixed).all()) or shift <= 1e-4:
            raise AssertionError(f"retrieval: finite {bool(torch.isfinite(mixed).all())}, shift {shift}")

        # check 3: the device probe and Coordinator.probe against brute force
        _, truth = brute_force_topk(X, Q, LM_K, device=dev)
        recalls = {}
        for L in (LM_L, LM_RECALL_L):
            _d, got = make_probe_fn(k=LM_K, L=L, device=dev)(by_row, Q)
            recalls[f"device L={L}"] = _recall(got.cpu().numpy(), truth)
            report = cluster.coordinator.probe("memories", Q, LM_K, strategy="diskann", L=L)
            recalls[f"coordinator L={L}"] = _recall(_hit_rows(files, report), truth)
        report = cluster.coordinator.probe("memories_pq", Q, LM_K, strategy="diskann", L=LM_L)
        recalls[f"coordinator PQ m={LM_PQ_M} L={LM_L}"] = _recall(
            _hit_rows(tables["memories_pq"], report), truth)
        # check 4 (no gate): the decode steps' soft-embedding queries
        soft = torch.cat(queries).float().cpu().numpy()
        _, soft_truth = brute_force_topk(X, soft, LM_K, device=dev)
        _d, soft_got = make_probe_fn(k=LM_K, L=LM_L, device=dev)(by_row, soft)
        recalls[f"soft-embedding queries, device L={LM_L}"] = _recall(soft_got.cpu().numpy(),
                                                                       soft_truth)
        log(f"phase 11a recall@{LM_K} of {LM_QUERIES} held-out-token queries (and of the "
            f"{soft.shape[0]} decode queries) against brute force over {LM_CORPUS:,} vectors: "
            + ", ".join(f"{k} {v:.4f}" for k, v in recalls.items()))
        facts["recall"] = recalls
        for who in ("device", "coordinator"):
            if recalls[f"{who} L={LM_RECALL_L}"] < 0.90:
                raise AssertionError(f"{who} recall@{LM_K} at L={LM_RECALL_L} < 0.90: {recalls}")
    finally:
        restore()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    log(f"phase 11a: {time.time() - t_phase:.2f} s; launches {launches}; by shape "
        f"{_build.launch_shapes()}; held calls by (op, D) {by_dim}")
    log(f"phase 11a held against the plain version: "
        f"{ {k: f'{n} calls, max abs err {e:.3g}' for k, (n, e) in sorted(tally.items())} }")
    _need(launches, MAIN_KERNELS, "phase 11a")
    for op in ("exact_distances", "gather_rerank", "kmeans_assign"):
        if by_dim.get((op, facts["d"]), 0) == 0:
            raise AssertionError(f"phase 11a: no {op} call at D = {facts['d']}: {by_dim}")
    facts["launches"] = launches
    return launches, facts


def phase_lm_example(torch):
    """11b: ``examples/torch_serve_retrieval.py`` in-process on the card,
    with the launch counts set to 0 before and read after and every kernel
    call held against its plain version: its printed lines and its facts."""
    import contextlib
    import io
    import re

    from repro_torch.kernels import _build

    tally, restore = _hold_ops_to_plain(torch)
    buf = io.StringIO()
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            facts = _example("serve_retrieval").main("cuda")
        torch.cuda.synchronize()
        secs = time.time() - t0
        launches = _build.launch_counts()
    finally:
        restore()
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  | {line}")
    log(f"phase 11b serve_retrieval: {secs:.2f} s; launches {launches}; by shape "
        f"{_build.launch_shapes()}; held against the plain version "
        f"{ {k: f'{n} calls, max abs err {e:.3g}' for k, (n, e) in sorted(tally.items())} }")
    want = [r"== corpus -> lakehouse -> CREATE INDEX ==",
            r"  index built: 2 shards, bound to snapshot \d+",
            r"== batched serving ==",
            r"  decode +\d+\.\d tok/s  \(\d+\.\d ms/step, batch 8\)",
            r"  decode \+ kNN-LM probe +\d+\.\d tok/s  \(\d+\.\d ms/step, batch 8\)",
            r"done\."]
    if len(lines) != len(want) or not all(re.fullmatch(w, g) for w, g in zip(want, lines)):
        raise AssertionError(f"serve_retrieval printed {lines}")
    tps = [facts[k]["tok_s"] for k in ("decode", "decode + kNN-LM probe")]
    if facts["shards"] != 2 or not all(np.isfinite(tps)) or min(tps) <= 0 or facts["knn_shift"] <= 1e-4:
        raise AssertionError(f"serve_retrieval facts {facts}")
    # the example's index has no PQ and serves through the device probe:
    # create_index's k-means is its one kernel
    _need(launches, ("kmeans_assign",), "phase 11b")
    facts["seconds"] = secs
    return launches, facts


LM_LAUNCHER = ["-m", "repro_torch.launch.serve", "--arch", "chatglm3-6b", "--retrieval"]


def _src_env() -> dict:
    import os

    return dict(os.environ, PYTHONPATH=str(HERE / "src"))


def lm_launcher_job():
    return ("serve_launcher", [sys.executable, *LM_LAUNCHER], str(HERE), _src_env())


def phase_lm_launcher(beside):
    """11c: the serving launcher as a process of its own (run beside phase
    3), at its reduced default: ``python -m repro_torch.launch.serve --arch
    chatglm3-6b --retrieval`` must exit 0."""
    rc, out, err, secs = beside.result("serve_launcher")
    log(f"phase 11c {' '.join(LM_LAUNCHER)} (beside phase 3): rc {rc} in {secs:.2f} s; "
        f"{out.strip().splitlines()}")
    if rc != 0:
        raise AssertionError(f"launcher: rc {rc}, stderr {err[-2000:]}")
    return dict(seconds=secs)


# -- phase 12 ---------------------------------------------------------------------

# (arch, layers kept or None for all): each at its published widths
# (configs/rwkv6_3b.py, configs/zamba2_1_2b.py, configs/mixtral_8x7b.py);
# mixtral's 46.7 B parameters (93 GB in bf16) do not fit one 80 GB card, so
# it keeps 8 of its 32 layers (every width, all 8 experts, the router's top 2)
FAMILIES = (("rwkv6-3b", None), ("zamba2-1.2b", None), ("mixtral-8x7b", 8))


def _route_log():
    """Records the experts every MoE routing call picks, in call order (one
    call a layer a pass): returns (log, restore).  Each entry is the sorted
    top-k ids as a (tokens, k) numpy array."""
    from repro_torch.models import moe

    route = moe._route
    calls: list = []

    def spy(p, x, top_k):
        out = route(p, x, top_k)
        calls.append(out[2].reshape(-1, top_k).sort(dim=-1).values.cpu().numpy())
        return out

    moe._route = spy

    def restore():
        moe._route = route
    return calls, restore


def _f32_check(torch, cfg, dev, params, prompts, fed):
    """Decode against forward at f32 compute: a twin of the model with
    ``dtype="float32"`` on the same bf16 weights (cast at use), through its
    own prefill, decode and forward, over the served tokens.  A MoE twin runs
    at the reference's no-drop capacity (num_experts / top_k,
    ``configs/base.py:194-196``), so that forward's GShard dispatch and
    decode's dense one compute one function, and the experts each position's
    router picks are logged in both passes: (per-position max abs error
    (B, 1 + decode steps), column 0 the prefill's last position; the logit
    scale; the positions x layers whose picks differ, or None)."""
    import dataclasses

    from repro_torch.models.model import build_model

    over = dict(dtype="float32")
    if cfg.num_experts:
        over["capacity_factor"] = cfg.num_experts / cfg.top_k
    model = build_model(dataclasses.replace(cfg, **over), device=dev)
    ids = torch.cat([prompts] + fed, dim=1)
    P, S = prompts.shape[1], ids.shape[1]
    calls, restore = _route_log() if cfg.num_experts else ([], lambda: None)
    try:
        logits, cache = model.prefill(params, prompts, model.init_cache(ids.shape[0], S))
        got = [logits[:, 0]]  # the prefill's last position, then each step's
        for t in range(P, S):
            logits, cache = model.decode(params, ids[:, t:t + 1], cache, t)
            got.append(logits[:, 0])
        full, _ = model.forward(params, ids)
    finally:
        restore()
    err = (torch.stack(got, 1).float() - full[:, P - 1:].float()).abs().amax(-1)
    scale = max(float(full.abs().max()), 1.0)
    if not cfg.num_experts:
        return err, scale, None
    # calls: prefill's layers, then each decode step's, then forward's
    nl, B = cfg.num_layers, prompts.shape[0]
    pre, steps, fwd = calls[:nl], calls[nl:-nl], calls[-nl:]
    differ = 0
    for lay in range(nl):
        f = fwd[lay].reshape(B, S, -1)
        differ += int((pre[lay].reshape(B, P, -1) != f[:, :P]).any(-1).sum())
        for j, st in enumerate(steps[lay::nl]):
            differ += int((st.reshape(B, -1) != f[:, P + j]).any(-1).sum())
    return err, scale, differ


def _serve_family(torch, dev, seed: int, workdir: str, arch: str, layers):
    """One family's 11a: the model at its published widths (``layers`` of
    them kept if given), random bf16 weights from ``seed``, a Puffin-backed
    kNN-LM index over 4,000 of its lm_head columns, 8 requests served both
    ways, decode against forward, retrieval against lambda 0, recall of the
    device probe.  Returns (launches, facts)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.vamana import brute_force_topk
    from repro_torch.kernels import _build
    from repro_torch.lakehouse.table import LakehouseTable
    from repro_torch.models.layers import tree_leaves
    from repro_torch.models.model import build_model, torch_dtype
    from repro_torch.runtime.cluster import make_local_cluster
    from repro_torch.runtime.coordinator import IndexConfig
    from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn
    from repro_torch.serving.serve_loop import ServeConfig, make_serve_fns

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t_model = time.time()
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    params = model.init(dtype=torch_dtype(ServeConfig().param_dtype))
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    bound_ms = param_bytes / PEAK_BYTES * 1e3
    what = f"phase 12 {arch}"
    log(f"{what}: {cfg.num_layers} layers{f' (of {get_config(arch).num_layers})' if layers else ''}, "
        f"d {cfg.d_model}, {cfg.num_heads} heads / {cfg.num_kv_heads} KV of {cfg.head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, ssm {cfg.ssm or '-'} (state {cfg.ssm_state}, "
        f"{cfg.ssm_heads_eff} heads), experts {cfg.num_experts} top {cfg.top_k}, window "
        f"{cfg.window}, shared block every {cfg.shared_attn_every}; {n_params:,} params "
        f"({param_bytes / 1e9:.3f} GB bf16) built in {time.time() - t_model:.2f} s; decode bound "
        f"(weights read once a step at {PEAK_BYTES / 1e12:.2f} TB/s) {bound_ms:.3f} ms")

    # -- corpus -> lakehouse -> create_index -> Puffin -> device --------------
    rng = np.random.default_rng(seed)
    head = params["lm_head"]  # (d, V) bf16
    V, d = cfg.vocab_size, cfg.d_model
    corpus_tokens = rng.integers(0, V, size=LM_CORPUS).astype(np.int64)
    held = np.setdiff1d(rng.integers(0, V, size=4 * LM_QUERIES), corpus_tokens)
    q_tokens = rng.permutation(held)[:LM_QUERIES]

    def columns(tokens):
        cols = head[:, torch.from_numpy(tokens).to(dev)].T.float().cpu().numpy()
        return (cols + 0.01 * rng.normal(size=cols.shape)).astype(np.float32)

    X, Q = columns(corpus_tokens), columns(q_tokens)
    t0 = time.time()
    cluster = make_local_cluster(str(Path(workdir) / f"lm12_{arch}"), num_executors=2, device=dev)
    table = LakehouseTable(cluster.catalog, "memories")
    table.create(dim=d)
    table.append_vectors(X, num_files=LM_FILES)
    rep = cluster.coordinator.create_index("memories", IndexConfig(name="memories_idx", **LM_INDEX))
    files = [f.path for f in table.current_files()]
    graphs, rows = _lm_graphs(torch, cluster, rep, files, dev)
    index = DeviceAnnIndex.from_graphs(graphs, payloads=[corpus_tokens[r] for r in rows], device=dev)
    by_row = DeviceAnnIndex.from_graphs(graphs, payloads=rows, device=dev)
    probe = make_probe_fn(k=LM_K, L=LM_L, device=dev)
    log(f"{what} create_index at D = {d}: {rep.num_shards} shards, read from Puffin into a "
        f"DeviceAnnIndex in {time.time() - t0:.2f} s")

    # -- serve both ways --------------------------------------------------------
    prompts = torch.from_numpy(rng.integers(0, V, size=(LM_BATCH, LM_PROMPT))).to(dev)
    prefill_w, decode_w, sample_w, _ = make_serve_fns(model, device=dev)  # warm-up, untimed
    cache = model.init_cache(LM_BATCH, LM_PROMPT + LM_GEN)
    logits, cache = prefill_w(params, prompts, cache)
    for t in range(LM_PROMPT, LM_PROMPT + 2):
        logits, cache = decode_w(params, sample_w(logits), cache, t)
    probe(index, Q[:LM_BATCH])
    plain, lp, steps, fed, _ = _serve(torch, model, params, prompts)
    knn, _lp, knn_steps, _fed, first = _serve(torch, model, params, prompts, probe, index)
    for label, tm in (("decode", plain), ("decode + kNN-LM probe", knn)):
        log(f"{what} {label:22s}: prefill {tm['prefill_ms']:.2f} ms ({tm['prefill_tok_s']:.1f} "
            f"tok/s); decode {tm['decode_ms_step']:.3f} ms/step ({tm['decode_tok_s']:.1f} tok/s, "
            f"batch {LM_BATCH}); bound {bound_ms:.3f} ms/step")
    cache = model.init_cache(LM_BATCH, LM_PROMPT + LM_GEN)
    logits, cache = prefill_w(params, prompts, cache)
    tok = [sample_w(logits)]

    def step(i):
        out, _ = decode_w(params, tok[0], cache, LM_PROMPT + i)
        tok[0] = sample_w(out)

    per_step, busy = decode_profile(torch, step)
    plain.update(events_step=per_step, busy_ms_step=busy)
    log(f"{what} decode profiled: " + (
        "no device events in the trace: device busy not measured" if busy is None else
        f"{per_step:.1f} device events a step, device busy {busy:.3f} ms a step (idle share "
        f"{1 - busy / plain['decode_ms_step']:.3f} of the timed {plain['decode_ms_step']:.3f} ms)"))
    facts = dict(plain=plain, knn=knn, bound_ms=bound_ms, params=n_params, d=d, layers=cfg.num_layers)
    del cache

    # check 1: prefill + decode against forward over the same 48 tokens.  The
    # served bf16 steps against the bf16 forward are recorded: at these
    # depths the reference's own bf16 functions leave the 0.06 bound (random
    # weights amplify each rounding through the layers; on the CPU, reduced
    # widths, its rwkv6 at 32 layers reaches 3.2x the bound, zamba2 at 38
    # 1.6x, mixtral at 8 3x).  The bound holds the f32-compute twin.
    ids = torch.cat([prompts] + fed, dim=1)
    fwd_model = model
    if cfg.num_experts:  # a forward without capacity drops, as the twin's
        fwd_model = build_model(dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k),
                                device=dev)
    full, _ = fwd_model.forward(params, ids)
    bf_scale = max(float(full.abs().max()), 1.0)
    bf_err = max(float((s[:, 0].float() - full[:, t].float()).abs().max())
                 for t, s in zip(range(LM_PROMPT - 1, LM_PROMPT + LM_GEN), [lp] + steps))
    del full, fwd_model
    err, scale, differ = _f32_check(torch, cfg, dev, params, prompts, fed)
    log(f"{what} decode vs forward over {ids.shape[1]} tokens: served bf16 steps max abs err "
        f"{bf_err:.4f} at logit scale {bf_scale:.3f} ({bf_err / (0.06 * bf_scale):.3f} of the bound, "
        f"recorded); f32 compute {float(err.max()):.6f} (prefill {float(err[:, 0].max()):.6f}) at "
        f"scale {scale:.3f} ({float(err.max()) / (0.06 * scale):.5f} of the bound 0.06 x scale)"
        + ("" if differ is None else f"; positions x layers whose experts differ between "
           f"decode's dense dispatch and forward's GShard at capacity "
           f"{cfg.num_experts / cfg.top_k:g}: {differ}"))
    if float(err.max()) >= 0.06 * scale or differ:
        raise AssertionError(f"{what} f32 decode vs forward: {float(err.max())} (scale {scale}), "
                             f"experts differing at {differ} positions")
    facts["decode_vs_forward"] = dict(bf16_err=bf_err, bf16_scale=bf_scale, f32_err=float(err.max()),
                                      f32_scale=scale, experts_differ=differ)

    # check 2: retrieval changes the logits (lambda 0.3 against 0 from the
    # same cache and token)
    _prefill, decode0, _, _ = make_serve_fns(model, cfg=ServeConfig(knn_lambda=0.0), retrieval=probe,
                                          device=dev)
    l0, _ = decode0(params, first["tok"], first["cache"], LM_PROMPT, index)
    mixed = knn_steps[0]
    shift = float((mixed - l0).abs().max())
    log(f"{what} retrieval: first step finite {bool(torch.isfinite(mixed).all())}, "
        f"max |lambda 0.3 - lambda 0| {shift:.4f}")
    if not bool(torch.isfinite(mixed).all()) or shift <= 1e-4:
        raise AssertionError(f"{what} retrieval: finite {bool(torch.isfinite(mixed).all())}, shift {shift}")

    # check 3: the device probe (and, recorded, Coordinator.probe) against
    # brute force
    _, truth = brute_force_topk(X, Q, LM_K, device=dev)
    recalls = {}
    for L in (LM_L, LM_RECALL_L):
        _d, got = make_probe_fn(k=LM_K, L=L, device=dev)(by_row, Q)
        recalls[f"device L={L}"] = _recall(got.cpu().numpy(), truth)
    report = cluster.coordinator.probe("memories", Q, LM_K, strategy="diskann", L=LM_RECALL_L)
    recalls[f"coordinator L={LM_RECALL_L}"] = _recall(_hit_rows(files, report), truth)
    log(f"{what} recall@{LM_K} of {LM_QUERIES} held-out-token queries against brute force over "
        f"{LM_CORPUS:,} vectors at D = {d}: " + ", ".join(f"{k} {v:.4f}" for k, v in recalls.items()))
    facts["recall"] = recalls
    if recalls[f"device L={LM_RECALL_L}"] < 0.90:
        raise AssertionError(f"{what} device recall@{LM_K} at L={LM_RECALL_L} < 0.90: {recalls}")
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    log(f"{what}: {time.time() - t_model:.2f} s; launches {launches}; by shape "
        f"{_build.launch_shapes()}")
    _need(launches, ("rerank_distances", "kmeans_assign"), what)
    facts["launches"] = launches
    return launches, facts


def phase_lm_families(torch, dev, seed: int, workdir: str):
    """12: 11a for the three other decoder families, one after another, each
    model freed before the next: rwkv6-3b (32 layers) and zamba2-1.2b (38
    mamba2 layers, the shared block after each of the six full groups of
    6) whole, mixtral-8x7b at every published width with 8 of its 32
    layers; every kernel call held against its plain version, the held calls
    counted by (op, D).  Returns (launches, facts)."""
    facts: dict = {}
    by_dim: dict = {}
    launches: dict = {}
    tally, restore = _hold_ops_to_plain(torch, by_dim)
    try:
        for arch, layers in FAMILIES:
            got, facts[arch] = _serve_family(torch, dev, seed, workdir, arch, layers)
            _add(launches, got)
            torch.cuda.empty_cache()
    finally:
        restore()
    log(f"phase 12 launches {launches}; held calls by (op, D) {by_dim}")
    log(f"phase 12 held against the plain version: "
        f"{ {k: f'{n} calls, max abs err {e:.3g}' for k, (n, e) in sorted(tally.items())} }")
    for arch, f in facts.items():
        for op in ("exact_distances", "kmeans_assign"):
            if by_dim.get((op, f["d"]), 0) == 0:
                raise AssertionError(f"phase 12 {arch}: no {op} call at D = {f['d']}: {by_dim}")
    return launches, facts


# -- phase 13 ---------------------------------------------------------------------

TRAIN_ARCH = "qwen2.5-3b"  # configs/qwen2_5_3b.py (hf:Qwen/Qwen2.5-3B), its published widths
# 13a: every family's reduced config, f32 compute, the card's step against the CPU's
TRAIN_FAMILIES = ("qwen2.5-3b", "mixtral-8x7b", "rwkv6-3b", "zamba2-1.2b", "musicgen-medium")
# the card's step against the CPU's, of each leaf's scale: 1e-5, but for
# the two recurrent stacks, where two f32 implementations on one CPU (the
# port and the reference, tests/test_torch_train_step.py's oracle at these
# configs: rwkv6 4 layers, zamba2 12, batch 8 x 128) already differ by up to
# 1.0e-5 (rwkv6) and 9.3e-5 (zamba2: the scan's sums of exponentiated decays)
TRAIN_PARITY_TOL = {"rwkv6-3b": 3e-5, "zamba2-1.2b": 3e-4}
TRAIN_PARITY_DEFAULT = 1e-5
# launch/train.py's defaults: batch 8 of 128 tokens, 2 microbatches, lr 1e-3, remat
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_LR = 8, 128, 2, 1e-3
# 13b: 12 steps on the reference test's memorisable pair, the save at step 9
TRAIN_STEPS, TRAIN_SAVE_AT = 12, 9


def _train_cfg():
    from repro_torch.training.train_loop import TrainStepConfig

    return TrainStepConfig(microbatches=TRAIN_MICRO, lr=TRAIN_LR, remat=True)


def _capture_grads(torch):
    """Spies on the train step's ``adamw_update``: returns (list of the
    gradient trees it was handed, each copied to the CPU, restore)."""
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import tree_map

    real = train_loop.adamw_update
    seen: list = []

    def spy(params, grads, state, **kw):
        seen.append(tree_map(lambda g: g.detach().to("cpu", copy=True), grads))
        return real(params, grads, state, **kw)

    train_loop.adamw_update = spy

    def restore():
        train_loop.adamw_update = real
    return seen, restore


def _leaf_err(name, want, got, floor=0.0) -> float:
    """max |got - want| over max(floor, max |want|), on the CPU in f32."""
    want, got = want.float().cpu(), got.float().cpu()
    if want.shape != got.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    scale = max(floor, float(want.abs().max()))
    err = float((got - want).abs().max())
    return err / scale if scale else err


def phase_train_parity(torch, dev, seed: int):
    """13a: one train step (``microbatches=2``, remat, the launcher's batch
    of 8 x 128 tokens) of each family's reduced config at f32 compute on the
    card and on the CPU from the same weights (drawn once on the CPU from
    ``seed`` and copied): loss and grad norm within 1e-5 relative; the
    gradient handed to AdamW and the updated moments within 1e-5 of each
    leaf's scale (max |CPU leaf|; ``v``, a squared gradient, as sqrt(v), in
    a gradient's units; rwkv6 and zamba2 within ``TRAIN_PARITY_TOL``); the
    updated params within 1e-6 of max(1, |p|) of
    the CPU's ``adamw_update`` applied to the same start state and the
    card's gradient (AdamW's eps amplifies a gradient difference near 0,
    so the params are held given the gradient: the chain from the CPU step
    to the reference is ``tests/test_torch_train_step.py``)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import adamw_init, adamw_update, tree_map
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.training.checkpoint import _flatten_with_paths

    tc = _train_cfg()
    facts = {}
    seen, restore = _capture_grads(torch)
    try:
        for arch in TRAIN_FAMILIES:
            t0 = time.time()
            cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
            cpu_model = build_model(cfg, device="cpu")
            card_model = build_model(cfg, device=dev)
            p_cpu = cpu_model.init(torch.Generator().manual_seed(seed))
            o_cpu = adamw_init(p_cpu)
            start = tree_map(torch.clone, {"params": p_cpu, "opt": o_cpu})
            p_card = tree_map(lambda t: t.to(dev, copy=True), p_cpu)
            o_card = adamw_init(p_card)
            ids, labels = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                          batch_size=TRAIN_BATCH, num_codebooks=cfg.num_codebooks,
                                          seed=seed).batch(0)
            seen.clear()
            p_card, o_card, m_card = make_train_step(card_model, None, cfg=tc, device=dev)[0](
                p_card, o_card, ids, labels)
            torch.cuda.synchronize()
            p_cpu, o_cpu, m_cpu = make_train_step(cpu_model, None, cfg=tc, device="cpu")[0](
                p_cpu, o_cpu, ids, labels)
            g_card, g_cpu = seen
            given_p, given_o, _ = adamw_update(
                start["params"], g_card, start["opt"], lr=tc.lr, weight_decay=tc.weight_decay,
                clip_norm=tc.clip_norm)
            err = {k: abs(float(m_card[k]) - float(m_cpu[k])) / max(1.0, abs(float(m_cpu[k])))
                   for k in ("loss", "grad_norm")}
            sqrt = lambda tree: tree_map(torch.sqrt, tree)  # noqa: E731
            tol = TRAIN_PARITY_TOL.get(arch, TRAIN_PARITY_DEFAULT)
            for what, want, got, floor, bound in (
                    ("grad", g_cpu, g_card, 0.0, tol),
                    ("m", o_cpu.m, o_card.m, 0.0, tol),
                    ("sqrt v", sqrt(o_cpu.v), sqrt(o_card.v), 0.0, tol),
                    ("params given the gradient", given_p, p_card, 1.0, 1e-6),
                    ("m given the gradient", given_o.m, o_card.m, 0.0, TRAIN_PARITY_DEFAULT),
                    ("sqrt v given the gradient", sqrt(given_o.v), sqrt(o_card.v), 0.0,
                     TRAIN_PARITY_DEFAULT)):
                errs = {name: _leaf_err(name, w, g, floor) for (name, w), (_n, g) in
                        zip(_flatten_with_paths(want), _flatten_with_paths(got))}
                worst = max(errs, key=errs.get)
                err[what] = (worst, errs[worst])
                if errs[worst] > bound:
                    raise AssertionError(f"phase 13a {arch}: {what} {worst} off by {errs[worst]:.3g} "
                                         f"of its scale (bound {bound})")
            if max(err["loss"], err["grad_norm"]) > TRAIN_PARITY_DEFAULT:
                raise AssertionError(f"phase 13a {arch}: loss / grad norm {err}")
            facts[arch] = dict(loss=float(m_card["loss"]), grad_norm=float(m_card["grad_norm"]),
                               err=err, seconds=time.time() - t0)
            log(f"phase 13a {arch} (reduced, f32): card loss {float(m_card['loss']):.6f} "
                f"(CPU {float(m_cpu['loss']):.6f}), grad norm {float(m_card['grad_norm']):.6f}; "
                f"worst leaf by link { {k: (v if isinstance(v, float) else f'{v[0]} {v[1]:.3g}') for k, v in err.items()} } "
                f"in {time.time() - t0:.2f} s")
            del p_card, o_card, start
            torch.cuda.empty_cache()
    finally:
        restore()
    return facts


def _bit_sums(torch, tree) -> dict:
    """Per leaf, the int64 sums of its int32 bit view over 64 chunks
    (on the device; a changed bit changes its chunk's sum)."""
    from repro_torch.training.checkpoint import _flatten_with_paths

    out = {}
    for name, t in _flatten_with_paths(tree):
        bits = t.detach().reshape(-1).view(torch.int32)
        out[name] = torch.stack([c.to(torch.int64).sum() for c in bits.chunk(64)]).cpu()
    return out


def phase_train_full(torch, dev, seed: int, workdir: str, smi: str):
    """13b: qwen2.5-3b at its published widths (no cut), f32 masters, bf16
    compute, the launcher's defaults: 12 steps on
    ``SyntheticTokens(seed=7).batch(i % 2)`` (the reference test's
    memorisable pair) with the loss falling by more than 0.5; an async save
    at step 9 through the catalog, steps 10-11, the state dropped; the
    restore (latest step 9, every leaf's bits checked by chunked sums taken
    on the card) and step 10 again, its loss within 1e-4 of the first
    run's.  Returns (launches, facts)."""
    import shutil as _shutil

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.iceberg.catalog import RestCatalog
    from repro_torch.kernels import _build
    from repro_torch.lakehouse.objectstore import ObjectStore
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import check_fits
    from repro_torch.models.model import build_model
    from repro_torch.models.sharding import DEFAULT_RULES, local_tree
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.train_loop import init_train_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device=dev)
    state_bytes = check_fits(model, dev)
    n = model.param_count()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flop_ms = 6 * n * tokens / PEAK_BF16 * 1e3
    opt_bytes = 28 * n  # AdamW reads p, g, m, v and writes p, m, v, f32
    opt_ms = opt_bytes / PEAK_BYTES * 1e3
    log(f"phase 13b {TRAIN_ARCH}: {n:,} params, {state_bytes / 1e9:.2f} GB of training state; "
        f"bounds: 6 N x {tokens} tokens at {PEAK_BF16 / 1e12:.0f} TFLOP/s = {flop_ms:.1f} ms, the "
        f"optimizer's {opt_bytes / 1e9:.1f} GB at {PEAK_BYTES / 1e12:.2f} TB/s = {opt_ms:.1f} ms; "
        f"device memory in use before the phase {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params, opt = init_train_state(model, seed=seed)
    step, _ = make_train_step(model, None, cfg=_train_cfg(), device=dev)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=7)
    warehouse = tempfile.mkdtemp(prefix="ckpt_", dir=workdir)
    free = _shutil.disk_usage(warehouse).free
    need = 12 * n  # the checkpoint: f32 params, m and v
    if free < 1.05 * need:
        raise AssertionError(f"phase 13b: {free / 1e9:.1f} GB free under {warehouse}, the checkpoint "
                             f"needs {need / 1e9:.1f} GB")
    store = ObjectStore(warehouse)
    mgr = CheckpointManager(RestCatalog(store), async_save=True)
    # the save's parts: the leaves' puts (serialised, hashed, written) and
    # the commit, on the save's thread
    put, commit = store.put, mgr.catalog.commit_with_retries
    io_log = {"put_s": 0.0, "bytes": 0, "commit_s": 0.0, "end": None}

    def timed_put(key, data, **kw):
        t = time.perf_counter()
        out = put(key, data, **kw)
        if "/data/" in key:
            io_log["put_s"] += time.perf_counter() - t
            io_log["bytes"] += len(data)
        return out

    def timed_commit(*a, **kw):
        t = time.perf_counter()
        out = commit(*a, **kw)
        io_log["commit_s"] += time.perf_counter() - t
        io_log["end"] = time.perf_counter()
        return out

    store.put, mgr.catalog.commit_with_retries = timed_put, timed_commit
    losses, step_ms = [], []
    try:
        for i in range(TRAIN_STEPS):
            ids, labels = data.batch(i % 2)
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, m = step(params, opt, ids, labels)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
            if i == TRAIN_SAVE_AT:
                state = {"params": params, "opt": opt}
                sums = _bit_sums(torch, state)
                t_save = time.perf_counter()
                mgr.save(i, state, metrics={"loss": m["loss"]})
                save_return = time.perf_counter()
                del state
        peak = torch.cuda.max_memory_allocated()
        t = time.perf_counter()
        mgr.wait()
        wait_s = time.perf_counter() - t
        # one more step under the profiler: device events and busy time
        extra = data.batch(TRAIN_STEPS % 2)
        per_step, busy = decode_profile(torch, lambda _i: step(params, opt, *extra), n_steps=1)
        del params, opt, m
        torch.cuda.empty_cache()
        held_after_drop = torch.cuda.memory_allocated()
        # 14b: the resume runs on a one-rank mesh, into the state placed by
        # init_train_state's shardings, through the mesh form of the step
        t14 = time.perf_counter()
        mesh = make_debug_mesh(1, 1, device=dev)
        step_mesh, _sh = make_train_step(model, mesh, DEFAULT_RULES, cfg=_train_cfg(), device=dev)
        like = dict(zip(("params", "opt"), init_train_state(model, mesh, DEFAULT_RULES, seed=seed)))
        placements = {str(p) for t in (like["params"]["embed"], like["opt"].m["embed"])
                      for p in t.placements}
        t = time.perf_counter()
        latest = mgr.latest_step()
        restored, at = mgr.restore(like)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        got = _bit_sums(torch, local_tree(restored))
        differ = [k for k in sums if not torch.equal(sums[k], got[k])]
        ids, labels = data.batch((TRAIN_SAVE_AT + 1) % 2)
        _p, _o, m10 = step_mesh(restored["params"], restored["opt"], ids, labels)
        resumed_loss = float(m10["loss"])
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t14
        del restored, like, _p, _o
    finally:
        store.put, mgr.catalog.commit_with_retries = put, commit
        _shutil.rmtree(warehouse, ignore_errors=True)
    launches = _build.launch_counts()
    torch.cuda.empty_cache()
    med = float(np.median(step_ms[2:]))
    save = dict(host_copy_s=save_return - t_save, put_s=io_log["put_s"], commit_s=io_log["commit_s"],
                thread_s=io_log["end"] - save_return, wait_s=wait_s, bytes=io_log["bytes"],
                free_bytes=free)
    facts = dict(params=n, losses=losses, step_ms=step_ms, median_ms=med, tok_s=tokens / med * 1e3,
                 flop_bound_ms=flop_ms, opt_bound_ms=opt_ms, events_step=per_step, busy_ms=busy,
                 peak_gb=peak / 1e9, init_s=init_s, save=save, restore_s=restore_s,
                 latest=latest, resumed_loss=resumed_loss, mesh_resume_s=mesh_s)
    log(f"phase 13b [{smi}] losses {[round(x, 4) for x in losses]}; step ms {[round(x, 1) for x in step_ms]}")
    log(f"phase 13b step {med:.2f} ms (median of steps 2-{TRAIN_STEPS - 1}), {tokens / med * 1e3:.1f} tok/s; "
        f"bounds {flop_ms:.1f} ms (FLOPs) and {opt_ms:.1f} ms (optimizer bytes); "
        + ("no device events in the trace: device busy not measured" if busy is None else
           f"{per_step:.0f} device events a step, device busy {busy:.2f} ms (idle share "
           f"{1 - busy / med:.3f} of the median step)")
        + f"; peak {peak / 1e9:.2f} GB; init {init_s:.2f} s")
    log(f"phase 13b save at step {TRAIN_SAVE_AT}: {io_log['bytes'] / 1e9:.3f} GB to {warehouse} "
        f"({free / 1e9:.1f} GB free before); host copy {save['host_copy_s']:.2f} s, then on its thread "
        f"{save['thread_s']:.2f} s (puts {save['put_s']:.2f} s, commit {save['commit_s']:.3f} s), the "
        f"wait after step {TRAIN_STEPS - 1} {wait_s:.2f} s; device memory after the drop "
        f"{held_after_drop / 1e9:.2f} GB; restore {restore_s:.2f} s (latest step {latest}); "
        f"leaves with other bits {differ}; launches {launches}")
    log(f"phase 14b resume on a one-rank mesh (placements {sorted(placements)}): init_train_state's "
        f"placed state restored in {restore_s:.2f} s, step {TRAIN_SAVE_AT + 1} through the mesh step: "
        f"loss {resumed_loss!r} (first run {losses[TRAIN_SAVE_AT + 1]!r}, bit for bit: "
        f"{resumed_loss == losses[TRAIN_SAVE_AT + 1]}); {mesh_s:.2f} s with the mesh, the state's "
        f"init and the restore")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] - 0.5:
        raise AssertionError(f"phase 13b: the loss did not fall by 0.5: {losses}")
    if latest != TRAIN_SAVE_AT or at != TRAIN_SAVE_AT or differ:
        raise AssertionError(f"phase 13b: restored step {latest}/{at}, leaves differing {differ}")
    if resumed_loss != losses[TRAIN_SAVE_AT + 1]:
        raise AssertionError(f"phase 14b: resumed step {TRAIN_SAVE_AT + 1} loss {resumed_loss!r} on "
                             f"the mesh != the first run's {losses[TRAIN_SAVE_AT + 1]!r}")
    if any(launches.values()):
        raise AssertionError(f"phase 13b: the training path launched ANN kernels {launches}")
    return launches, facts


def phase_train_example(torch):
    """13c (1): ``examples/torch_train_checkpointed.py`` in-process through
    ``main("cuda")``: resumed at the committed step 15 (steps 5, 10, 15
    kept), the steps run before the crash and after the resume with the
    same losses, the loss falling."""
    import contextlib
    import io

    from repro_torch.kernels import _build

    buf = io.StringIO()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        facts = _example("train_checkpointed").main("cuda")
    torch.cuda.synchronize()
    secs = time.time() - t0
    launches = _build.launch_counts()
    for line in buf.getvalue().splitlines():
        log(f"  | {line}")
    again = {i: (facts["losses"][i], facts["resumed_losses"][i]) for i in (16, 17)}
    log(f"phase 13c train_checkpointed: {secs:.2f} s; resumed at {facts['resumed_at']} of "
        f"{facts['available']}; losses before / after the resume {again}; final {facts['final_loss']:.4f}; "
        f"launches {launches}")
    if facts["resumed_at"] != 15 or facts["available"] != [5, 10, 15]:
        raise AssertionError(f"train_checkpointed: resumed at {facts['resumed_at']}, {facts['available']}")
    if any(abs(a - b) > 1e-4 for a, b in again.values()) or not facts["final_loss"] < facts["losses"][0] - 2:
        raise AssertionError(f"train_checkpointed: losses {facts}")
    if any(launches.values()):
        raise AssertionError(f"train_checkpointed launched ANN kernels {launches}")
    facts["seconds"] = secs
    return launches


def train_launcher_jobs(workdir: str):
    warehouse = tempfile.mkdtemp(prefix="train_launcher_", dir=workdir)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--steps", "12",
           "--ckpt-every", "5", "--warehouse", warehouse]
    return [(f"train_launcher_{run}", cmd, str(HERE), _src_env()) for run in (1, 2)]


def phase_train_launcher(beside):
    """13c (2): ``python -m repro_torch.launch.train --arch qwen2.5-3b --steps
    12 --ckpt-every 5 --warehouse DIR`` as a process, twice on one
    warehouse (run beside phase 3): both exit 0 and the second prints
    "resumed from committed step 10"."""
    out = []
    for run in (1, 2):
        rc, stdout, err, secs = beside.result(f"train_launcher_{run}")
        log(f"phase 13c -m repro_torch.launch.train --arch {TRAIN_ARCH} --steps ... run {run} (beside "
            f"phase 3): rc {rc} in {secs:.2f} s; {stdout.strip().splitlines()}")
        if rc != 0:
            raise AssertionError(f"train launcher run {run}: rc {rc}, stderr {err[-2000:]}")
        out.append((secs, stdout))
    if "resumed from committed step 10" not in out[1][1]:
        raise AssertionError(f"train launcher did not resume: {out[1][1]}")
    return dict(seconds=[s for s, _ in out])


# -- phase 14 ---------------------------------------------------------------------

PROBE_SHARD_REPS = 5  # timed probes of 14c's shard, after one untimed


def phase_mesh_serving(torch, dev, keep: dict, smi: str):
    """14a: 11a's two serving runs again on a one-rank mesh (``SERVE_RULES``,
    the mesh probe fused): every logit bit for bit 11a's.  Returns facts."""
    from repro_torch.analysis.roofline import compute_roofline
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import SERVE_RULES
    from repro_torch.models.model import cache_shapes
    from repro_torch.serving.device_index import make_probe_fn
    from repro_torch.serving.serve_loop import make_serve_fns

    model, params, prompts, index = keep["model"], keep["params"], keep["prompts"], keep["index"]
    t_phase = time.time()
    mesh = make_debug_mesh(1, 1, device=dev)
    probe = make_probe_fn(mesh, k=LM_K, L=LM_L, device=dev)
    by_dim: dict = {}
    tally, restore = _hold_ops_to_plain(torch, by_dim)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    try:
        # warm-up, untimed: DTensor's sharding propagation for each op, the
        # placed index's beam runners
        prefill_w, decode_w, sample_w, _ = make_serve_fns(
            model, mesh, SERVE_RULES, batch_hint=LM_BATCH, max_len_hint=LM_PROMPT + LM_GEN,
            device=dev)
        cache = model.init_cache(LM_BATCH, LM_PROMPT + LM_GEN)
        logits, cache = prefill_w(params, prompts, cache)
        for t in range(LM_PROMPT, LM_PROMPT + 2):
            logits, cache = decode_w(params, sample_w(logits), cache, t)
        probe(index, torch.zeros((LM_BATCH, model.cfg.d_model), device=dev))
        placements = sorted({str(p) for leaf in (cache["k"], logits) for p in leaf.placements})
        del prefill_w, decode_w, sample_w, cache, logits
        runs = {"plain": _serve(torch, model, params, prompts, mesh=mesh),
                "knn": _serve(torch, model, params, prompts, probe, index, mesh=mesh)}
    finally:
        restore()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    differ = {}
    for what, (times, lp, steps, _fed, _first) in runs.items():
        want_lp, want_steps = keep["logits"][what]
        differ[what] = [i for i, (a, b) in enumerate(zip([lp] + steps, [want_lp] + want_steps))
                        if not torch.equal(a, b)]
    cfg = model.cfg
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in cache_shapes(model, LM_BATCH, LM_PROMPT + LM_GEN).values())
    flops = 2.0 * model.param_count() * LM_BATCH
    terms = compute_roofline(arch=cfg.name, shape="decode", mesh="1x1", chips=1, hlo_flops_raw=flops,
                             hlo_bytes_raw=0.0, jaxpr_flops=flops,
                             model_bytes=keep["param_bytes"] + cache_bytes, coll_bytes_raw=0.0,
                             coll_bytes=0.0, model_flops=flops)
    bound_ms = max(terms.t_compute, terms.t_memory) * 1e3
    for what in runs:
        mesh_t, plain_t = runs[what][0], keep["times"][what]
        log(f"phase 14a {what:5s} [{smi}]: prefill {mesh_t['prefill_ms']:.2f} ms (11a "
            f"{plain_t['prefill_ms']:.2f}); decode {mesh_t['decode_ms_step']:.3f} ms/step on the mesh, "
            f"{plain_t['decode_ms_step']:.3f} in 11a; the step's roofline bound {bound_ms:.3f} ms "
            f"({terms.bottleneck}: t_memory {terms.t_memory * 1e3:.3f} ms for the bf16 weights and the "
            f"cache, t_compute {terms.t_compute * 1e3:.4f} ms)")
    log(f"phase 14a: placements {placements}; logits differing from 11a (prefill = 0, step t = t + 1): "
        f"{differ}; {time.time() - t_phase:.2f} s; launches {launches}; held calls "
        f"{ {k: n for k, (n, _e) in tally.items()} }")
    if any(differ.values()):
        raise AssertionError(f"phase 14a: the mesh's logits differ from 11a's: {differ}")
    return dict(seconds=time.time() - t_phase, bound_ms=bound_ms,
                decode_ms_step={k: v[0]["decode_ms_step"] for k, v in runs.items()})


def _start_dry_run(args, out: str):
    """One dry-run launcher started as a process of its own (its fake group
    cannot share this process with the card's; it uses no card, so it runs
    beside the phases that do): ``(command, process, start, out)``."""
    import os

    cmd = [sys.executable, "-m", *args, "--out", out]
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"), OMP_NUM_THREADS="1")
    with open(out + ".log", "w") as logf:  # the child keeps its own descriptor
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT, cwd=str(HERE), env=env)
    return cmd, proc, time.time(), out


def _dry_run_rows(started, timeout: int = 300) -> list:
    """The rows of a dry-run process of :func:`_start_dry_run`, once it has
    exited 0."""
    cmd, proc, t0, out = started
    rc = proc.wait(timeout=timeout)
    log(f"phase 14 {' '.join(cmd[2:-2])}: rc {rc}, collected {time.time() - t0:.2f} s after its start "
        f"before phase 3")
    if rc != 0:
        with open(out + ".log") as f:
            raise AssertionError(f"{' '.join(cmd[2:])}: rc {rc}, output {f.read()[-3000:]}")
    with open(out) as f:
        return [json.loads(line) for line in f]


# 14d's cells, single-pod mesh: LM_ARCH's decode and prefill, the
# recurrent families' decode and dbrx-132b's train step held to their bounds
DRY_RUN_CELLS = (
    (LM_ARCH, "decode_32k"), (LM_ARCH, "prefill_32k"),
    ("rwkv6-3b", "decode_32k"), ("zamba2-1.2b", "decode_32k"), ("dbrx-132b", "train_4k"),
)
# the reference's global collective bytes on the same (16, 16) mesh
# (``python -m repro.launch.dryrun``, jax 0.9.0 on the CPU), the bottleneck a
# row must share with it (None: recorded only) and the ops at which it may
# issue no collective: a row moves at most 1.5x the reference's bytes,
# all-reduce its largest kind, nothing where the batch-only scan and the
# cache copy gathered, nor where the MoE block's expert bmm moved its
# activations (PERF.md section 2)
DRY_RUN_GATHER_OPS = ("select.int", "slice.Tensor", "copy_.default")
DRY_RUN_REFERENCE = {
    ("rwkv6-3b", "decode_32k"): (4.33e7, "memory", DRY_RUN_GATHER_OPS),
    ("zamba2-1.2b", "decode_32k"): (5.35e7, "memory", DRY_RUN_GATHER_OPS),
    ("dbrx-132b", "train_4k"): (3.300e13, None, ("bmm.default",)),
}


def start_dry_runs(workdir: str) -> dict:
    """14c's and 14d's dry-run processes, started together."""
    runs = {"probe": _start_dry_run(["repro_torch.launch.probe_dryrun"],
                                    str(Path(workdir) / "probe_dryrun.jsonl"))}
    for arch, shape in DRY_RUN_CELLS:
        runs[(arch, shape)] = _start_dry_run(
            ["repro_torch.launch.dryrun", "--arch", arch, "--shape", shape, "--mesh", "single"],
            str(Path(workdir) / f"dryrun_{arch}_{shape}.jsonl"))
    return runs


def phase_probe_share(torch, dev, seed: int, dry_runs: dict, smi: str):
    """14c: the paper's 10^9-vector probe dry-run as a process, then one
    device's share of its single-pod row allocated and probed on the card."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn

    t_phase = time.time()
    rows = {r["mesh"]: r for r in _dry_run_rows(dry_runs["probe"])}
    if sorted(rows) != ["multi", "single"]:
        raise AssertionError(f"probe_dryrun rows: {sorted(rows)}")
    for name, r in rows.items():
        rf = r["roofline"]
        log(f"phase 14c probe_dryrun {name} ({r['chips']} devices, {rf['devices_dividing']} holding "
            f"distinct shards): index {r['index']}; per probe step and device t_compute (f32 peak) "
            f"{rf['t_compute']:.3e} s, t_memory {rf['t_memory']:.3e} s, t_collective "
            f"{rf['t_collective']:.3e} s, bottleneck {rf['bottleneck']}; collectives "
            f"{r['collectives']['by_kind']}")
    row = rows["single"]
    ix = row["index"]
    cap, D, R, K, L, Q = ix["cap"], ix["D"], ix["R"], ix["K"], ix["L"], ix["Q"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(seed)
    index = DeviceAnnIndex(
        vectors=torch.randn((1, cap, D), generator=gen, device=dev, dtype=torch.bfloat16),
        # a random graph of R out-neighbours a node, uniform over the shard
        adjacency=torch.randint(0, cap, (1, cap, R), generator=gen, device=dev, dtype=torch.int64),
        medoids=torch.zeros((1,), dtype=torch.int64, device=dev),
        counts=torch.full((1,), cap, dtype=torch.int64, device=dev),
        payload=torch.arange(cap, dtype=torch.int64, device=dev)[None],
    )
    queries = torch.randn((Q, D), generator=gen, device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    mesh = make_debug_mesh(1, 1, device=dev)
    probe = make_probe_fn(mesh, k=K, L=L, metric="l2", oversample=ix["oversample"],
                          shard_axes=("data", "model"), device=dev)
    times, temps = [], []
    for rep in range(PROBE_SHARD_REPS + 1):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        d, p = probe(index, queries)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        temps.append(torch.cuda.max_memory_allocated() - before)
    d, p = d.to_local(), p.to_local()
    ok = (tuple(d.shape) == (Q, K) and bool(torch.isfinite(d).all())
          and bool((d[:, 1:] >= d[:, :-1]).all()) and bool(((p >= 0) & (p < cap)).all()))
    step_ms = float(np.median(times[1:]))
    rf = row["roofline"]
    f32_copy = 4 * cap * D
    log(f"phase 14c one device's share [{smi}]: {cap:,} x {D} bf16 vectors, {cap:,} x {R} int64 "
        f"adjacency, int64 payload: {held / 1e9:.3f} GB held on the card (torch.cuda.memory_allocated), "
        f"the dry-run row's hbm_per_chip_gb {ix['hbm_per_chip_gb']}")
    log(f"phase 14c probe of {Q} queries, k {K}, L {L}, oversample {ix['oversample']}: "
        f"{step_ms:.3f} ms (median of {PROBE_SHARD_REPS}; first call {times[0]:.1f} ms with the beam's "
        f"graph capture) against the row's per-device t_memory {rf['t_memory'] * 1e3:.4f} ms and "
        f"t_compute {rf['t_compute'] * 1e3:.5f} ms; peak above its arguments {max(temps[1:]) / 1e6:.2f} MB "
        f"(first call {temps[0] / 1e6:.2f} MB; a whole-shard f32 cast would be {f32_copy / 1e9:.1f} GB); "
        f"answers of shape {tuple(d.shape)}, finite, ascending, payloads in range: {ok}; recall not "
        f"measured: the graph is random")
    if not ok:
        raise AssertionError(f"phase 14c: the shard's probe answers are malformed: {d.shape}, {p.shape}")
    if max(temps) >= f32_copy / 2:
        raise AssertionError(f"phase 14c: the probe's peak {max(temps)} bytes is an f32 copy of the shard")
    del index, queries, d, p
    torch.cuda.empty_cache()
    return dict(seconds=time.time() - t_phase, held_gb=held / 1e9, probe_ms=step_ms,
                temp_mb=max(temps[1:]) / 1e6, row=row)


def phase_lm_dry_runs(dry_runs: dict):
    """14d: the LM dry-runs of qwen2.5-3b's decode_32k and prefill_32k cells,
    rwkv6-3b's and zamba2-1.2b's decode_32k and dbrx-132b's train_4k on the
    single-pod mesh, each as a process; the recurrent and MoE rows held to
    the reference's bytes (:data:`DRY_RUN_REFERENCE`)."""
    t_phase = time.time()
    rows = []
    for arch, shape in DRY_RUN_CELLS:
        got = _dry_run_rows(dry_runs[(arch, shape)])
        if len(got) != 1 or got[0]["kind"] in ("error", "skip"):
            raise AssertionError(f"dryrun {arch} {shape}: {got}")
        r = got[0]
        rf, co = r["roofline"], r["collectives"]
        held = ""
        if (arch, shape) in DRY_RUN_REFERENCE:
            ref, bottleneck, ops = DRY_RUN_REFERENCE[(arch, shape)]
            by_kind = co["by_kind"]
            gathered = {op: co["by_op"][op] for op in ops if op in co["by_op"]}
            held = (f"; {co['global_bytes'] / ref:.3f}x the reference's {ref:.4e} B (bound 1.5), "
                    f"collectives at {ops}: {gathered}")
            if (co["global_bytes"] > 1.5 * ref or max(by_kind, key=by_kind.get) != "all-reduce"
                    or gathered or bottleneck not in (None, rf["bottleneck"])):
                raise AssertionError(f"phase 14d: {arch} {shape}'s row leaves its bounds: "
                                     f"{co['global_bytes']} B, {by_kind}, {gathered}, {rf['bottleneck']}")
        log(f"phase 14d dryrun {arch} {shape} single ({r['chips']} devices, traced at depths "
            f"{r['traced_depths']} in {r['lower_s']} s): jaxpr_flops (traced) {rf['jaxpr_flops']:.4e} "
            f"(matmuls {r['cost_analysis']['dot_flops']:.4e}), model_flops {rf['model_flops']:.4e}, "
            f"useful_ratio {rf['useful_ratio']:.4f}; collectives {co['global_bytes']:.4e} B global "
            f"({co['by_kind']}); args {r['memory_analysis']['argument_bytes'] / 1e9:.3f} GB a device; "
            f"t_compute {rf['t_compute']:.3e} s, t_memory {rf['t_memory']:.3e} s, t_collective "
            f"{rf['t_collective']:.3e} s: bottleneck {rf['bottleneck']}{held}")
        rows.append(r)
    return dict(seconds=time.time() - t_phase, rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="base vectors (SIFT1M: 1,000,000)")
    ap.add_argument("--queries", type=int, default=2_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--filtered-calls", type=int, default=2,
                    help="probe calls of 100 queries per filtered row (phases 4, 5, 7 and 8)")
    ap.add_argument("--small-n", type=int, default=131_072,
                    help="rows of the small-shard catalog of phase 6")
    ap.add_argument("--parent", metavar="DIR",
                    help="after phase 2, hold masked_topk.cu, rerank.cu, kmeans_assign.cu and "
                         "pq_scan.cu of the checkout DIR (an earlier commit's tree) against this "
                         "one's: equal bits (bf16: the plain version's tolerance), times in turns; "
                         "without --only-kernels, also every "
                         "gather_rerank, kmeans_assign, rerank_distances, int8 exact, masked ADC "
                         "and unified call of phases 3-9, bit for bit")
    ap.add_argument("--only-kernels", action="store_true",
                    help="stop after phase 2 (and --parent), without the result lines")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this smoke test runs only on a card")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()
    phase_s = {}

    def timed(name, fn, *a):
        t0 = time.time()
        out = fn(*a)
        phase_s[name] = time.time() - t0
        return out

    smi = timed("1 environment + build", phase_environment, torch)
    rows = timed("2 kernels", phase_kernels, torch, dev, args.n // 4, args.seed)
    rows.update(timed("2 masked kernels", phase_masked_kernels, torch, dev, args.n // 4, args.seed))
    rows.update(timed("2 quantized scans + pq_scan", phase_quant_kernels, torch, dev, args.n // 4,
                      args.seed))
    timed("2b autotune", phase_autotune, torch, dev, args.n // 4, args.seed)
    shadow = None
    if args.parent:
        old_libs = timed("2 parent vs change", phase_parent, torch, dev, args.n // 4, args.seed, args.parent)
        if not args.only_kernels:
            shadow = _shadow_main_path(torch, old_libs)
    if args.only_kernels:
        log(f"phase seconds: { {k: round(v, 2) for k, v in phase_s.items()} }")
        log("--only-kernels: phases 1-2 passed; the main path did not run")
        return 0
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    dry_runs, beside = {}, None
    try:
        dry_runs = start_dry_runs(workdir)
        beside = Beside([lm_launcher_job(), *train_launcher_jobs(workdir), fault_demo_job()])
        launches, main, ctx = timed(
            "3 main path", phase_main_path, torch, args.n, args.queries, args.seed, workdir
        )
        per_phase = {"3": dict(launches)}
        got, _stats, preds = timed("4 filtered", phase_filtered, torch, ctx, args.filtered_calls)
        per_phase["4"] = got
        got, _stats = timed("5 fresh tail", phase_tail, torch, ctx, args.filtered_calls, preds)
        per_phase["5"] = got
        got, _stats = timed("6 small shards", phase_small_shards, torch, ctx, args.small_n, args.seed)
        per_phase["6"] = got
        got, _stats = timed("7 quantized", phase_quantized, torch, ctx, args.filtered_calls)
        per_phase["7"] = got
        got, _stats = timed("8 refresh", phase_refresh, torch, ctx, args.filtered_calls)
        per_phase["8"] = got
        timed("9a device probe", phase_device_probe, torch, ctx)
        got, _stats = timed("9b-e serving tier", phase_serving, torch, ctx, args.seed)
        per_phase["9"] = got
        got, _stats = timed("10 examples", phase_examples, torch, beside)
        per_phase["10"] = got
        got, facts11 = timed("11a LM serving", phase_lm_serving, torch, dev, args.seed, workdir)
        per_phase["11a"] = got
        timed("14a mesh serving", phase_mesh_serving, torch, dev, facts11.pop("for_14a"), smi)
        del facts11
        torch.cuda.empty_cache()
        got, _facts = timed("11b serve_retrieval example", phase_lm_example, torch)
        per_phase["11b"] = got
        timed("11c serve launcher", phase_lm_launcher, beside)
        got, _facts = timed("12 LM families", phase_lm_families, torch, dev, args.seed, workdir)
        per_phase["12"] = got
        del ctx  # phases 3-9's deployment: the card's memory goes to phase 13b
        torch.cuda.empty_cache()
        timed("13a train parity", phase_train_parity, torch, dev, args.seed)
        per_phase["13c"] = timed("13c train example", phase_train_example, torch)
        timed("13c train launcher", phase_train_launcher, beside)
        got, _facts = timed("13b train qwen2.5-3b", phase_train_full, torch, dev, args.seed, workdir, smi)
        per_phase["13b"] = got
        timed("14c probe share", phase_probe_share, torch, dev, args.seed, dry_runs, smi)
        timed("14d LM dry-runs", phase_lm_dry_runs, dry_runs)
    finally:
        if beside is not None:
            beside.stop()
        for _cmd, proc, _t0, _out in dry_runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(workdir, ignore_errors=True)
        from repro_torch.launch.mesh import destroy

        destroy()  # the one-rank group of phase 14
    launches = {k: sum(p.get(k, 0) for p in per_phase.values()) for k in KERNELS}
    if shadow is not None:
        log(f"parent vs change on phases 3-9, every call also run on the parent's build: "
            f"{ {name: f'{n} calls, {bad} with other bits' for name, (n, bad) in shadow.items()} }")
        if sorted(shadow) != list(SHADOWED) or any(
                bad for _n, bad in shadow.values()):
            raise AssertionError(f"--parent: the main path's outputs differ from the parent's build: {shadow}")
    log(f"launches by phase: {per_phase}")
    log("launches by phase and shape (kmeans_assign by (D, K), gather_rerank by (P, k), "
        "rerank_distances by tile): "
        + "; ".join(f"phase {ph}: {by_kernel}" for ph, by_kernel in sorted(SHAPES.items())))
    log(f"phase seconds: { {k: round(v, 2) for k, v in phase_s.items()} }")
    for name, checked in CHECKED.items():
        missing = sorted(set(_shape_totals(name)) - checked)
        if missing:
            raise AssertionError(f"{name} ran at {missing} on phases 3-9: shapes phase 2 did not check")
    for name, count in launches.items():
        # pq_scan has no production caller (in either package): phase 2 holds it
        if count == 0 and name not in PHASE2_ONLY:
            raise AssertionError(f"kernel {name} was not launched on phases 3-12")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
            **{key: r[key] for key in DEVICE_KEYS},
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
        })
        if "pass_ms" in r:
            kernels[-1]["pass_ms"] = r["pass_ms"]
        if "at_shapes" in r:
            # the same kernel timed at the shapes the main path gives it
            kernels[-1]["at_shapes"] = r["at_shapes"]
        if "shapes" in r:
            by_shape = _shape_totals(name)
            kernels[-1]["shapes"] = [
                {key: v for key, v in sr.items() if key != "launch_shape"}
                | {"launches": by_shape.get(sr["launch_shape"], 0)}
                for sr in r["shapes"]
            ]
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
