"""One run of one cell: set-up, the measured window, the check, the result.

``Session`` does the set-up (the kernels, the warehouse, the cluster) and
``Session.warm`` the warm-up; ``Session.window`` measures; ``Session.judge`` compares
what the window answered with the reference.  ``run`` strings them together
for ``run.py``; ``control.py`` calls them for several seeds in one process.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from harness import check, data, serve, spec, trace, warehouse


@dataclass
class Obs:
    """What a run observed, for the per-layer metrics' readers."""

    traffic: dict
    window: Optional[serve.Window] = None
    batch_stats: object = None  # the batcher's MicroBatchStats
    recorder: Optional[trace.Recorder] = None
    profile: Optional[trace.Profile] = None


@dataclass
class Reading:
    """A window's readings: the metrics, and what the check needs."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    obs: Obs
    answers: list = field(default_factory=list)
    queries: Optional[np.ndarray] = None


def _reference():
    import importlib

    return importlib.import_module("configs.reference")


class Session:
    """An opened cell: the program set up and warm, ready for windows."""

    def __init__(self, cell: spec.Cell, device: str, log, cache: Path = warehouse.CACHE) -> None:
        import torch

        from repro_torch.kernels import _build

        self.cell, self.cfg, self.traffic = cell, cell.config, cell.traffic
        self.device, self.log = device, log
        self.torch = torch
        self.phases: Dict[str, float] = {}  # set-up's parts, seconds
        t = time.perf_counter()
        if device == "cuda":
            torch.cuda.init()
            _build.build_all()  # compiled once a checkout (build/), loaded here
        self.phases["kernels"] = time.perf_counter() - t
        t = time.perf_counter()
        self.wh = warehouse.open_or_build(self.cfg, cell.config_path, device, log, cache)
        self.phases["warehouse"] = time.perf_counter() - t
        self.k = self.cfg["k"]
        t = time.perf_counter()
        self._open()
        self.phases["cluster"] = time.perf_counter() - t

    def _open(self) -> None:
        from repro_torch.runtime.cluster import make_local_cluster

        self.cluster = make_local_cluster(str(self.wh.root), num_executors=self.cfg["executors"],
                                          device=self.device)
        self.mb = serve.batcher(self.cluster.coordinator, warehouse.TABLE, self.traffic).start()

    def warm(self, seed: int) -> None:
        """The cell's own shapes, once: one batch of the traffic's mix at its
        batch size (the beam runners are captured, the shards decoded and
        uploaded)."""
        t = time.perf_counter()
        queries = serve.make_queries(self.cfg, dict(self.traffic, max_qps=0), seed, 0,
                                     tag=data.WARMUP)
        futs = [self.mb.submit(q, self.k) for q in queries]
        for f in futs:
            f.result()
        self.sync()
        self.phases["warm-up"] = time.perf_counter() - t
        self.log("set-up phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in self.phases.items()))

    def sync(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    # -- the window ---------------------------------------------------------------
    def window(self, seed: int, seconds: float, traced: bool) -> Reading:
        obs = Obs(self.traffic)
        rec = dt = None
        if traced:
            rec = trace.Recorder()
            rec.install(self.cluster.coordinator, self.cluster.executors)
            dt = trace.DeviceTrace()
        try:
            reading = self._probe_window(seed, seconds, obs, rec, dt)
        finally:
            if rec is not None:
                rec.remove()
        if traced:  # the window, the profiler and the program's work are over
            rec.count()
            obs.recorder, obs.profile = rec, dt.read()
            self.log(f"profiler: {dt.cost}")
        return reading

    def _probe_window(self, seed, seconds, obs, rec, dt) -> Reading:
        tr = self.traffic
        queries = serve.make_queries(self.cfg, tr, seed, seconds)
        before = _stats_copy(self.mb.stats)
        if dt is not None:  # started and stopped while the program is idle
            dt.start()
            rec.counting = True
        win = serve.closed_loop(self.mb, queries, self.k, tr["clients"], seconds)
        self.sync()
        if dt is not None:
            rec.counting = False
            dt.stop()
        obs.window = win
        obs.batch_stats = _stats_delta(self.mb.stats, before)
        if win.exhausted:
            self.log(f"warning: every one of the {len(queries)} drawn queries was sent "
                     f"before the window closed (raise the traffic's max_qps)")
        lat = win.latencies_ms()
        failed = sum(a is None for a in win.answers)
        ends = np.unique(np.round(win.done[np.isfinite(win.done)] - win.start, 3))
        gaps = np.diff(ends)
        if len(gaps):
            self.log(f"answers came at {len(ends)} instants; between them (s): median "
                     f"{np.median(gaps):.4f}, p10 {np.percentile(gaps, 10):.4f}, p90 "
                     f"{np.percentile(gaps, 90):.4f}; first {ends[0]:.4f}, last {ends[-1]:.4f}")
        metrics = {
            "qps": win.rate(),
            "p95_ms": float(np.percentile(lat, 95)) if len(lat) else float("inf"),
            "p50_ms": float(np.percentile(lat, 50)) if len(lat) else float("inf"),
        }
        n = len(win.answers)
        return Reading(metrics, n, failed, obs, answers=win.answers, queries=queries[:n])

    def close(self) -> None:
        """Stop the serving tier and free the program's state on the card."""
        if self.mb is not None:
            self.mb.stop()
        self.mb = self.cluster = None
        gc.collect()
        if self.device == "cuda":
            self.torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------------------
    def judge(self, r: Reading, control: bool = False) -> List[check.Check]:
        """The run's numbers against their limits.  With ``control`` the
        answers judged are the reference's own at TF32 on the same queries:
        a reading that has to fail."""
        ref = _reference()
        lim = self.cfg["checks"]
        k = self.k
        corpus = self.wh.corpus()
        answered = np.array([a is not None for a in r.answers], bool)
        layout = check.Layout(self.wh.files, self.cfg["rows_per_group"])
        rows, dists, bad = layout.rows(r.answers, k)
        if control:
            dists, rows = ref.topk(corpus, r.queries, k, self.device, precision="tf32")
            bad = np.zeros(len(dists), bool)
        j = check.judge(ref, corpus, r.queries, rows, dists, k, self.device)
        checks = [
            check.Check("failed", float(r.failed), 0.0),
            check.Check("malformed", float((bad & answered).sum()), 0.0),
            check.Check("dist_gap", j["dist_gap"], lim["dist_gap_max"]),
        ]
        recall = j["recall"][answered]
        mean = float(recall.mean()) if len(recall) else 0.0
        if not control:
            r.metrics["recall_at_10"] = mean
        checks.append(check.Check("recall_at_10", mean, lim["recall_at_10_min"], at_most=False))
        return checks


def _stats_copy(stats):
    from dataclasses import asdict

    return asdict(stats)


def _stats_delta(stats, before: dict):
    """The batcher's counters over the window alone (``max_batch_seen`` as is)."""
    from dataclasses import asdict, replace

    now = asdict(stats)
    delta = {k: (v - before[k]) if isinstance(v, int) and k != "max_batch_seen" else v
             for k, v in now.items()}
    return replace(stats, **delta)


def per_layer(cell: spec.Cell, obs: Obs) -> Dict[str, float]:
    out = {}
    for name, read in spec.readers(cell).items():
        v = read(obs)
        if v is not None:
            out[name] = float(v)
    return out


def breakdown(obs: Obs) -> dict:
    prof = obs.profile
    ops = sorted(([k, v] for k, v in prof.kernels.items()), key=lambda kv: -kv[1])[:trace.TOP]
    return {"device_ops": ops, "idle_gaps": trace.idle_by_host(prof, obs.recorder.spans)}


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str, t_start: float,
        log, cache: Path = warehouse.CACHE) -> dict:
    """One run as ``run.py`` makes it: the result's fields and the checks."""
    import torch

    s = Session(cell, device, log, cache)
    s.warm(seed)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    r = s.window(seed, seconds, traced)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    s.close()
    checks = s.judge(r)
    r.metrics["setup_s"] = setup_s
    wanted = [m.name for m in (cell.per_layer if traced else cell.end_to_end)]
    if traced:
        values = per_layer(cell, r.obs)
    else:
        values = r.metrics
    units = {m.name: m.unit for m in cell.per_layer + cell.end_to_end}
    out = {
        "correct": all(c.ok for c in checks),
        "attempted": int(r.attempted),
        "failed": int(r.failed),
        "metrics": {n: {"value": values[n], "unit": units[n]} for n in wanted
                    if n in values and np.isfinite(values[n])},
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if traced:
        out["device"]["busy_s"] = r.obs.profile.busy_s
        out["device"]["window_s"] = r.obs.profile.window_s
        out["breakdown"] = breakdown(r.obs)
    out["host"] = {k: v for k, v in r.metrics.items() if k not in out["metrics"]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    out["_check_lines"] = [c.line() for c in checks]
    return out
