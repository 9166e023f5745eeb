"""The program's own spans over a cell's window, and what its span log costs.

    python3 portbench/spans.py --workload sift1m.probe --seed 7 --seconds 20 --pairs 3 \\
        --out spans.json

Sets the cell up once, as ``run.py`` does, then:

1. one traced window (``--trace 1``'s profiler and wrappers) with the
   program's span log (``repro_torch.serving.metrics``) on over the clients'
   window, judged as ``run.py`` judges it: the per-layer metrics, the four
   readings of ``harness/spans.py``, the idle device seconds by the
   harness's spans alone (``run.py``'s ``breakdown.idle_gaps``) and by the
   program's spans beside them, and each span name's count and seconds;
2. ``--pairs`` pairs of untraced windows, the span log off in one and on in
   the other, in turns (off first in even pairs), the two of a pair on one
   seed: each window's ``qps``, and with the log on its span count and the
   four readings.

One JSON object on standard output, and in ``--out``.  Needs a CUDA device.
The benchmark's own runs never run this.  It stands in for the traced run's
span log until ``harness/cell.py`` turns the log on itself (``Obs.spans``):
the change that does so deletes this tool and its test.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def readers() -> dict:
    """The four per-layer readings by metric name."""
    from harness import spans as program

    return {"queue_wait_ms.probe": program.queue_wait_ms,
            "lock_wait_ms.probe": program.lock_wait_ms,
            "row_read_ms.probe": program.row_read_ms,
            "gc_pause_ms.probe": program.gc_pause_ms}


def counts_by_name(drained) -> dict:
    out: dict = {}
    for s in drained.spans if drained is not None else ():
        out[s.name] = out.get(s.name, 0) + 1
    return out


def measure(c, seed: int, seconds: float, pairs: int, device: str, log, t_start: float,
            cache=None) -> dict:
    """Steps 1 and 2 above on cell ``c`` (a ``spec.Cell``); the result's
    fields.  Whatever it patches in the harness's modules for the run is
    put back before it returns."""
    import torch

    from harness import cell as cells
    from harness import serve, trace, warehouse
    from harness import spans as program
    from repro_torch.serving import metrics

    # the span log on over the clients' window alone: not over the
    # profiler's start, stop and read, nor the check
    logged = {"on": False, "drained": None}
    closed_loop, top = serve.closed_loop, trace.TOP

    def window_logged(*a, **kw):
        if not logged["on"]:
            return closed_loop(*a, **kw)
        metrics.drain()
        metrics.enable()
        try:
            return closed_loop(*a, **kw)
        finally:
            metrics.disable()
            logged["drained"] = metrics.drain()

    def readings(drained):
        return {name: read(drained) for name, read in readers().items()}

    serve.closed_loop = window_logged
    trace.TOP = 1000  # every label of the breakdowns, not the result line's ten
    s = cells.Session(c, device, log, cache or warehouse.CACHE)
    out = {"workload": c.name, "seed": seed, "seconds": seconds,
           "device": torch.cuda.get_device_name(0) if device == "cuda" else device}
    try:
        s.warm(seed)
        out["setup_s"] = time.perf_counter() - t_start
        logged["on"] = True
        r = s.window(seed, seconds, True)
        drained = logged["drained"]
        prof, host = r.obs.profile, r.obs.recorder.spans
        checks = s.judge(r)
        out["traced"] = {
            "correct": all(ch.ok for ch in checks),
            "checks": {ch.name: ch.value for ch in checks},
            "qps": r.metrics["qps"],
            "per_layer": cells.per_layer(c, r.obs),
            "program": readings(drained),
            "idle_share": 1.0 - prof.busy_s / prof.window_s,
            "window_s": prof.window_s,
            "idle_by_harness_spans": trace.idle_by_host(prof, host),
            "idle_by_all_spans": trace.idle_by_host(prof, list(host)
                                                    + program.as_host_spans(drained)),
            "idle_by_program_spans": trace.idle_by_host(prof, program.as_host_spans(drained)),
            "span_counts": counts_by_name(drained),
            "span_seconds": program.seconds_by_name(drained),
            "counters": drained.counters,
        }
        log(f"traced window: {json.dumps(out['traced']['program'])}")
        out["pairs"] = []
        for i in range(pairs):
            pair = {"seed": seed + 1 + i}
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                logged["on"], logged["drained"] = on, None
                w = s.window(pair["seed"], seconds, False)
                side = {"qps": w.metrics["qps"], "answered": w.attempted - w.failed}
                if on:
                    d = logged["drained"]
                    side.update(spans=len(d.spans), program=readings(d),
                                span_counts=counts_by_name(d))
                pair["on" if on else "off"] = side
                log(f"pair {i} log {'on' if on else 'off'}: qps {side['qps']:.2f}")
            out["pairs"].append(pair)
    finally:
        s.close()
        serve.closed_loop, trace.TOP = closed_loop, top
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    t_start = time.perf_counter()
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = measure(spec.load(args.workload), args.seed, args.seconds, args.pairs, "cuda", log,
                  t_start)
    text = json.dumps(out, default=float)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
