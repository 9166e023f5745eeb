"""Readings that set the limits of the check: the program's, and the control's.

    python3 portbench/control.py --workload sift1m.probe --seeds 101-112 --seconds 5

For each seed, a short window of the cell's own traffic at its own size,
then two judgements of the same queries: the program's answers (the lower
readings), and the answers of the plain reference computed at TF32, one
step below the configuration's f32 (the control, whose readings have to
fail a limit).  The cell is set up once for all its seeds.  One JSON line a
seed on standard output.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="e.g. 101-112 or 5,9,11")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    import torch

    from harness import cell as cells
    from harness import spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = spec.load(args.workload)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    todo = seeds(args.seeds)
    session = cells.Session(c, "cuda", log)
    try:
        session.warm(todo[0])
        for seed in todo:
            t0 = time.perf_counter()
            r = session.window(seed, args.seconds, False)
            row = {"workload": c.name, "seed": seed, "metrics": r.metrics}
            for side, control in (("program", False), ("control", True)):
                checks = session.judge(r, control=control)
                row[side] = {ch.name: ch.value for ch in checks}
                row[side + "_correct"] = all(ch.ok for ch in checks)
            row["seconds"] = time.perf_counter() - t0
            print(json.dumps(row), flush=True)
    finally:
        session.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
