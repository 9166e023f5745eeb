"""Benchmark of the PyTorch/CUDA port (``src/repro_torch``): one run of one cell.

    python3 portbench/run.py --workload sift1m.probe --seed 7 --seconds 20 --trace 0

Reads the cell from ``BENCHMARK.json``, sets it up (the first run of a
configuration in a checkout builds its warehouse into ``portbench/.cache``),
measures for ``--seconds``, checks what the window answered against the plain
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``.  Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one the
    benchmark must never load: JAX, or the JAX package the port came from."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def finite(x):
    """``x`` with every float that is not finite replaced by None: the line
    stays JSON (a failed query's latency is +inf)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    from harness import cell as cells
    from harness import spec

    c = spec.load(args.workload)
    import torch

    log(f"imports {time.perf_counter() - T_START:.3f} s")

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        log(f"{args.workload} needs {c.chips} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = cells.run(c, args.seed, args.seconds, bool(args.trace), "cuda", T_START, log)
    bad = forbidden_modules()
    if bad:
        log(f"modules that must not be loaded were loaded: {bad}")
        return 3
    lines = out.pop("_check_lines")
    for line in lines:
        log(line)
    print(json.dumps(finite(out), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
