#!/usr/bin/env python3
"""Trace seconds of one dry-run cell with attention's block loops folded
and unfolded, and the counts of both.

    python3 tools/dryrun_fold_time.py --arch qwen2.5-3b --shape prefill_32k --mesh single

``CellSpec.lower()`` traces under ``launch.specs.folded_attention`` (two
one-q-block calls for all of a layer's block pairs); the unfolded run
replaces it with a context that does nothing, so every pair is traced.
Prints one JSON line a run: the trace's seconds and its FLOP and
collective counts, which must agree.  Runs on the CPU (a fake group, no
card).
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import dryrun, specs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--shape", default="prefill_32k")
    ap.add_argument("--mesh", default="single", choices=sorted(dryrun.MESH_CHIPS))
    args = ap.parse_args(argv)
    folded = specs.folded_attention
    rows = {}
    for name in ("folded", "unfolded"):
        specs.folded_attention = folded if name == "folded" else contextlib.nullcontext
        t0 = time.time()
        row = dryrun.run_cell(args.arch, args.shape, args.mesh)
        rows[name] = row
        print(json.dumps({
            "run": name, "arch": args.arch, "shape": args.shape, "mesh": args.mesh,
            "lower_s": round(time.time() - t0, 2),
            "flops": row["cost_analysis"]["flops"], "dot_flops": row["cost_analysis"]["dot_flops"],
            "collective_bytes": row["collectives"]["global_bytes"],
        }), flush=True)
    specs.folded_attention = folded
    same = all(rows["folded"][k] == rows["unfolded"][k] for k in ("cost_analysis", "collectives"))
    print(f"counts equal: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
