#!/usr/bin/env python3
"""Which re-layouts one dry-run cell's step makes, and the collective bytes
each issues.

    python3 tools/dryrun_placements.py --arch qwen2.5-3b --shape train_4k --depth 1 [--per-layer]
    python3 tools/dryrun_placements.py --arch zamba2-1.2b --shape decode_32k --per-layer

Traces the cell at ``--depth`` layers on the named mesh's fake group, as
``CellSpec.lower()`` traces it, with every DTensor redistribution logged:
global collective bytes by (kind, the aten op being dispatched or
``direct``, placements from, placements to, global shape, dtype), largest
first.  ``--per-layer`` traces one group of layers deeper too and prints
the difference: one group's share, what ``lower()`` extends to the full
depth.  A group is one layer, or for a hybrid (zamba2) its
``shared_attn_every`` mamba layers and the shared block after them;
``--depth`` defaults to the shallower of ``lower()``'s two depths
(``specs.trace_depths``).  On a CPU group a shard-to-shard move is an
all-gather and a local chunk.  Runs on the CPU (no card).
"""

import argparse
import collections
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch.distributed.tensor._api as dt_api  # noqa: E402
import torch.distributed.tensor._dispatch as dt_dispatch  # noqa: E402
import torch.distributed.tensor._redistribute as dt_redistribute  # noqa: E402

from repro_torch.analysis import flops, hlo  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402


def _logging(log: collections.Counter):
    """Patch the redistribution and the collective counter so that each
    collective's global bytes land under the re-layout that issued it."""
    current = {"key": None}
    redistribute = dt_redistribute.redistribute_local_tensor

    def logged(local, src, dst, *a, **kw):
        prev = current["key"]
        shape = tuple(src.tensor_meta.shape) if src.tensor_meta is not None else None
        current["key"] = (flops.current_op() or "direct", str(tuple(src.placements)),
                          str(tuple(dst.placements)), str(shape), str(local.dtype))
        try:
            return redistribute(local, src, dst, *a, **kw)
        finally:
            current["key"] = prev

    for mod in (dt_redistribute, dt_dispatch, dt_api):
        mod.redistribute_local_tensor = logged
    record = hlo.CollectiveCounter._record

    def counted(self, packet, args, out):
        before = self.stats.global_bytes
        record(self, packet, args, out)
        key = current["key"] or (flops.current_op() or "direct", "?", "?", "?", "?")
        log[(hlo.COLLECTIVE_OPS[packet][0],) + key] += self.stats.global_bytes - before

    hlo.CollectiveCounter._record = counted


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--depth", type=int, default=None)
    ap.add_argument("--per-layer", action="store_true")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args(argv)

    log: collections.Counter = collections.Counter()
    _logging(log)
    cell = specs.build_cell(args.arch, args.shape, dryrun.production_mesh(args.mesh))
    depth = args.depth or specs.trace_depths(cell.cfg)[0]
    group = cell.cfg.shared_attn_every or 1
    _, stats, _, _ = specs._run_counted(cell, depth)
    print(f"depth {depth}: {stats.global_bytes} B global, by kind {stats.by_kind}")
    if args.per_layer:
        first = collections.Counter(log)
        log.clear()
        _, stats, _, _ = specs._run_counted(cell, depth + group)
        print(f"depth {depth + group}: {stats.global_bytes} B global, by kind {stats.by_kind}")
        log.subtract(first)
        print("one layer's share:" if group == 1 else f"one group's share ({group} layers):")
    total = sum(log.values()) or 1
    for (kind, op, src, dst, shape, dtype), b in log.most_common(args.top):
        if b:
            print(f"{b:.4e} B {b / total:6.3f} {kind:14s} {op:20s} {src} -> {dst} {shape} {dtype}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
