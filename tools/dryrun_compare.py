#!/usr/bin/env python3
"""Every dry-run cell of the port against the reference's, side by side.

    python3 tools/dryrun_compare.py --out results/torch/compare [--parent DIR] [--jobs 6]
    python3 tools/dryrun_compare.py --out results/torch/compare --arch dbrx-132b --shape train_4k
    python3 tools/dryrun_compare.py --out results/torch/compare --table-only

Runs ``python -m repro.launch.dryrun`` (the reference, JAX on the CPU) and
``python -m repro_torch.launch.dryrun`` (this tree's port; with
``--parent DIR``, also the port of the checkout in ``DIR``) for each
(arch, shape, mesh) cell, one process a cell and ``--jobs`` at a time, each
writing its row to ``OUT/{ref,port,parent}/ARCH.SHAPE.MESH.jsonl``; a row
already there is kept (``--force`` reruns it).  Each process's wall and CPU
seconds (user + system, its children's included) go in ``OUT/seconds.json``.
Then prints a markdown table: global collective bytes of the reference,
the parent and this tree, this tree over the reference, the largest kind
of each, the bottleneck of each, and the seconds.  The cells default to
every arch's shape set (``long_500k`` where the arch is sub-quadratic)
on both meshes.  Runs on the CPU (no card).
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import ARCH_IDS, get_config, shape_cells  # noqa: E402

PACKAGES = {"ref": "repro", "parent": "repro_torch", "port": "repro_torch"}  # the table's order


def cells(arch=None, shape=None, mesh=None):
    out = []
    for a in [arch] if arch else ARCH_IDS:
        names = [shape] if shape else [s.name for s in shape_cells(get_config(a))]
        for s in names:
            for m in [mesh] if mesh else ["single", "multi"]:
                out.append((a, s, m))
    return out


def _run(tag: str, tree: Path, cell, out: Path, force: bool):
    """One cell of one package in its own process; (wall s, CPU s) or None
    when the row is already there."""
    arch, shape, mesh = cell
    path = out / tag / f"{arch}.{shape}.{mesh}.jsonl"
    if path.exists() and not force:
        return None
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(tree / "src"), "JAX_PLATFORMS": "cpu"}
    cmd = [sys.executable, "-m", f"{PACKAGES[tag]}.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh, "--out", str(path), "--force"]
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=tree, env=env, stdout=subprocess.DEVNULL,
                            stderr=open(path.with_suffix(".log"), "w"))
    _, status, usage = os.wait4(proc.pid, 0)
    proc.returncode = os.waitstatus_to_exitcode(status)
    return round(time.time() - t0, 1), round(usage.ru_utime + usage.ru_stime, 1)


def _row(out: Path, tag: str, cell):
    path = out / tag / "{}.{}.{}.jsonl".format(*cell)
    if not path.exists():
        return None
    lines = [json.loads(x) for x in path.read_text().splitlines() if x.strip()]
    return lines[-1] if lines else None


def _facts(row):
    """(global bytes, largest kind, bottleneck) of a row, or a note."""
    if row is None:
        return None
    if row.get("kind") in ("skip", "error"):
        return row["kind"]
    coll = row["collectives"]
    kinds = coll.get("by_kind") or {}
    top = max(kinds, key=kinds.get) if kinds else "-"
    return coll["global_bytes"], top, row["roofline"]["bottleneck"]


def table(out: Path, todo) -> str:
    secs = json.loads((out / "seconds.json").read_text()) if (out / "seconds.json").exists() else {}
    head = ("| arch | shape | mesh | ref B | parent B | port B | port / ref | largest kind "
            "ref / parent / port | bottleneck ref / parent / port | CPU s ref / parent / port |")
    lines = [head, "|" + " --- |" * 10]
    for cell in todo:
        f = {t: _facts(_row(out, t, cell)) for t in PACKAGES}
        if all(v is None for v in f.values()):
            continue

        def part(t, i):
            v = f[t]
            return "-" if v is None else v if isinstance(v, str) else (f"{v[0]:.4e}" if i == 0 else v[i])

        ratio = "-"
        if isinstance(f["ref"], tuple) and isinstance(f["port"], tuple) and f["ref"][0]:
            ratio = f"{f['port'][0] / f['ref'][0]:.3f}"
        s = " / ".join(str(secs.get("|".join((t,) + cell), ["-", "-"])[1]) for t in PACKAGES)
        lines.append(f"| {cell[0]} | {cell[1]} | {cell[2]} | {part('ref', 0)} | {part('parent', 0)} | "
                     f"{part('port', 0)} | {ratio} | "
                     f"{' / '.join(part(t, 1) for t in PACKAGES)} | "
                     f"{' / '.join(part(t, 2) for t in PACKAGES)} | {s} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--parent", default=None, help="a checkout whose port runs too")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--only", default="ref,parent,port", help="which of ref, parent, port to run")
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table-only", action="store_true")
    args = ap.parse_args(argv)

    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    todo = cells(args.arch, args.shape, args.mesh)
    trees = {"ref": ROOT, "port": ROOT}
    if args.parent:
        trees["parent"] = Path(args.parent).resolve()
    tags = [t for t in args.only.split(",") if t in trees]
    if not args.table_only:
        secs_path = out / "seconds.json"
        secs = json.loads(secs_path.read_text()) if secs_path.exists() else {}
        jobs = [(t, c) for c in todo for t in tags]
        # the slowest first: multi-pod train cells
        jobs.sort(key=lambda j: (j[1][2] != "multi", j[1][1] != "train_4k"))
        with ThreadPoolExecutor(args.jobs) as pool:
            done = pool.map(lambda j: (j, _run(j[0], trees[j[0]], j[1], out, args.force)), jobs)
            for (t, c), got in done:
                if got is not None:
                    secs["|".join((t,) + c)] = got
                    secs_path.write_text(json.dumps(secs, indent=0, sort_keys=True))
                    print(f"{t} {' '.join(c)}: {got[0]} s wall, {got[1]} CPU s", flush=True)
    print(table(out, todo))
    return 0


if __name__ == "__main__":
    sys.exit(main())
