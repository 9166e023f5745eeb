"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on a fake mesh.

Port of ``repro/launch/dryrun.py``.  The reference forces 512 host devices
before importing jax; here :func:`repro_torch.launch.mesh.init_fake_world`
starts a fake process group of the mesh's size in this process, and every
cell's step runs on ``meta`` DTensors placed on that mesh (no data, no
allocation) under the FLOP and collective counters (``CellSpec.lower()``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh multi    # 2-pod only
    PYTHONPATH=src python -m repro_torch.launch.dryrun --out results/torch/dryrun.jsonl

Each cell appends one JSON line (restartable: existing (arch, shape, mesh)
rows are skipped unless --force) with the reference's row schema:
``memory_analysis`` (one device's argument, output and aliased bytes from
the local blocks of the placed inputs and outputs; ``temp_bytes`` is null:
a ``meta`` trace has no allocator, so no peak of temporaries is measured),
``cost_analysis`` (the traced FLOPs; ``bytes_accessed`` null: there is no
compiled program to ask), the traced FLOP count (``jaxpr_flops`` in the
roofline, and its matmul part apart), the collectives DTensor issued (raw,
global, by kind and by mesh axis), the H100 roofline terms and the dominant
bottleneck.  An error row names the aten op whose dispatch raised
(``op``).  The default output is ``results/torch/dryrun.jsonl``: the
reference's own rows live in ``results/dryrun.jsonl``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

from repro_torch.analysis.flops import raised_op
from repro_torch.analysis.roofline import compute_roofline, split_by_link
from repro_torch.configs.base import ARCH_IDS, get_config, shape_cells
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models.sharding import mesh_shape, mesh_size

DEFAULT_OUT = "results/torch/dryrun.jsonl"
MESH_CHIPS = {"single": 256, "multi": 512}
TEMP_NOTE = "not measured: a meta trace has no allocator to take a peak of temporaries from"


def production_mesh(mesh_name: str):
    """The named production mesh over a fake group of its size (the group
    is replaced when the other mesh was used last)."""
    init_fake_world(MESH_CHIPS[mesh_name])
    return make_production_mesh(multi_pod=(mesh_name == "multi"), device_type="cpu")


def run_cell(arch: str, shape_name: str, mesh_name: str, rules=None, microbatches: int = 8,
             mesh=None, **cell_kw) -> dict:
    t0 = time.time()
    if mesh is None:
        mesh = production_mesh(mesh_name)
    chips = mesh_size(mesh)
    cell = build_cell(arch, shape_name, mesh, rules, microbatches=microbatches, **cell_kw)
    row = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "chips": chips,
        "kind": cell.kind,
    }
    if cell.kind == "skip":
        row["skip_reason"] = cell.skip_reason
        return row

    low = cell.lower()
    t_lower = time.time() - t0
    coll = low.collectives
    links = split_by_link(coll.by_axis, mesh_shape(mesh))
    terms = compute_roofline(
        arch=arch,
        shape=shape_name,
        mesh=mesh_name,
        chips=chips,
        hlo_flops_raw=low.flops.total,
        hlo_bytes_raw=0.0,
        jaxpr_flops=low.flops.total,
        model_bytes=cell.model_bytes,
        coll_bytes_raw=float(coll.raw_bytes),
        coll_bytes=links["nvlink"],
        dcn_bytes=links["ib"],
        model_flops=cell.model_flops,
    )
    row.update(
        {
            "lower_s": round(t_lower, 1),
            "compile_s": 0.0,
            "traced_depths": list(low.depths),
            "memory_analysis": {
                "argument_bytes": low.argument_bytes,
                "output_bytes": low.output_bytes,
                "temp_bytes": None,
                "alias_bytes": low.alias_bytes,
                "temp_note": TEMP_NOTE,
            },
            "cost_analysis": {
                "flops": low.flops.total,
                "dot_flops": low.flops.dot,
                "bytes_accessed": None,
            },
            "collectives": {
                "raw_bytes": coll.raw_bytes,
                "corrected_bytes": coll.corrected_bytes,
                "global_bytes": coll.global_bytes,
                "by_kind": coll.by_kind,
                "by_axis": coll.by_axis,
                "by_op": coll.by_op,
                "ops": coll.ops,
                "nvlink_bytes": links["nvlink"],
                "ib_bytes": links["ib"],
            },
            "roofline": {
                k: v
                for k, v in dataclasses.asdict(terms).items()
                if k not in ("arch", "shape", "mesh", "extra")
            },
        }
    )
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: arch's set)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"]))
                except (ValueError, KeyError):
                    pass

    archs = [args.arch] if args.arch else ARCH_IDS
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = [args.shape] if args.shape else [s.name for s in shape_cells(cfg)]
        # always record the skip rows for non-subquadratic long_500k
        if not args.shape and not cfg.subquadratic:
            shapes.append("long_500k")
        for shape in shapes:
            for mesh_name in meshes:
                key = (arch, shape, mesh_name)
                if key in done:
                    print(f"[skip-done] {key}")
                    continue
                print(f"[cell] {arch} × {shape} × {mesh_name} ...", flush=True)
                t0 = time.time()
                raised_op()  # forget an op that raised in an earlier cell
                try:
                    row = run_cell(arch, shape, mesh_name, microbatches=args.microbatches)
                    status = row.get("kind")
                except Exception as e:  # noqa: BLE001 — an error row, the sweep goes on
                    traceback.print_exc()
                    op = raised_op()
                    row = {
                        "arch": arch,
                        "shape": shape,
                        "mesh": mesh_name,
                        "kind": "error",
                        "error": f"{type(e).__name__}: {e}",
                        "op": op,
                    }
                    status = "ERROR"
                    failures += 1
                row["wall_s"] = round(time.time() - t0, 1)
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
                print(f"  -> {status} in {row['wall_s']}s", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
