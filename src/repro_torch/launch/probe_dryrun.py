"""Dry-run of the paper's own workload: a 10^9-vector probe on the mesh.

Port of ``repro/launch/probe_dryrun.py``: the Stage-A + C distributed probe
(§6) at the paper's §9 configuration, unchanged — 10^9 vectors × 768 d,
R = 64, L = 100, k = 100, 64 concurrent queries — device-resident, one
~3.9M-vector shard per device (256 shards over (data, model), capacity
4,194,304), traced on both production meshes over a fake group.

    PYTHONPATH=src python -m repro_torch.launch.probe_dryrun [--out PATH]

The beam's loop cannot run on shape-only tensors (its frontier check is a
host sync), so the trace runs one beam step and counts it ``int(1.3 L) + 8``
times (:class:`_TracedBeam`), as the reference scales its while body by the
expected expansions.  The probe's body runs on each device's own block
(the ``shard_map`` counterpart), so the counters see one device's FLOPs.
The roofline divides by the devices that do distinct work, the
``n_shards`` that hold a shard each: on the two-pod mesh each pod holds
every shard and answers every query, so its per-device terms equal the
one-pod mesh's.  The beam's distances are f32 elementwise work on the CUDA
cores, so ``t_compute`` takes the f32 peak.  ``hbm_per_chip_gb`` counts the
port's dtypes: bf16 vectors, int64 adjacency, payload and counts (the
reference holds int32 ids).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from unittest import mock

import torch

from repro_torch.analysis.flops import FlopCounter
from repro_torch.analysis.hlo import CollectiveCounter
from repro_torch.analysis.roofline import PEAK_FLOPS_F32, compute_roofline, split_by_link
from repro_torch.core.vamana import _Beam
from repro_torch.launch.dryrun import MESH_CHIPS, production_mesh
from repro_torch.models.sharding import alike, mesh_shape
from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn

OUT = "results/torch/probe_dryrun.jsonl"

N = 1_000_000_000
D = 768
R = 64
L = 100
K = 100
Q = 64  # concurrent queries per probe step
OVERSAMPLE = 2
SHARD_AXES = ("data", "model")
ID_BYTES = 8  # the port's int64 adjacency / payload / counts


def shard_cap(n_shards: int) -> int:
    return 1 << int(math.ceil(math.log2(N / n_shards)))  # 4194304 at 256 shards


def hbm_per_chip_gb(cap: int) -> float:
    """One device's index bytes: bf16 vectors, int64 adjacency and payload,
    int64 medoid and count."""
    return cap * (D * 2 + R * ID_BYTES + ID_BYTES) / 1e9 + 2 * ID_BYTES / 1e9


class _TracedBeam(_Beam):
    """The beam over a shape-only shard: one step traced, standing for
    every step the loop may take."""

    def _search(self) -> None:
        with alike(self.max_iters):
            self._step()


def _traced_beam(index: DeviceAnnIndex, shard: int, q_shape, L: int, max_iters: int,
                 metric: str) -> _Beam:
    """``DeviceAnnIndex._beam`` for a shape-only index: no count or medoid
    to read, so every slot counts and the medoid is slot 0."""
    return _TracedBeam(index.vectors[shard], index.adjacency[shard], index.vectors.shape[1], 0,
                       q_shape, L, max_iters, metric, False)


def run(mesh_name: str, mesh=None) -> dict:
    if mesh is None:
        mesh = production_mesh(mesh_name)
    shape = mesh_shape(mesh)
    chips = 1
    for s in shape.values():
        chips *= s
    n_shards = shape["data"] * shape["model"]
    cap = shard_cap(n_shards)
    probe = make_probe_fn(mesh, k=K, L=L, metric="l2", oversample=OVERSAMPLE,
                          shard_axes=SHARD_AXES, device="meta")
    idx = DeviceAnnIndex.abstract(n_shards, cap, D, R, dtype=torch.bfloat16)
    queries = torch.empty((Q, D), dtype=torch.float32, device="meta")
    t0 = time.time()
    placed = idx.placed(mesh, SHARD_AXES)
    local = placed.local()
    with mock.patch.object(DeviceAnnIndex, "_beam", _traced_beam), \
            CollectiveCounter(mesh) as cc, FlopCounter() as fc:
        probe(idx, queries)
    expansions = int(1.3 * L) + 8
    # one device's body, on each of the devices that hold a distinct shard
    traced_flops = fc.count.total * n_shards
    # useful work ~ distance computations: Q × expansions × R nbrs × 2D flops
    model_flops = Q * expansions * R * 2.0 * D * n_shards
    # memory: each expansion gathers R neighbour vectors (bf16) + adjacency
    model_bytes = Q * expansions * R * (D * 2 + ID_BYTES) * n_shards
    coll = cc.stats
    links = split_by_link(coll.by_axis, shape)
    terms = compute_roofline(
        arch="ann-probe-1b", shape=f"probe_q{Q}_k{K}", mesh=mesh_name, chips=n_shards,
        hlo_flops_raw=traced_flops,
        hlo_bytes_raw=0.0,
        jaxpr_flops=traced_flops,
        model_bytes=model_bytes,
        coll_bytes_raw=float(coll.raw_bytes),
        coll_bytes=links["nvlink"],
        dcn_bytes=links["ib"],
        model_flops=model_flops,
        peak_flops=PEAK_FLOPS_F32,
    )
    arg_bytes = sum(t.numel() * t.element_size() for t in
                    (local.vectors, local.adjacency, local.medoids, local.counts, local.payload))
    return {
        "arch": "ann-probe-1b",
        "shape": f"probe_q{Q}_k{K}",
        "mesh": mesh_name,
        "kind": "probe",
        "chips": chips,
        "wall_s": round(time.time() - t0, 1),
        "index": {"N": N, "D": D, "R": R, "L": L, "K": K, "Q": Q, "oversample": OVERSAMPLE,
                  "shards": n_shards, "cap": cap, "expansions": expansions,
                  "hbm_per_chip_gb": round(hbm_per_chip_gb(cap), 2)},
        "memory_analysis": {
            "argument_bytes": arg_bytes + Q * D * 4,
            "temp_bytes": None,
            "temp_note": "not measured on a meta trace; chip_smoke.py phase 14c measures one "
                         "device's share on the card",
        },
        "collectives": {"raw_bytes": coll.raw_bytes, "global_bytes": coll.global_bytes,
                        "by_kind": coll.by_kind, "by_axis": coll.by_axis},
        "roofline": {
            "t_compute": terms.t_compute,
            "t_memory": terms.t_memory,
            "t_collective": terms.t_collective,
            "bottleneck": terms.bottleneck,
            "jaxpr_flops": traced_flops,
            "model_flops": model_flops,
            "model_bytes": model_bytes,
            "devices_dividing": n_shards,
            "note": "per probe step (64 queries); the beam loop scaled by its expected expansions; "
                    "terms per device of the n_shards that hold distinct shards (a second pod "
                    "repeats the first's work); t_compute at the f32 peak",
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for mesh_name in MESH_CHIPS:
            print(f"[probe-dryrun] {mesh_name} ...", flush=True)
            row = run(mesh_name)
            f.write(json.dumps(row) + "\n")
            print(
                f"  ok in {row['wall_s']}s  hbm/chip={row['index']['hbm_per_chip_gb']}GB "
                f"bneck={row['roofline']['bottleneck']} "
                f"t_mem={row['roofline']['t_memory']:.2e}s", flush=True
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
