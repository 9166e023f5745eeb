"""Filtered vector search on the PyTorch/CUDA port: predicate-aware probes
and the probe-plan IR.

    python3 examples/torch_filtered_search.py                 # on the card
    python3 examples/torch_filtered_search.py --device cpu    # the plain PyTorch path

``examples/filtered_search.py`` on ``repro_torch``: the same data, index
parameters and printout.  Builds a single large shard (above the planner's
EXACT_SCAN_MAX_ROWS cap) with an attribute column, then sweeps predicate
selectivity to show the planner picking a different op per band — the
predicate-aware MaskedBeam traversal at low/mid selectivity, the
over-fetched PostfilterBeam when nearly everything passes — and inspects the
``ProbeReport.plan`` artifact: selectivity evidence, per-shard ops,
traversal/fallback accounting, and a JSON round-trip replayed through
``probe_batch(replay_plan=...)``.  ``main`` returns the printed facts as a
dict.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from repro_torch.runtime.cluster import make_local_cluster  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig  # noqa: E402
from repro_torch.runtime.planner import ProbePlan  # noqa: E402

BANDS = ("price < 5", "price < 30", "price < 95")


def recall(oracle_hits, got_hits):
    loc = lambda hits: {(h.file_path, h.row_group, h.row_offset) for h in hits}  # noqa: E731
    return np.mean([
        len(loc(a) & loc(b)) / max(len(loc(a)), 1)
        for a, b in zip(oracle_hits, got_hits)
    ])


def main(device="cuda") -> dict:
    out = {}
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as root:
        cluster = make_local_cluster(root, num_executors=2, device=device)
        table = LakehouseTable(cluster.catalog, "products")
        dim = 32
        table.create(dim=dim)

        print("== ingest: 5000 vectors with a uniform int `price` attribute ==")
        centers = rng.normal(size=(10, dim)) * 3.0
        X = np.concatenate(
            [c + rng.normal(size=(500, dim)) for c in centers]
        ).astype(np.float32)
        price = rng.integers(0, 100, size=len(X)).astype(np.int64)
        table.append_vectors(X, num_files=4, rows_per_group=250,
                             attributes={"price": price})

        # ONE shard of 5000 rows: too big for a masked linear scan, so
        # filtered probes must either traverse the graph predicate-aware
        # (MaskedBeam) or over-fetch and post-filter (PostfilterBeam)
        print("== CREATE INDEX (single 5000-row shard) ==")
        rep = cluster.coordinator.create_index(
            "products",
            IndexConfig(name="idx", num_shards=1, R=24, L=48,
                        partitions_per_shard=4, build_passes=1, build_batch=256),
        )
        out.update(shards=rep.num_shards, vectors=rep.vector_count)
        print(f"  shards={rep.num_shards} vectors={rep.vector_count}")

        Q = X[rng.choice(len(X), 16)] + 0.05 * rng.normal(size=(16, dim)).astype(
            np.float32
        )

        print("== selectivity sweep: one predicate, three plan bands ==")
        out["bands"] = {}
        for where in BANDS:
            oracle = cluster.coordinator.probe_batch(
                "products", Q, 10, strategy="scan", filter=where
            )
            pr = cluster.coordinator.probe_batch(
                "products", Q, 10, strategy="diskann", filter=where, L=128
            )
            rec = recall(oracle.hits, pr.hits)
            out["bands"][where] = dict(
                est_frac=pr.est_selectivity, plan=pr.filter_plan, recall=float(rec),
                mbeam_rows=pr.masked_beam_rows, fallbacks=pr.masked_beam_fallbacks,
                kernel_dispatches=pr.kernel_dispatches)
            print(f"  {where:12s} est_frac={pr.est_selectivity:.2f} "
                  f"plan[{pr.filter_plan}] recall@10={rec:.3f} "
                  f"mbeam_rows={pr.masked_beam_rows} "
                  f"fallbacks={pr.masked_beam_fallbacks} "
                  f"kernel_dispatches={pr.kernel_dispatches}")

        print("== the plan is an artifact: serialize, then replay ==")
        fresh = cluster.coordinator.probe_batch(
            "products", Q, 10, strategy="diskann", filter="price < 30", L=128
        )
        wire = json.dumps(fresh.plan.to_json())  # e.g. persisted next to a report
        ops0 = [op.to_json() for op in fresh.plan.ops[0].values()]
        print(f"  plan JSON: {len(wire)} bytes, ops for query 0: {ops0}")
        replay = cluster.coordinator.probe_batch(
            "products", Q, 10, strategy="diskann", filter="price < 30", L=128,
            replay_plan=ProbePlan.from_json(json.loads(wire)),
        )
        same = all(
            [(h.file_path, h.row_group, h.row_offset) for h in a]
            == [(h.file_path, h.row_group, h.row_offset) for h in b]
            for a, b in zip(fresh.hits, replay.hits)
        )
        out.update(plan_json_bytes=len(wire), ops_query0=ops0, replay_plan=replay.filter_plan,
                   replay_identical=same)
        print(f"  replayed plan ({replay.filter_plan}): identical hits = {same}")

        print("== single probe: per-query report carries the same plan ==")
        one = cluster.coordinator.probe(
            "products", Q[0], 10, strategy="diskann", filter="price < 30", L=128
        )
        out["single"] = dict(plan=one.filter_plan, est_frac=one.est_selectivity,
                             hits=len(one.hits[0]))
        print(f"  filter_plan={one.filter_plan} "
              f"est={one.est_selectivity:.2f} hits={len(one.hits[0])}")
        print("done.")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
