"""Quickstart on the PyTorch/CUDA port: the paper's full index lifecycle.

    python3 examples/torch_quickstart.py                 # on the card
    python3 examples/torch_quickstart.py --device cpu    # the plain PyTorch path

``examples/quickstart.py`` on ``repro_torch``: the same data, index
parameters and printout.  Creates a lakehouse table of embeddings, builds a
Puffin-backed Vamana index (3-stage distributed build over 4 in-process
executors), probes it with all three strategies, appends + deletes data,
refreshes the index incrementally, and shows time travel + orphan GC.
``main`` returns the printed facts as a dict.
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core.vamana import brute_force_topk  # noqa: E402
from repro_torch.iceberg.gc import expire_and_collect  # noqa: E402
from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from repro_torch.runtime.cluster import make_local_cluster  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig  # noqa: E402


def main(device="cuda") -> dict:
    out = {}
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as root:
        cluster = make_local_cluster(root, num_executors=4, device=device)
        table = LakehouseTable(cluster.catalog, "documents")
        dim = 64
        table.create(dim=dim)

        print("== ingest ==")
        centers = rng.normal(size=(32, dim)) * 4
        X = np.concatenate([c + rng.normal(size=(400, dim)) for c in centers]).astype(np.float32)
        rng.shuffle(X)
        meta = table.append_vectors(X, num_files=16, rows_per_group=512)
        out.update(rows=len(X), files=len(table.current_files()),
                   snapshot_id=meta.current_snapshot_id)
        print(f"  {out['rows']} vectors in {out['files']} parquet files, "
              f"snapshot {out['snapshot_id']}")

        print("== CREATE INDEX (3-stage distributed build) ==")
        rep = cluster.coordinator.create_index(
            "documents",
            IndexConfig(name="docs_idx", R=24, L=48, pq_m=16, pq_nbits=8,
                        partitions_per_shard=4, build_passes=1, build_batch=256),
        )
        out.update(shards=rep.num_shards, vectors=rep.vector_count, puffin_bytes=rep.total_bytes,
                   stage_seconds=(rep.stage0_seconds, rep.stage1_seconds, rep.stage2_seconds),
                   puffin_path=rep.puffin_path)
        print(f"  shards={rep.num_shards} vectors={rep.vector_count} "
              f"puffin={rep.total_bytes/1e6:.1f}MB")
        print(f"  stage0(sample+kmeans)={rep.stage0_seconds:.1f}s "
              f"stage1(parallel build)={rep.stage1_seconds:.1f}s "
              f"stage2(assemble+commit)={rep.stage2_seconds:.1f}s")
        print(f"  bound to snapshot via statistics-file: {rep.puffin_path}")

        print("== probe ==")
        Q = X[rng.choice(len(X), 16)] + 0.05 * rng.normal(size=(16, dim)).astype(np.float32)
        _, truth = brute_force_topk(X, Q, 10, device=cluster.device)
        vecs_all, locs_all = table.scan_vectors()
        tl = [{(locs_all[i].file_path, locs_all[i].row_group_id, locs_all[i].row_offset)
               for i in row} for row in truth]
        out["probe"] = {}
        for strategy, kw in (("scan", {}), ("centroid", {"n_probe": 4}),
                             ("diskann", {"use_pq": False})):
            pr = cluster.coordinator.probe("documents", Q, 10, strategy=strategy, **kw)
            rec = np.mean([
                len({(h.file_path, h.row_group, h.row_offset) for h in hits} & t) / len(t)
                for hits, t in zip(pr.hits, tl)
            ])
            out["probe"][strategy] = dict(recall=float(rec), files=pr.files_scanned,
                                          bytes_read=pr.bytes_read)
            print(f"  {strategy:9s} recall@10={rec:.3f} files={pr.files_scanned:3d} "
                  f"S3_bytes={pr.bytes_read/1e6:7.2f}MB")

        print("== churn + REFRESH INDEX ==")
        Y = (centers[3] + rng.normal(size=(800, dim))).astype(np.float32)
        table.append_vectors(Y, num_files=2, file_prefix="delta")
        doomed = table.current_files()[0].path
        table.delete_files([doomed])
        rr = cluster.coordinator.refresh_index("documents", "docs_idx")
        out.update(inserted=rr.inserted, tombstoned=rr.tombstoned, rebuilt=rr.shards_rebuilt,
                   refresh_seconds=rr.seconds)
        print(f"  inserted={rr.inserted} tombstoned={rr.tombstoned} "
              f"rebuilt={rr.shards_rebuilt} in {rr.seconds:.1f}s (metadata-only commit)")

        print("== time travel ==")
        pr_old = cluster.coordinator.probe("documents", Q[:2], 5, snapshot_id=rep.snapshot_id)
        out["time_travel_result_sets"] = len(pr_old.hits)
        print(f"  probe AS OF old snapshot: {len(pr_old.hits)} result sets (old index version)")

        print("== orphan GC ==")
        orphans = expire_and_collect(
            cluster.store, cluster.catalog.load_table("documents"), keep_last=1, delete=True
        )
        out["orphans"] = len(orphans)
        print(f"  reclaimed {len(orphans)} objects (superseded Puffin + shard blobs)")
        print("done.")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
