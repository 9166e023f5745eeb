"""Fault-tolerance tour on the PyTorch/CUDA port: kill executors, inject
stragglers, scale elastically.

    python3 examples/torch_fault_tolerance_demo.py                 # on the card
    python3 examples/torch_fault_tolerance_demo.py --device cpu    # the plain PyTorch path

``examples/fault_tolerance_demo.py`` on ``repro_torch``: the same data,
index parameters and printout.  Runs the paper's distributed build/probe
protocols while the fleet degrades: an executor dies mid-build (fragments
reassigned), another straggles during probe (speculative backup task wins),
the pool scales out and a fresh executor serves from cold caches — all
without client-visible failures.  ``main`` returns the printed facts as a
dict.  The straggler's attempt may still be asleep when the process exits.
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from repro_torch.runtime.cluster import make_local_cluster  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig  # noqa: E402


def main(device="cuda") -> dict:
    out = {}
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as root:
        cluster = make_local_cluster(root, num_executors=4, enable_speculation=True,
                                     max_attempts=5, device=device)
        cluster.coordinator.scheduler.speculation_factor = 2.0
        table = LakehouseTable(cluster.catalog, "emb")
        dim = 48
        table.create(dim=dim)
        centers = rng.normal(size=(16, dim)) * 4
        X = np.concatenate([c + rng.normal(size=(250, dim)) for c in centers]).astype(np.float32)
        rng.shuffle(X)
        table.append_vectors(X, num_files=8, rows_per_group=512)

        print("== build with one executor failing mid-wave ==")
        cluster.executors[1].fail_next(1)
        rep = cluster.coordinator.create_index(
            "emb", IndexConfig(name="idx", R=16, L=32, partitions_per_shard=2,
                               build_passes=1, build_batch=256),
        )
        st = cluster.coordinator.scheduler.stats
        out.update(shards=rep.num_shards, vectors=rep.vector_count,
                   build_reassigned=st.reassigned, build_failures_seen=st.failures_seen)
        print(f"  built {rep.num_shards} shards / {rep.vector_count} vectors "
              f"(reassigned={st.reassigned}, failures_seen={st.failures_seen})")

        print("== probe with a dead executor ==")
        cluster.executors[0].kill()
        pr = cluster.coordinator.probe("emb", X[:4], 5, strategy="diskann")
        out.update(dead_result_sets=len(pr.hits), dead_reassigned=st.reassigned)
        print(f"  {len(pr.hits)} result sets despite ex-0 down "
              f"(reassigned={st.reassigned})")
        cluster.executors[0].revive()

        print("== probe with a straggler (speculative backup) ==")
        cluster.executors[2].delay_next(3.0)
        pr = cluster.coordinator.probe("emb", X[:4], 5, strategy="diskann")
        out.update(straggler_result_sets=len(pr.hits), speculative=st.speculative)
        print(f"  done; speculative launches so far: {st.speculative}")

        print("== elastic scale-out: fresh executor, cold caches ==")
        ex = cluster.add_executor()
        pr = cluster.coordinator.probe("emb", X[:4], 5, strategy="diskann")
        out.update(scale_out_result_sets=len(pr.hits), scale_out_hits=ex.cache_hits,
                   scale_out_misses=ex.cache_misses)
        print(f"  {ex.executor_id} joined; probe ok "
              f"(hits={ex.cache_hits}, misses={ex.cache_misses})")
        cluster.remove_executor(ex.executor_id)
        print("  scaled back in — executor state was only a cache. done.")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
