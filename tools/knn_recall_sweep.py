#!/usr/bin/env python3
"""Recall@8 of the kNN-LM index against beam width, at D = 2,048.

    python3 tools/knn_recall_sweep.py --device cpu            # ~4 min
    python3 tools/knn_recall_sweep.py --L 32 512              # on the card

The corpus of ``examples/serve_retrieval.py`` at qwen2.5-3b's width: 4,000
``lm_head``-like columns (N(0, 0.02^2) a coordinate, as the model's init
draws them, one column per random token) plus N(0, 0.01^2) noise, in a
4-file table indexed by ``create_index`` with the example's parameters
(R = 16, L = 32, two partitions a shard, one pass).  For two query sets
of 100 (columns of held-out tokens, and fresh noisy copies of the first
100 corpus tokens' columns) it prints recall@8 against brute force of the
device probe (``make_probe_fn(k=8, L)`` over the Puffin shards, payload
= global row) and of ``Coordinator.probe(L=L)``, with the device probe's
recall@1, at each ``--L``.
"""

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.blobs import SHARD_BLOB_TYPE, decode_shard_blob  # noqa: E402
from repro_torch.core.vamana import brute_force_topk, recall_at_k  # noqa: E402
from repro_torch.iceberg.puffin import PuffinReader  # noqa: E402
from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from repro_torch.runtime.cluster import make_local_cluster  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig  # noqa: E402
from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn  # noqa: E402

D, N, V, ROWS_PER_FILE = 2048, 4000, 151936, 1000


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--L", type=int, nargs="+", default=[32, 64, 128, 256, 512])
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    tokens = rng.integers(0, V, size=N + 100)

    def column(t):  # one token's lm_head column, the same for every draw
        return np.random.default_rng(int(t)).normal(size=D).astype(np.float32) * 0.02

    corpus = (np.stack([column(t) for t in tokens[:N]])
              + 0.01 * rng.normal(size=(N, D))).astype(np.float32)
    queries = {
        "held-out tokens": np.stack([column(t) for t in tokens[N:]])
        + 0.01 * rng.normal(size=(100, D)).astype(np.float32),
        "corpus tokens": np.stack([column(t) for t in tokens[:100]])
        + 0.01 * rng.normal(size=(100, D)).astype(np.float32),
    }
    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as root:
        cluster = make_local_cluster(root, num_executors=2, device=args.device)
        table = LakehouseTable(cluster.catalog, "memories")
        table.create(dim=D)
        table.append_vectors(corpus, num_files=4)
        files = [f.path for f in table.current_files()]
        rep = cluster.coordinator.create_index("memories", IndexConfig(
            name="mem_idx", R=16, L=32, partitions_per_shard=2, build_passes=1, build_batch=256))
        store = cluster.store
        reader = PuffinReader(store.stat(rep.puffin_path).size, store.range_reader(rep.puffin_path))
        graphs, rows = [], []
        for bm in reader.blobs_of_type(SHARD_BLOB_TYPE):
            g, loc = decode_shard_blob(reader.read_blob(bm), device=args.device)
            file_no = np.array([files.index(p) for p in loc.file_paths], np.int64)
            graphs.append(g)
            rows.append(ROWS_PER_FILE * file_no[loc.file_idx[: g.n]] + loc.row_offset[: g.n])
        index = DeviceAnnIndex.from_graphs(graphs, payloads=rows, device=args.device)
        for name, q in queries.items():
            _, truth = brute_force_topk(corpus, q, 8, device=args.device)
            for L in args.L:
                _d, got = make_probe_fn(k=8, L=L, device=args.device)(index, q)
                got = got.cpu().numpy()
                report = cluster.coordinator.probe("memories", q, 8, strategy="diskann", L=L)
                hits = np.array([[ROWS_PER_FILE * files.index(h.file_path) + h.row_offset
                                  for h in hs] for hs in report.hits])
                print(f"{name:15s} L={L:4d}: device recall@8 {recall_at_k(got, truth):.4f} "
                      f"(recall@1 {recall_at_k(got[:, :1], truth[:, :1]):.4f}), coordinator "
                      f"recall@8 {recall_at_k(hits, truth):.4f}", flush=True)


if __name__ == "__main__":
    main()
