"""End-to-end example on the PyTorch/CUDA port: retrieval-augmented serving
with a snapshot-bound index.

    python3 examples/torch_serve_retrieval.py                 # on the card
    python3 examples/torch_serve_retrieval.py --device cpu    # the plain PyTorch path

``examples/serve_retrieval.py`` on ``repro_torch``: the same sizes and
printout.  A small LM handles batched decode requests while a kNN-LM probe
against the Puffin-backed index (built from lakehouse embeddings through the
full §5 protocol) interpolates its output distribution.  Reports decode
throughput with and without retrieval.  ``main`` returns the printed facts
as a dict, with the first decode step's logits shift under retrieval.

One repair against the reference: a shard's location map numbers its files
in its own ``file_paths`` order (the partitioner's, not the table's), so
the payload row of an indexed vector is found through that list; the
reference multiplies the shard-local file number by 1,000 as if it were the
table's, which gives half the corpus another row's token.
"""

import argparse
import dataclasses
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.blobs import SHARD_BLOB_TYPE, decode_shard_blob  # noqa: E402
from repro_torch.iceberg.puffin import PuffinReader  # noqa: E402
from repro_torch.kernels.device_cache import resolve_device  # noqa: E402
from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from repro_torch.models.model import build_model, torch_dtype  # noqa: E402
from repro_torch.runtime.cluster import make_local_cluster  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig  # noqa: E402
from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn  # noqa: E402
from repro_torch.serving.serve_loop import ServeConfig, make_serve_fns  # noqa: E402

ROWS_PER_FILE = 1000  # 4,000 corpus rows in 4 files


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    out = {}
    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), num_layers=4)
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    params = model.init(dtype=torch_dtype(ServeConfig().param_dtype))
    d = cfg.d_model

    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as root:
        # -- 1. embedding corpus lives in the lakehouse ----------------------
        print("== corpus -> lakehouse -> CREATE INDEX ==")
        cluster = make_local_cluster(root, num_executors=2, device=dev)
        table = LakehouseTable(cluster.catalog, "memories")
        table.create(dim=d)
        # corpus: lm_head-space embeddings of corpus tokens (kNN-LM keys)
        corpus_tokens = rng.integers(0, cfg.vocab_size, size=4000).astype(np.int64)
        head = params["lm_head"].float().cpu().numpy()  # (d, V)
        corpus_vecs = head[:, corpus_tokens].T + 0.01 * rng.normal(size=(4000, d)).astype(np.float32)
        table.append_vectors(corpus_vecs.astype(np.float32), num_files=4)
        files = [f.path for f in table.current_files()]
        rep = cluster.coordinator.create_index(
            "memories", IndexConfig(name="mem_idx", R=16, L=32,
                                    partitions_per_shard=2, build_passes=1, build_batch=256),
        )
        out.update(shards=rep.num_shards, snapshot=rep.snapshot_id)
        print(f"  index built: {rep.num_shards} shards, bound to snapshot {rep.snapshot_id}")

        # -- 2. upload the snapshot's shards into device memory --------------
        reader = PuffinReader(
            cluster.store.stat(rep.puffin_path).size, cluster.store.range_reader(rep.puffin_path)
        )
        graphs, payloads = [], []
        for bm in reader.blobs_of_type(SHARD_BLOB_TYPE):
            g, locmap = decode_shard_blob(reader.read_blob(bm), device=dev)
            graphs.append(g)
            # payload: the corpus token of each indexed vector (kNN-LM value),
            # found by the vector's global row through the shard's own files
            file_no = np.array([files.index(p) for p in locmap.file_paths], np.int64)
            rows = (ROWS_PER_FILE * file_no[locmap.file_idx[: g.n]]
                    + locmap.row_offset[: g.n].astype(np.int64))
            payloads.append(corpus_tokens[rows])
        index = DeviceAnnIndex.from_graphs(graphs, payloads=payloads, device=dev)
        probe = make_probe_fn(k=8, L=32, device=dev)

    # -- 3. batched serving, with and without retrieval ----------------------
    B, prompt_len, gen_len = 8, 16, 32
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, prompt_len))).to(dev)

    def run(retrieval, label):
        serve_cfg = ServeConfig(knn_lambda=0.3 if retrieval else 0.0)
        prefill, decode, sample, _ = make_serve_fns(
            model, cfg=serve_cfg, retrieval=probe if retrieval else None, device=dev,
        )
        cache = model.init_cache(B, prompt_len + gen_len)
        logits, cache = prefill(params, prompts, cache)
        tok = sample(logits)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        first = None
        for t in range(prompt_len, prompt_len + gen_len):
            logits, cache = decode(params, tok, cache, t, index if retrieval else None)
            if first is None:
                first = logits.float()
            tok = sample(logits)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        tps = B * gen_len / dt
        print(f"  {label:22s} {tps:8.1f} tok/s  ({dt/gen_len*1e3:.1f} ms/step, batch {B})")
        out[label] = dict(tok_s=tps, ms_step=dt / gen_len * 1e3)
        return first

    print("== batched serving ==")
    plain = run(False, "decode")
    mixed = run(True, "decode + kNN-LM probe")
    # the first step's inputs are equal (same prefill, greedy), so with
    # lambda = 0.3 the mixed log-probs differ from the plain ones only by
    # what the retrieved neighbours add
    out["knn_shift"] = float((mixed - torch.log_softmax(plain, dim=-1)).abs().max())
    print("done.")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    main(ap.parse_args().device)
