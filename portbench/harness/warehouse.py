"""The cell's warehouse: an Iceberg table with its Puffin-bound index.

The first run of a configuration in a checkout builds it into
``portbench/.cache/<config>-<key>/``, where ``key`` hashes the configuration
file and every source of ``src/repro_torch``: it writes the corpus as the
table's data files, runs ``Coordinator.create_index``, and keeps the raw
corpus beside it (``corpus.npy``) for the reference.
The build goes to a fixed ``.building`` directory that is renamed when it is
complete, so a build that was cut off is never opened.

Later runs open the table at its snapshot, as a pool of stateless executors
would: the executors' SSD caches live beside the store, so after the first
probe of a checkout every shard blob is read from there and nothing is
written.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import numpy as np

from harness import data

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent
CACHE = HERE / ".cache"
SOURCES = ROOT / "src" / "repro_torch"
TABLE = "vectors"
INDEX = "idx"


@dataclass
class Warehouse:
    root: Path  # the cluster root: s3/ (the object store) and cache/ (SSD caches)
    meta: dict  # what the build recorded: files, snapshot, build report

    @property
    def files(self) -> List[Tuple[str, int]]:
        return [tuple(f) for f in self.meta["files"]]

    def corpus(self) -> np.ndarray:
        return np.load(self.root / "corpus.npy", mmap_mode="r")


def key(cfg_path: Path) -> str:
    h = hashlib.sha256(cfg_path.read_bytes())
    for p in sorted(SOURCES.rglob("*")):
        if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".h", ".json"):
            h.update(str(p.relative_to(SOURCES)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def index_config(cfg: dict):
    from repro_torch.runtime.coordinator import IndexConfig

    return IndexConfig(name=INDEX, metric=cfg["metric"], num_shards=cfg["shards"], **cfg["index"])


def open_or_build(cfg: dict, cfg_path: Path, device, log, cache: Path = CACHE) -> Warehouse:
    """The configuration's warehouse, built first if this checkout has none."""
    final = cache / f"{cfg['name']}-{key(cfg_path)}"
    if not (final / "meta.json").exists():
        for old in cache.glob(f"{cfg['name']}-*"):  # other builds of this config
            shutil.rmtree(old)
        _build(cfg, final.with_name(final.name + ".building"), device, log)
        os.rename(final.with_name(final.name + ".building"), final)
    return Warehouse(final, json.loads((final / "meta.json").read_text()))


def _build(cfg: dict, root: Path, device, log) -> None:
    from repro_torch.lakehouse.table import LakehouseTable
    from repro_torch.runtime.cluster import make_local_cluster

    if root.exists():  # a build that was cut off
        shutil.rmtree(root)
    root.mkdir(parents=True)
    t0 = time.time()
    x, attrs = data.corpus(cfg)
    np.save(root / "corpus.npy", x)
    log(f"warehouse {cfg['name']}: corpus {x.shape} in {time.time() - t0:.1f} s")
    cluster = make_local_cluster(str(root), num_executors=cfg["executors"], device=device)
    table = LakehouseTable(cluster.catalog, TABLE)
    table.create(dim=cfg["dim"])
    t0 = time.time()
    table.append_vectors(x, num_files=cfg["files"], rows_per_group=cfg["rows_per_group"],
                         attributes=attrs)
    log(f"warehouse {cfg['name']}: {cfg['files']} files written in {time.time() - t0:.1f} s")
    t0 = time.time()
    rep = cluster.coordinator.create_index(TABLE, index_config(cfg))
    build_s = time.time() - t0
    if rep.vector_count != x.shape[0]:
        raise RuntimeError(f"index holds {rep.vector_count} vectors, expected {x.shape[0]}")
    log(f"warehouse {cfg['name']}: create_index {build_s:.1f} s (stage 0 {rep.stage0_seconds:.2f}, "
        f"stage 1 {rep.stage1_seconds:.2f}, stage 2 {rep.stage2_seconds:.2f} s), "
        f"{rep.num_shards} shards, puffin {rep.total_bytes} B")
    # one probe, so that each executor's SSD cache holds its shards: every
    # later run of the checkout reads them from there and writes nothing
    cluster.coordinator.probe_batch(TABLE, x[:1], cfg["k"])
    meta = dict(
        files=[(f.path, f.record_count) for f in table.current_files()],
        snapshot_id=rep.snapshot_id,
        puffin=rep.puffin_path,
        puffin_bytes=rep.total_bytes,
        build_seconds=build_s,
        stage_seconds=[rep.stage0_seconds, rep.stage1_seconds, rep.stage2_seconds],
    )
    (root / "meta.json").write_text(json.dumps(meta))
