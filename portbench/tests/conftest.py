"""Fixtures of the harness's CPU tests: a tiny configuration of the same
semantics (1,500 rows of 16 dimensions, two shards), its traffic files and a
``BENCHMARK.json`` naming them, built once a session in a temporary
directory.  The program runs its plain PyTorch path on the CPU."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent
for p in (str(HERE), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_files(tmp: Path) -> dict:
    cfg = json.loads((HERE / "configs" / "sift1m.json").read_text())
    cfg.update(name="tiny", rows=1500, dim=16, files=2, rows_per_group=256, executors=2, shards=2,
               index={"R": 32, "L": 64, "alpha": 1.2, "pq_m": 4, "pq_nbits": 8, "build_batch": 128,
                      "include_vectors": True})
    cfg["data"].update(components=16, rank=4)
    (tmp / "tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0], name="tiny", file=str(tmp / "tiny.json"))]
    for w in bench["workloads"]:
        w["config"] = "tiny"
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = tmp / "traffic"
    traffic.mkdir()
    for path in (HERE / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(clients=16, max_batch=16, max_qps=300)
        (traffic / path.name).write_text(json.dumps(t))
    return dict(bench=tmp / "BENCHMARK.json", traffic=traffic, cache=tmp / "cache")


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """Paths of the tiny cell's files; its warehouse is built on first use."""
    torch.set_num_threads(2)
    return tiny_files(tmp_path_factory.mktemp("portbench"))


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal of a machine without a CUDA device")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest portbench/tests -k card)")
    return torch.device("cuda")
