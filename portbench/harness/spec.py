"""What a cell is, read from ``BENCHMARK.json`` and the files it names.

A workload names a configuration and a traffic mix; the harness finds
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py`` by those names, so a later change adds a cell, a
configuration or a metric by adding files and entries alone.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    config_path: Path
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _applies(entry: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in e2e_names


def load(workload: str, bench_path: Path = ROOT / "BENCHMARK.json",
         traffic: Path = HERE / "traffic") -> Cell:
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_path.name}: {sorted(cells)}")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg_path = ROOT / cfg_entry["file"]
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, e2e_names)]
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=json.loads(cfg_path.read_text()),
        config_path=cfg_path,
        traffic=json.loads((traffic / f"{w['traffic']}.json").read_text()),
        end_to_end=[Metric(m["name"], m["unit"], m["better"], m["source"]) for m in e2e],
        per_layer=[Metric(m["name"], m["unit"], m["better"], m["source"]) for m in per_layer],
    )


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read(obs)``: the metric's value, or None
    where the run had nothing to read."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m.name: reader(m.name) for m in cell.per_layer}
