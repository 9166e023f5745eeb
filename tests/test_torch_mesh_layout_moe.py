"""Where the MoE families' mesh steps move data, against the reference's
program.

- In subprocesses, on a fake group of 256 ranks (the (data=16, model=16)
  mesh), dbrx-132b (16 experts: each device of ``model`` runs its own) and
  mixtral-8x7b (8 experts: ``d_model`` over ``model`` in the train step,
  the ff dim under the serving rules' ``expert_mlp="model"``) at their
  published widths, traced at 2 layers: train_4k and prefill_32k.  Each
  row moves at most 1.5x the reference's global collective bytes and no
  more than the port's own row before the MoE block ran on each device's
  block, both scaled to 2 of the published layers (the full-depth figures
  committed below: the reference's ``run_cell`` takes no overrides);
  all-reduce is its largest kind; no collective is issued at
  ``bmm.default``, where DTensor moved the expert contractions'
  activations between a token split and an ff split; dbrx-132b's rows and
  the prefill rows are compute-bound on the H100 roofline (mixtral's train
  row, whose all-reduces of the first contraction's pending sums cross
  nodes on ``model``, is collective-bound there, as the port's row was
  before: recorded, not held).
- A one-rank mesh runs mixtral's reduced forward and train step bit for
  bit as ``mesh=None`` (every split is ``Replicate()``, so the MoE block
  takes its plain path).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parents[1] / "src")

# global collective bytes on the (16, 16) mesh at full depth: the
# reference's (``python -m repro.launch.dryrun --arch A --shape S --mesh
# single``, jax 0.9.0 on the CPU) and the port's before the MoE block ran
# on each device's block (``python -m repro_torch.launch.dryrun``, the same
# cell)
REFERENCE = {
    ("dbrx-132b", "train_4k"): 3.300e13,
    ("dbrx-132b", "prefill_32k"): 1.244e13,
    ("mixtral-8x7b", "train_4k"): 8.411e13,
    ("mixtral-8x7b", "prefill_32k"): 1.213e13,
}
BEFORE = {
    ("dbrx-132b", "train_4k"): 5.406e13,
    ("dbrx-132b", "prefill_32k"): 3.362e12,
    ("mixtral-8x7b", "train_4k"): 2.219e13,
    ("mixtral-8x7b", "prefill_32k"): 3.457e12,
}
COMPUTE_BOUND = {cell for cell in REFERENCE if cell != ("mixtral-8x7b", "train_4k")}
FULL_DEPTH = {"dbrx-132b": 40, "mixtral-8x7b": 32}
LAYERS = 2
CELLS = {arch: [(arch, shape) for shape in ("train_4k", "prefill_32k")] for arch in FULL_DEPTH}

_ROWS_SCRIPT = """
import json, sys
from repro_torch.launch import dryrun
rows = []
for arch, shape in json.loads(sys.argv[1]):
    rows.append(dryrun.run_cell(arch, shape, "single", cfg_overrides={"num_layers": %d}))
print("ROWS " + json.dumps(rows))
""" % LAYERS

_ONE_RANK_SCRIPT = """
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.models.model import build_model, param_shapes
from repro_torch.models.sharding import (DEFAULT_RULES, NamedSharding, implicit_replication,
                                         logical_to_sharding, place, place_tree, spec_for)
from repro_torch.training.train_loop import TrainStepConfig, init_train_state, make_train_step

dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 1), rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")), dtype="float32")
model = build_model(cfg, tp=1, device="cpu")
params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)))
sh = logical_to_sharding(model.axes, DEFAULT_RULES, mesh, shapes_tree=param_shapes(model))
with implicit_replication():
    logits, aux = model.forward(place_tree(params, sh),
                                place(ids, NamedSharding(mesh, spec_for(("batch", "seq"), DEFAULT_RULES, mesh))))
want, want_aux = model.forward(params, ids)
out = {"forward": bool(torch.equal(logits.full_tensor(), want)),
       "aux": bool(torch.equal(aux.full_tensor(), want_aux))}
res = []
for m in (None, mesh):
    p, o = init_train_state(model, m, seed=0)
    step, _ = make_train_step(model, m, cfg=TrainStepConfig(microbatches=2, lr=1e-3), device="cpu")
    p, o, met = step(p, o, ids, torch.roll(ids, -1, 1))
    whole = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    res.append((whole(met["loss"]), whole(met["grad_norm"]), whole(p["layers"]["moe"]["wo"])))
out["train"] = all(bool(torch.equal(a, b)) for a, b in zip(*res))
dist.destroy_process_group()
print("ONE " + json.dumps(out))
"""


def _start(script, *args):
    return subprocess.Popen([sys.executable, "-c", script, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env={**os.environ, "PYTHONPATH": SRC})


def _finish(proc, tag):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.split(tag + " ", 1)[1])


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each arch's rows and the one-rank run, three processes at once."""
    procs = {arch: _start(_ROWS_SCRIPT, json.dumps(cells)) for arch, cells in CELLS.items()}
    one = _start(_ONE_RANK_SCRIPT, str(tmp_path_factory.mktemp("one") / "store"))
    got = {"one": _finish(one, "ONE")}
    for arch, proc in procs.items():
        for cell, row in zip(CELLS[arch], _finish(proc, "ROWS")):
            got[cell] = row
    return got


@pytest.mark.parametrize("cell", [c for cells in CELLS.values() for c in cells],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_moe_rows_move_what_the_reference_moves(traced, cell):
    arch, shape = cell
    row = traced[cell]
    coll, rf = row["collectives"], row["roofline"]
    assert row["chips"] == 256 and row["traced_depths"] == [LAYERS], row["traced_depths"]
    scale = LAYERS / FULL_DEPTH[arch]
    got = coll["global_bytes"]
    assert got <= 1.5 * REFERENCE[cell] * scale, (got, REFERENCE[cell] * scale, coll["by_kind"])
    assert got <= BEFORE[cell] * scale, (got, BEFORE[cell] * scale, coll["by_kind"])
    by_kind = coll["by_kind"]
    assert max(by_kind, key=by_kind.get) == "all-reduce", by_kind
    assert "bmm.default" not in coll["by_op"], coll["by_op"]
    if cell in COMPUTE_BOUND:
        assert rf["bottleneck"] == "compute", rf


def test_one_rank_mesh_is_bit_for_bit(traced):
    assert traced["one"] == {"forward": True, "aux": True, "train": True}


def test_param_builder_defaults_to_the_card():
    """``ParamBuilder`` and ``_init_params`` take the card unless the caller
    names another device; an abstract build needs none."""
    import inspect

    from repro_torch.models import model
    from repro_torch.models.layers import ParamBuilder

    assert ParamBuilder(None, device="cpu").device.type == "cpu"
    assert ParamBuilder(None, abstract=True).device.type == "meta"
    assert inspect.signature(model._init_params).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ParamBuilder(None)
