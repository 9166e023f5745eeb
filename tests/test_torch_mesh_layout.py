"""Where the port's mesh steps move data, against the reference's program.

- On a fake group of 256 ranks, the (data=16, model=16) mesh, qwen2.5-3b at
  its published widths and 2 layers: the decode and prefill steps' vocab-
  split embedding issues no collective at ``index.Tensor`` (the lookup
  gathers each device's rows and all-reduces them, where indexing the
  DTensor all-gathered the whole 0.62 GB bf16 table to every device), and
  the train step's cross entropy and embedding issue no all-gather: its
  collectives are the reference's kind, almost all all-reduce.
- On a real (data=2, model=2) mesh of four gloo processes: the vocab-split
  lookup, 2-D and codebook tables, forward and gradient, against the
  unsplit table, and musicgen's reduced model (codebook embedding) forward
  and train step against ``mesh=None``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parents[1] / "src")

_FAKE_MESH_SCRIPT = """
import json
from repro_torch.launch import dryrun
rows = {}
for shape in ("decode_32k", "prefill_32k", "train_4k"):
    rows[shape] = dryrun.run_cell("qwen2.5-3b", shape, "single", cfg_overrides={"num_layers": 2})
print("ROWS " + json.dumps(rows))
"""

@pytest.fixture(scope="module")
def rows():
    out = subprocess.run([sys.executable, "-c", _FAKE_MESH_SCRIPT], capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.split("ROWS ", 1)[1])


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_vocab_split_lookup_moves_no_table(rows, shape):
    coll = rows[shape]["collectives"]
    assert rows[shape]["chips"] == 256
    assert "index.Tensor" not in coll["by_op"], coll["by_op"]
    # the rows' and the blocks' all-reduces, nothing gathered
    assert set(coll["by_kind"]) == {"all-reduce"}, coll["by_kind"]


def test_decode_row_within_the_reference_scale(rows):
    # 2 layers: the embedding's and each block's two all-reduces of
    # (128, 1, 2048) bf16 rows over 16 devices (the full depth's row moves
    # 3.8e7 B; the reference's 7.65e7)
    assert rows["decode_32k"]["collectives"]["global_bytes"] <= 1.5e8


def test_train_step_reduces_where_the_reference_does(rows):
    coll = rows["train_4k"]["collectives"]
    by_op, by_kind = coll["by_op"], coll["by_kind"]
    for op in ("logsumexp.default", "index.Tensor", "amax.default", "exp.default", "mm.default",
               "bmm.default", "mul.Tensor"):
        assert op not in by_op, (op, by_op)
    assert max(by_kind, key=by_kind.get) == "all-reduce", by_kind
    # what is left to gather is ZeRO-1's: the AdamW moments (split over
    # data) meeting the params in the update
    assert by_kind.get("all-gather", 0) < 0.05 * coll["global_bytes"], by_kind
    assert rows["train_4k"]["roofline"]["bottleneck"] == "compute"


# ---------------------------------------------------------------------------
# a real (2, 2) mesh of four gloo processes
# ---------------------------------------------------------------------------

FWD_TOL = 1e-5  # f32 logits, of a logit scale ~1
TRAIN_TOL = dict(loss=1e-6, grad_norm=1e-6, m=1e-5, params=2e-4)
GRAD_TOL = 1e-6  # the table gradient's rows sum over the data split in another order


def _worker(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        _steps(rank, out)
    finally:
        dist.destroy_process_group()


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _steps(rank: int, out: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import get_config, reduced
    from repro_torch.models.model import build_model, param_shapes
    from repro_torch.models.sharding import (
        DEFAULT_RULES, NamedSharding, PartitionSpec, implicit_replication, logical_to_sharding,
        place, place_tree, spec_for, vocab_rows, vocab_split,
    )
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import TrainStepConfig, init_train_state, make_train_step

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rng = np.random.default_rng(3)
    report = {}

    # the lookup alone: (V, D) and (CB, V, D) tables split over model, ids
    # over data; ids repeat
    ids_sh = NamedSharding(mesh, spec_for(("batch", "seq"), DEFAULT_RULES, mesh))
    for name, shape, ids_shape in (("2d", (38, 6), (4, 9)), ("codebook", (3, 38, 6), (4, 9, 3))):
        table = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).requires_grad_(True)
        ids = torch.from_numpy(rng.integers(0, 38, ids_shape))
        w = torch.from_numpy(rng.normal(size=ids_shape[:2] + (6,)).astype(np.float32))
        want = table[ids] if name == "2d" else sum(table[c][ids[..., c]] for c in range(3))
        (want * w).sum().backward()
        vdim = len(shape) - 2
        split = place(table.detach(), NamedSharding(mesh, PartitionSpec(*(None,) * vdim, "model")))
        split.requires_grad_(True)
        assert vocab_split(split) == (1,) and split.placements == (Replicate(), Shard(vdim))
        with implicit_replication():
            got = vocab_rows(split, place(ids, ids_sh))
            (got * place(w, ids_sh)).sum().backward()
        report[name] = dict(
            fwd_equal=bool(torch.equal(got.full_tensor(), want)),
            fwd_err=(got.full_tensor() - want).abs().max().item(),
            grad_err=(split.grad.full_tensor() - table.grad).abs().max().item(),
            grad_scale=table.grad.abs().max().item(),
            batch_split_only=got.placements == (Shard(0), Replicate()),
        )

    # musicgen's reduced model: its codebook embedding on the mesh, forward
    # and one train step, against mesh=None
    cfg = dataclasses.replace(reduced(get_config("musicgen-medium")), dtype="float32")
    model = build_model(cfg, tp=2, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    B, S = 4, 8
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S, cfg.num_codebooks)))
    sh = logical_to_sharding(model.axes, DEFAULT_RULES, mesh, shapes_tree=param_shapes(model))
    placed = place_tree(params, sh)
    assert vocab_split(placed["embed"])
    ids3 = NamedSharding(mesh, spec_for(("batch", "seq", "codebook"), DEFAULT_RULES, mesh))
    with implicit_replication():
        logits, _ = model.forward(placed, place(ids, ids3))
    want, _ = model.forward(params, ids)
    report["forward_err"] = (logits.full_tensor() - want).abs().max().item()
    labels = torch.roll(ids, -1, 1)
    res = []
    for m in (None, mesh):
        p, o = init_train_state(model, m, seed=0)
        step, _ = make_train_step(model, m, cfg=TrainStepConfig(microbatches=2, lr=1e-3),
                                  device="cpu")
        p, o, met = step(p, o, ids, labels)
        res.append(dict(loss=float(_whole(met["loss"])), grad_norm=float(_whole(met["grad_norm"])),
                        params=[_whole(x) for x in tree_leaves(p)],
                        m=[_whole(x) for x in tree_leaves(o.m)]))
    a, b = res
    report["train"] = dict(
        loss=(a["loss"], b["loss"]), grad_norm=(a["grad_norm"], b["grad_norm"]),
        params_err=max((x - y).abs().max().item() for x, y in zip(a["params"], b["params"])),
        m_err=max((x - y).abs().max().item() for x, y in zip(a["m"], b["m"])),
        m_scale=max(x.abs().max().item() for x in a["m"]),
    )
    if rank == 0:
        with open(out, "w") as f:
            json.dump(report, f)


@pytest.fixture(scope="module")
def mesh_report(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh")
    out = tmp / "report.json"
    mp.spawn(_worker, args=(4, str(tmp / "store"), str(out)), nprocs=4, join=True)
    return json.loads(out.read_text())


@pytest.mark.parametrize("table", ["2d", "codebook"])
def test_vocab_split_lookup_on_a_four_process_mesh(mesh_report, table):
    r = mesh_report[table]
    # batch over data, whole over model: the rows' sum is reduced inside
    assert r["batch_split_only"], r
    if table == "2d":  # one nonzero term a row: the sum is exact
        assert r["fwd_equal"], r
    else:  # the codebooks' rows summed in another order
        assert r["fwd_err"] < FWD_TOL, r
    assert r["grad_err"] <= GRAD_TOL * r["grad_scale"], r


def test_codebook_model_on_a_four_process_mesh(mesh_report):
    r = mesh_report
    assert r["forward_err"] < FWD_TOL, r["forward_err"]
    t = r["train"]
    assert abs(t["loss"][0] - t["loss"][1]) <= TRAIN_TOL["loss"] * abs(t["loss"][0]), t
    assert abs(t["grad_norm"][0] - t["grad_norm"][1]) <= TRAIN_TOL["grad_norm"] * t["grad_norm"][0], t
    assert t["m_err"] <= TRAIN_TOL["m"] * t["m_scale"], t
    assert t["params_err"] <= TRAIN_TOL["params"], t
