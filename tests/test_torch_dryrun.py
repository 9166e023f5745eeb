"""The port's dry-runs and its sharded steps on a real mesh.

- In a subprocess (a fake group of 8 ranks, the (data=2, model=4) mesh):
  ``build_cell`` / ``dryrun.run_cell`` on each dense architecture's reduced
  config (decode_32k and prefill_32k; train_4k for qwen2.5 and musicgen),
  ``probe_dryrun.run`` (also on a (pod=2, data=2, model=2) mesh) and one
  hillclimb variant.  Rows carry the reference's keys, no dense cell is an
  error row, the non-subquadratic long_500k is a skip row, and
  ``hbm_per_chip_gb`` is the port-dtype arithmetic (bf16 vectors, int64
  adjacency / payload / counts).  The probe's per-device terms divide by
  the devices that hold distinct shards (a second pod repeats the first's
  work), and its compute term takes the f32 peak.
- ``python -m repro_torch.launch.dryrun`` for one cell: a restartable row
  in ``--out``, and nothing written to the reference's ``results/``.
- One 4-process gloo group on a (data=2, model=2) CPU mesh: reduced
  qwen2.5 ``forward``, prefill + 4 decode steps with the mesh probe fused
  (kNN-LM, lambda 0.3, 4 shards over ``data``), and one ``train_step``
  (2 microbatches, AdamW) each equal the same step with ``mesh=None``
  within the stated tolerances (the reductions split over ranks sum in
  another order), and every parameter's local block has the shape of the
  reference's ``NamedSharding(AbstractMesh, spec).shard_shape``.
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
DENSE = ["qwen2.5-3b", "phi4-mini-3.8b", "minitron-8b", "chatglm3-6b", "chameleon-34b",
         "musicgen-medium"]

# the reference's row keys (repro/launch/dryrun.py:run_cell)
ROW_KEYS = {"arch", "shape", "mesh", "chips", "kind", "lower_s", "compile_s", "memory_analysis",
            "cost_analysis", "collectives", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"}
COLLECTIVE_KEYS = {"raw_bytes", "corrected_bytes", "global_bytes", "by_kind", "ops"}
ROOFLINE_KEYS = {"chips", "hlo_flops_raw", "hlo_bytes_raw", "jaxpr_flops", "model_bytes",
                 "coll_bytes_raw", "coll_bytes", "dcn_bytes", "model_flops", "t_compute",
                 "t_memory", "t_collective", "bottleneck", "useful_ratio", "roofline_fraction"}

_FAKE_MESH_SCRIPT = """
import dataclasses, json, sys
from repro_torch.launch.mesh import init_fake_world
init_fake_world(8)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun, hillclimb, probe_dryrun

mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))

def over(arch):
    full, red = get_config(arch), reduced(get_config(arch))
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(full)
            if getattr(red, f.name) != getattr(full, f.name)}

rows = []
for arch, shape in json.loads(sys.argv[1]):
    rows.append(dryrun.run_cell(arch, shape, "single", mesh=mesh, microbatches=2,
                                cfg_overrides=over(arch)))
# a second mesh of the same layout: DTensor may reuse the first's groups
again = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
rows.append(dict(dryrun.run_cell("qwen2.5-3b", "decode_32k", "single", mesh=again,
                                 cfg_overrides=over("qwen2.5-3b")), shape="decode_32k again"))
probe = probe_dryrun.run("single", mesh=mesh)
pods = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
probe_pods = probe_dryrun.run("multi", mesh=pods)
variant = hillclimb.run_variant("chatglm3.base", hillclimb.VARIANTS["chatglm3.base"], mesh=mesh)
print("ROWS " + json.dumps({"cells": rows, "probe": probe, "probe_pods": probe_pods,
                            "variant": variant}))
"""


def test_dry_run_rows_on_a_fake_mesh():
    cells = [(a, s) for a in DENSE for s in ("decode_32k", "prefill_32k")]
    cells += [("qwen2.5-3b", "train_4k"), ("musicgen-medium", "train_4k"), ("qwen2.5-3b", "long_500k")]
    out = subprocess.run([sys.executable, "-c", _FAKE_MESH_SCRIPT, json.dumps(cells)],
                         capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": SRC})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.split("ROWS ", 1)[1])
    rows = {(r["arch"], r["shape"]): r for r in got["cells"]}
    for (arch, shape), r in rows.items():
        assert r["chips"] == 8
        if shape == "long_500k":
            assert r["kind"] == "skip" and "quadratic" in r["skip_reason"]
            continue
        assert r["kind"] in ("train", "prefill", "decode"), r
        assert ROW_KEYS <= set(r), (arch, shape, set(r))
        assert MEMORY_KEYS <= set(r["memory_analysis"])
        assert COLLECTIVE_KEYS <= set(r["collectives"])
        assert ROOFLINE_KEYS <= set(r["roofline"])
        assert r["memory_analysis"]["argument_bytes"] > 0 and r["memory_analysis"]["temp_bytes"] is None
        rf = r["roofline"]
        assert rf["jaxpr_flops"] > 0 and rf["model_flops"] > 0 and rf["t_compute"] > 0
        assert rf["bottleneck"] in ("compute", "memory", "collective")
        assert r["cost_analysis"]["dot_flops"] <= r["cost_analysis"]["flops"]
        # a (2, 4) mesh fits one node of eight: every collective on NVLink
        assert r["collectives"]["ib_bytes"] == 0.0
    # collectives are filed under their mesh axes on a later mesh too
    again = rows[("qwen2.5-3b", "decode_32k again")]
    assert again["collectives"]["by_axis"] == rows[("qwen2.5-3b", "decode_32k")]["collectives"]["by_axis"]
    assert set(again["collectives"]["by_axis"]) <= {"data", "model"}
    # the decode step reads all params once: useful work within 2x of the traced
    assert 0.5 < rows[("qwen2.5-3b", "decode_32k")]["roofline"]["useful_ratio"] <= 1.0
    # backward and the remat recompute: more traced FLOPs than 6·N·D
    assert rows[("qwen2.5-3b", "train_4k")]["roofline"]["useful_ratio"] < 1.0

    probe = got["probe"]
    idx = probe["index"]
    assert (idx["N"], idx["D"], idx["R"], idx["L"], idx["K"], idx["Q"]) == (10**9, 768, 64, 100, 100, 64)
    assert idx["shards"] == 8 and idx["cap"] == 1 << 27  # 10^9 / 8 rounded up to a power of 2
    want_gb = idx["cap"] * (768 * 2 + 64 * 8 + 8) / 1e9 + 16 / 1e9
    assert idx["hbm_per_chip_gb"] == round(want_gb, 2)
    assert probe["memory_analysis"]["argument_bytes"] >= idx["cap"] * (768 * 2 + 64 * 8 + 8)
    assert probe["collectives"]["by_kind"].keys() == {"all-gather"}
    assert probe["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    # per device of those holding a distinct shard: one shard's gathers
    # whatever the mesh, each pod of two repeating the other's work
    pods = got["probe_pods"]
    assert (pods["chips"], pods["index"]["shards"], pods["roofline"]["devices_dividing"]) == (8, 4, 4)
    per_device_bytes = 64 * idx["expansions"] * 64 * (768 * 2 + 8) / 3.35e12
    for row in (probe, pods):
        rf = row["roofline"]
        assert rf["t_memory"] == pytest.approx(per_device_bytes)
        assert rf["t_compute"] == pytest.approx(rf["jaxpr_flops"] / (rf["devices_dividing"] * 67e12))

    variant = got["variant"]
    assert variant["variant"] == "chatglm3.base" and "error" not in variant
    assert variant["t_memory"] > 0 and variant["jaxpr_flops"] > 0


def test_dryrun_cli_writes_its_own_results(tmp_path):
    out = tmp_path / "results" / "torch" / "dryrun.jsonl"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2.5-3b", "--shape",
           "long_500k", "--mesh", "both", "--out", str(out)]
    env = {**os.environ, "PYTHONPATH": SRC}
    first = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert first.returncode == 0, first.stderr[-2000:]
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["mesh"], r["kind"], r["chips"]) for r in rows] == [("single", "skip", 256),
                                                                 ("multi", "skip", 512)]
    again = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert again.returncode == 0 and again.stdout.count("[skip-done]") == 2
    assert len(out.read_text().splitlines()) == 2
    assert not (tmp_path / "results" / "dryrun.jsonl").exists()
    from repro_torch.launch import dryrun

    assert dryrun.DEFAULT_OUT == "results/torch/dryrun.jsonl"


def test_moe_prefill_cell_traces_on_the_single_pod_mesh(tmp_path):
    """mixtral-8x7b × prefill_32k on (16, 16): the GShard dispatch hands
    back its groups split over more devices than the batch has rows; the
    block puts them back in the tokens' layout before they unflatten
    (DTensor would otherwise compute the wrong local shape)."""
    out = tmp_path / "mixtral.jsonl"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mixtral-8x7b", "--shape",
           "prefill_32k", "--mesh", "single", "--out", str(out)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr[-2000:]
    (row,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert row["kind"] == "prefill" and row["chips"] == 256
    assert row["cost_analysis"]["dot_flops"] > row["roofline"]["model_flops"] / 2


# ---------------------------------------------------------------------------
# a real (2, 2) mesh of four gloo processes
# ---------------------------------------------------------------------------

FWD_TOL = 1e-5  # f32 logits, of a logit scale ~1
TRAIN_TOL = dict(loss=1e-6, grad_norm=1e-6, m=1e-5, params=2e-4)


def _mesh_worker(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)  # four processes share the machine's cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        _mesh_steps(rank, out)
    finally:
        dist.destroy_process_group()


def _mesh_steps(rank: int, out: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.vamana import VamanaParams, build_vamana
    from repro_torch.launch.specs import SERVE_RULES
    from repro_torch.models.model import build_model, param_shapes
    from repro_torch.models.sharding import (
        DEFAULT_RULES, NamedSharding, implicit_replication, logical_to_sharding, place,
        place_tree, spec_for,
    )
    from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn
    from repro_torch.serving.serve_loop import ServeConfig, make_serve_fns
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.train_loop import TrainStepConfig, init_train_state, make_train_step

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), dtype="float32")
    model = build_model(cfg, tp=2, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    B, S, G = 4, 16, 4
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)))
    report = {}

    # forward
    sh = logical_to_sharding(model.axes, DEFAULT_RULES, mesh, shapes_tree=param_shapes(model))
    placed = place_tree(params, sh)
    ids_sh = NamedSharding(mesh, spec_for(("batch", "seq"), DEFAULT_RULES, mesh))
    with implicit_replication():
        logits, _ = model.forward(placed, place(ids, ids_sh))
    want, _ = model.forward(params, ids)
    report["forward_err"] = (logits.full_tensor() - want).abs().max().item()
    report["blocks"] = {"/".join(path): [list(t.to_local().shape), list(sh_.spec), list(t.shape)]
                        for path, t, sh_ in _walk(placed, sh)}

    # prefill + decode with the mesh probe (4 shards over data)
    rng = np.random.default_rng(1)
    toks = [rng.integers(0, cfg.vocab_size, 200) for _ in range(4)]
    head = params["lm_head"]
    graphs = [build_vamana((head[:, torch.from_numpy(t)].T.numpy()
                            + 0.01 * rng.normal(size=(200, cfg.d_model))).astype(np.float32),
                           VamanaParams(R=8, L=16), passes=1, batch=64, device="cpu") for t in toks]
    index = DeviceAnnIndex.from_graphs(graphs, payloads=toks, device="cpu")
    scfg = ServeConfig(param_dtype="float32", knn_lambda=0.3)
    runs = []
    for m in (None, mesh):
        probe = make_probe_fn(m, k=4, L=16, device="cpu")
        prefill, decode, sample, _ = make_serve_fns(
            model, m, SERVE_RULES if m is not None else None, scfg, retrieval=probe,
            index_template=index, batch_hint=B, max_len_hint=S + G, device="cpu")
        cache = model.init_cache(B, S + G)
        lg, cache = prefill(params, ids, cache)
        seq, tok = [_whole(lg)], sample(lg)
        for t in range(G):
            lg, cache = decode(params, tok, cache, S + t, index)
            seq.append(_whole(lg))
            tok = sample(lg)
        runs.append(seq)
    report["serve_errs"] = [(a - b).abs().max().item() for a, b in zip(*runs)]

    # one train step
    tcfg = TrainStepConfig(microbatches=2, lr=1e-3)
    labels = torch.roll(ids, -1, 1)
    res = []
    for m in (None, mesh):
        p, o = init_train_state(model, m, seed=0)
        step, _ = make_train_step(model, m, cfg=tcfg, device="cpu")
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


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _walk(tree, shardings, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _walk(tree[k], shardings[k], path + (k,))
        return
    yield path, tree, shardings


def test_sharded_steps_on_a_four_process_mesh(tmp_path):
    import torch.multiprocessing as mp

    out = tmp_path / "report.json"
    mp.spawn(_mesh_worker, args=(4, str(tmp_path / "store"), str(out)), nprocs=4, join=True)
    r = json.loads(out.read_text())
    assert r["forward_err"] < FWD_TOL, r["forward_err"]
    assert max(r["serve_errs"]) < FWD_TOL, r["serve_errs"]
    t = r["train"]
    assert abs(t["loss"][0] - t["loss"][1]) <= TRAIN_TOL["loss"] * abs(t["loss"][0])
    assert abs(t["grad_norm"][0] - t["grad_norm"][1]) <= TRAIN_TOL["grad_norm"] * t["grad_norm"][0]
    assert t["m_err"] <= TRAIN_TOL["m"] * t["m_scale"], t
    # AdamW divides by sqrt(v) + 1e-8: a gradient near 0 turns a 1e-9
    # difference into a visible share of lr (1e-3); 2e-4 bounds it here
    assert t["params_err"] <= TRAIN_TOL["params"], t

    jax = pytest.importorskip("jax")
    from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

    ref_mesh = AbstractMesh((2, 2), ("data", "model"))
    assert r["blocks"]
    for path, (local, spec, shape) in r["blocks"].items():
        spec = PartitionSpec(*[tuple(e) if isinstance(e, list) else e for e in spec])
        assert tuple(local) == tuple(NamedSharding(ref_mesh, spec).shard_shape(tuple(shape))), path


def _pod_worker(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.vamana import VamanaParams, build_vamana
    from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 1, 1), mesh_dim_names=("pod", "data", "model"))
        rng = np.random.default_rng(0)
        graphs = [build_vamana(rng.normal(size=(300, 8)).astype(np.float32), VamanaParams(R=8, L=16),
                               passes=1, batch=64, device="cpu") for _ in range(2)]
        index = DeviceAnnIndex.from_graphs(graphs, payloads=[np.arange(300), 1000 + np.arange(300)],
                                           device="cpu")
        q = rng.normal(size=(3, 8)).astype(np.float32)
        d0, p0 = make_probe_fn(None, k=4, L=16, device="cpu")(index, q)
        d1, p1 = make_probe_fn(mesh, k=4, L=16, shard_axes=("data", "model"), device="cpu")(index, q)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"one": [p0.tolist(), d0.tolist()],
                           "pods": [p1.to_local().tolist(), d1.to_local().tolist()]}, f)
    finally:
        dist.destroy_process_group()


def test_pod_mesh_probe_returns_each_hit_once(tmp_path):
    """Shards split over (data, model) and replicated over two pods: the
    mesh probe returns one device's hits, each once (the reference also
    gathers over ``pod`` and returns each twice)."""
    import torch.multiprocessing as mp

    out = tmp_path / "pods.json"
    mp.spawn(_pod_worker, args=(2, str(tmp_path / "store"), str(out)), nprocs=2, join=True)
    r = json.loads(out.read_text())
    assert r["pods"] == r["one"]
    assert all(len(set(row)) == len(row) for row in r["pods"][0])

