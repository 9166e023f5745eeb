"""The recurrent and MoE families' mesh steps give the unsharded steps'
values.

One 4-process gloo group on a (data=2, model=2) CPU mesh, f32 reduced
configs with scan chunks of 8 (32 tokens: four chunks):

- rwkv6 with 4 heads (split over ``model``, each device scans its own
  heads) and with 3 (replicated on ``model``, as rwkv6-3b's 40 heads are
  over 16 devices), and zamba2 at 2 layers with the shared attention
  block after them (``shared_attn_every=2``);
- ``forward``, prefill of 32 tokens + 4 decode steps through
  ``make_serve_fns``, and one ``train_step`` (2 microbatches, AdamW): its
  loss, gradient norm, first moments (``(1 - b1) * grad`` after one step)
  and one gradient leaf's, and the updated params;
- mixtral with its MoE groups cut to 16 tokens (the token groups split
  over ``data``): 4 experts (split over ``model``: each device runs its
  experts), 3 (``d_model`` split over ``model``: the first contraction's
  pending sum all-reduced) and 3 under ``expert_mlp="model"`` (the ff dim
  split over ``model``: ``wi`` re-split from ``d_model`` by an
  all-to-all), each through the three steps below;
- each against the same step with ``mesh=None``, within the tolerances of
  ``test_torch_mesh_layout.py`` and ``test_torch_dryrun.py`` (the
  reductions split over ranks sum in another order).
- zamba2 at 6 layers (the shared block after them), where f32 rounding
  alone moves the logits by ~1e-5 (more than those tolerances): its
  forward on the mesh and with ``mesh=None`` against a float64 oracle (the
  same model run in float64), the mesh's error within twice the unsharded
  forward's own.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

FWD_TOL = 1e-5  # f32 logits, of a logit scale ~1
TRAIN_TOL = dict(loss=1e-6, grad_norm=1e-6, m=1e-5, params=2e-4)
MOE_GROUP = 16  # tokens in a MoE group: 4-8 groups a step, split over data
CONFIGS = {  # name: (arch, overrides, the leaf whose gradient is reported, rule overrides)
    "rwkv6-split-heads": ("rwkv6-3b", {}, ("layers", "tmix", "wr"), {}),
    "rwkv6-whole-heads": ("rwkv6-3b", {"ssm_heads": 3}, ("layers", "tmix", "wr"), {}),
    "zamba2": ("zamba2-1.2b", {"num_layers": 2, "shared_attn_every": 2}, ("layers", "mixer", "w_x"), {}),
    "mixtral-experts": ("mixtral-8x7b", {}, ("layers", "moe", "wi_gate"), {}),
    "mixtral-embed": ("mixtral-8x7b", {"num_experts": 3}, ("layers", "moe", "wo"), {}),
    "mixtral-ff": ("mixtral-8x7b", {"num_experts": 3}, ("layers", "moe", "wi_up"),
                   {"expert_mlp": "model"}),
}


def _worker(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)  # four processes share the machine's cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
    try:
        _steps(rank, out)
    finally:
        dist.destroy_process_group()


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _max_err(a, b):
    return max((x - y).abs().max().item() for x, y in zip(a, b))


def _steps(rank: int, out: str) -> None:
    from functools import partial

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.specs import SERVE_RULES
    from repro_torch.models import mamba2, moe, rwkv6
    from repro_torch.models.model import build_model, param_shapes
    from repro_torch.models.sharding import (
        DEFAULT_RULES, NamedSharding, implicit_replication, logical_to_sharding, place,
        place_tree, spec_for, with_rules,
    )
    from repro_torch.serving.serve_loop import ServeConfig, make_serve_fns
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_loop import TrainStepConfig, init_train_state, make_train_step

    # scan chunks of 8: the 32-token sequences take four chunks
    rwkv6.rwkv6_chunked = partial(rwkv6.rwkv6_chunked, chunk=8)
    mamba2.mamba2_chunked = partial(mamba2.mamba2_chunked, chunk=8)
    moe.moe_block = partial(moe.moe_block, group_size=MOE_GROUP)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    B, S, G = 4, 32, 4
    report = {}
    for name, (arch, over, leaf, rule_over) in CONFIGS.items():
        rules, serve_rules = (with_rules(r, **rule_over) for r in (DEFAULT_RULES, SERVE_RULES))
        cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32", **over)
        model = build_model(cfg, tp=2, device="cpu")
        params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
        rng = np.random.default_rng(0)
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
        fed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (G, B, 1)))
        r = report[name] = {}

        sh = logical_to_sharding(model.axes, rules, mesh, shapes_tree=param_shapes(model))
        ids_sh = NamedSharding(mesh, spec_for(("batch", "seq"), rules, mesh))
        with implicit_replication():
            logits, _ = model.forward(place_tree(params, sh), place(ids, ids_sh))
        want, _ = model.forward(params, ids)
        r["forward_err"] = (logits.full_tensor() - want).abs().max().item()
        r["logit_scale"] = want.abs().max().item()

        runs = []
        for m in (None, mesh):
            prefill, decode, _sample, _ = make_serve_fns(
                model, m, serve_rules if m is not None else None, ServeConfig(param_dtype="float32"),
                batch_hint=B, max_len_hint=S + G, device="cpu")
            lg, cache = prefill(params, ids, model.init_cache(B, S + G))
            seq = [_whole(lg)]
            for t in range(G):
                lg, cache = decode(params, fed[t], cache, S + t)
                seq.append(_whole(lg))
            runs.append(seq)
        r["serve_errs"] = [(a - b).abs().max().item() for a, b in zip(*runs)]

        labels = torch.roll(ids, -1, 1)
        res = []
        for m in (None, mesh):
            p, o = init_train_state(model, m, rules, seed=0)
            step, _ = make_train_step(model, m, rules, cfg=TrainStepConfig(microbatches=2, lr=1e-3),
                                      device="cpu")
            p, o, met = step(p, o, ids, labels)
            g = o.m
            for key in leaf:
                g = g[key]
            res.append(dict(loss=float(_whole(met["loss"])), grad_norm=float(_whole(met["grad_norm"])),
                            params=[_whole(x) for x in tree_leaves(p)],
                            m=[_whole(x) for x in tree_leaves(o.m)], leaf=_whole(g)))
        a, b = res
        r["train"] = dict(
            loss=(a["loss"], b["loss"]), grad_norm=(a["grad_norm"], b["grad_norm"]),
            params_err=_max_err(a["params"], b["params"]),
            m_err=_max_err(a["m"], b["m"]), m_scale=max(x.abs().max().item() for x in a["m"]),
            leaf_err=(a["leaf"] - b["leaf"]).abs().max().item(),
            leaf_scale=a["leaf"].abs().max().item(),
        )

    # zamba2 at 6 layers: both f32 forwards against a float64 oracle
    cfg = dataclasses.replace(reduced(get_config("zamba2-1.2b")), dtype="float32", num_layers=6)
    model = build_model(cfg, tp=2, device="cpu")
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)))
    sh = logical_to_sharding(model.axes, DEFAULT_RULES, mesh, shapes_tree=param_shapes(model))
    with implicit_replication():
        logits, _ = model.forward(place_tree(params, sh), place(ids, ids_sh))
    want, _ = model.forward(params, ids)
    oracle = build_model(cfg, tp=2, device="cpu")
    oracle.dtype = torch.float64  # the compute dtype; the params cast below
    exact, _ = oracle.forward(tree_map(lambda t: t.double(), params), ids)
    report["zamba2-6-layers"] = dict(
        mesh_err=(logits.full_tensor().double() - exact).abs().max().item(),
        plain_err=(want.double() - exact).abs().max().item())
    if rank == 0:
        with open(out, "w") as f:
            json.dump(report, f)


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh")
    out = tmp / "report.json"
    mp.spawn(_worker, args=(4, str(tmp / "store"), str(out)), nprocs=4, join=True)
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_serving_on_a_four_process_mesh(report, name):
    r = report[name]
    assert r["logit_scale"] > 0.01, r
    assert r["forward_err"] < FWD_TOL, r
    assert len(r["serve_errs"]) == 5 and max(r["serve_errs"]) < FWD_TOL, r


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_on_a_four_process_mesh(report, name):
    t = report[name]["train"]
    assert abs(t["loss"][0] - t["loss"][1]) <= TRAIN_TOL["loss"] * abs(t["loss"][0]), t
    assert abs(t["grad_norm"][0] - t["grad_norm"][1]) <= TRAIN_TOL["grad_norm"] * t["grad_norm"][0], t
    assert t["leaf_scale"] > 0, t
    assert t["leaf_err"] <= TRAIN_TOL["m"] * t["leaf_scale"], t
    assert t["m_err"] <= TRAIN_TOL["m"] * t["m_scale"], t
    assert t["params_err"] <= TRAIN_TOL["params"], t


def test_deeper_zamba2_forward_against_a_float64_oracle(report):
    r = report["zamba2-6-layers"]
    assert 0 < r["plain_err"] < 1e-4, r
    assert r["mesh_err"] <= 2 * r["plain_err"], r
