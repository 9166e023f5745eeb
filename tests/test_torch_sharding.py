"""The port's logical-axis sharding rules (``repro_torch.models.sharding``).

- ``tests/test_sharding.py``'s eight cases against the port, on a 1 x 1
  debug mesh (a one-rank gloo group, torn down after the module).
- Parity sweep: every parameter and cache leaf of all ten architectures
  (built at the mesh's model-axis size, as ``build_cell`` builds them), on
  the meshes (1, 1), (2, 2), (16, 16) and (2, 16, 16), under
  ``DEFAULT_RULES``, ``SERVE_RULES``, the ZeRO-1 moment rules and the
  expert-1D serve rule: the port's ``spec_for`` entries equal the
  reference's ``spec_for`` on a ``jax.sharding.AbstractMesh`` of the same
  shape, with the leaf's ``dim_sizes``, and the port's shard shape equals
  ``NamedSharding(AbstractMesh, spec).shard_shape``.  The port's axes trees
  equal the reference's.
- The spec -> DTensor placements map, and its refusal of a tuple entry in
  another order than the mesh's.
- The launchers' mesh: a reduced config on the 1 x 1 debug mesh, a
  published one launched alone on its one card with no mesh, where both
  launchers check that it fits (and refuse the CPU).
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.models.sharding import spec_for as ref_spec_for  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    destroy, launch_mesh, make_debug_mesh, make_production_mesh,
)
from repro_torch.launch.specs import SERVE_RULES  # noqa: E402
from repro_torch.models.model import build_model, cache_shapes, param_shapes  # noqa: E402
from repro_torch.models.sharding import (  # noqa: E402
    DEFAULT_RULES,
    AbstractMesh,
    NamedSharding,
    PartitionSpec as P,
    logical_to_sharding,
    placements_for,
    resolve_rule,
    spec_for,
    with_rules,
)


@pytest.fixture(scope="module")
def mesh():
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    m = make_debug_mesh(1, 1, device="cpu")
    yield m
    destroy()


# ---------------------------------------------------------------------------
# tests/test_sharding.py, against the port
# ---------------------------------------------------------------------------


def test_resolve_drops_missing_axes(mesh):
    assert resolve_rule(("pod", "data"), ["data", "model"]) == "data"
    assert resolve_rule("pod", ["data", "model"]) is None
    assert resolve_rule(None, ["data"]) is None


def test_spec_for_basic(mesh):
    spec = spec_for(("batch", "seq", "embed"), DEFAULT_RULES, mesh)
    assert spec == P("data")  # pod dropped, seq/embed None trimmed


def test_spec_for_divisibility_fallback(mesh):
    # dim size 3 can't shard over data axis -> falls back to replicated
    spec = spec_for(("batch",), DEFAULT_RULES, mesh, dim_sizes=(3,))
    # with a size-1 mesh everything divides; the strict case on a 2-wide
    # abstract mesh raises, the lax one replicates
    assert isinstance(spec, P)
    two = AbstractMesh((2, 1), ("data", "model"))
    assert spec_for(("batch",), DEFAULT_RULES, two, dim_sizes=(3,)) == P()
    with pytest.raises(ValueError, match="not divisible"):
        spec_for(("batch",), DEFAULT_RULES, two, dim_sizes=(3,), strict=True)


def test_no_duplicate_mesh_axes(mesh):
    # two logical dims mapping to the same mesh axis: second must drop
    rules = with_rules(DEFAULT_RULES, embed="model")
    spec = spec_for(("heads", "embed"), rules, mesh)
    flat = [a for a in spec if a is not None]
    assert len(flat) == len(set(flat))


def test_logical_to_sharding_tree(mesh):
    axes = {"w": ("embed", "mlp"), "b": ("mlp",), "nested": {"v": ("vocab", "embed")}}
    sh = logical_to_sharding(axes, DEFAULT_RULES, mesh)
    assert sh["w"].spec == P(None, "model")
    assert sh["nested"]["v"].spec == P("model")


def test_with_rules_override():
    rules = with_rules(DEFAULT_RULES, cache_seq="model")
    assert rules["cache_seq"] == "model"
    assert DEFAULT_RULES["cache_seq"] is None  # original untouched


def test_mesh_factory_requires_devices(mesh):
    with pytest.raises(RuntimeError):
        make_production_mesh(device_type="cpu")  # a one-rank group here


def test_launch_mesh_keeps_one_card_for_a_published_config(mesh):
    assert launch_mesh(True, "cpu").shape == (1, 1)
    assert launch_mesh(False, "cpu") is None  # a one-rank group: one card, no mesh


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_full_launch_alone_takes_the_one_card_route(mesh, launcher):
    """``--full`` in one process checks the model against one card (here:
    refuses the CPU) instead of asking for the production mesh's group."""
    import importlib

    main = importlib.import_module(f"repro_torch.launch.{launcher}").main
    with pytest.raises(ValueError, match="published widths on the card"):
        main(["--arch", "qwen2.5-3b", "--full", "--device", "cpu"])


def test_divisibility_fallback_with_shapes(mesh):
    axes = {"w": ("kv_heads", "head_dim")}
    shapes = {"w": torch.empty((2, 128), device="meta")}
    sh = logical_to_sharding(axes, DEFAULT_RULES, mesh, shapes_tree=shapes)
    # mesh model axis = 1 here so it divides; the sweep below covers the
    # 16-way case — this asserts the API accepts shape trees
    assert sh["w"].spec is not None


# ---------------------------------------------------------------------------
# parity sweep against the reference's spec_for
# ---------------------------------------------------------------------------

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
RULES = {
    "default": DEFAULT_RULES,
    "serve": SERVE_RULES,
    "zero1": with_rules(DEFAULT_RULES, embed=("data",)),
    "serve_expert_1d": with_rules(SERVE_RULES, expert_mlp="model"),
}
CACHE_B, CACHE_S = 128, 4096


def _leaves(axes, shapes, path=""):
    """(path, logical axes, shape) of every leaf of parallel trees."""
    if isinstance(axes, dict):
        for k in axes:
            yield from _leaves(axes[k], shapes[k], f"{path}/{k}")
        return
    yield path, axes, tuple(shapes.shape)


def _ref_entries(spec):
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


def _ref_axes(tree):
    if isinstance(tree, dict):
        return {k: _ref_axes(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_parity_with_reference(arch, mesh_name):
    from jax.sharding import AbstractMesh as RefAbstractMesh
    from jax.sharding import NamedSharding as RefNamedSharding
    from jax.sharding import PartitionSpec as RefP

    sizes, names = MESHES[mesh_name]
    port_mesh = AbstractMesh(sizes, names)
    ref_mesh = RefAbstractMesh(sizes, names)
    tp = dict(zip(names, sizes))["model"]
    model = build_model(get_config(arch), tp=tp, device="meta")
    ref_model = ref_build_model(ref_get_config(arch), tp=tp)
    assert model.axes == _ref_axes(ref_model.axes)
    leaves = list(_leaves(model.axes, param_shapes(model)))
    leaves += list(_leaves(model.cache_axes(CACHE_B, CACHE_S), cache_shapes(model, CACHE_B, CACHE_S),
                           "cache"))
    for rname, rules in RULES.items():
        for path, axes, shape in leaves:
            got = spec_for(axes, rules, port_mesh, dim_sizes=shape)
            want = ref_spec_for(axes, rules, ref_mesh, dim_sizes=shape)
            assert tuple(got) == _ref_entries(want), (rname, path, axes, shape)
            ref_shard = RefNamedSharding(ref_mesh, RefP(*want)).shard_shape(shape)
            assert NamedSharding(port_mesh, got).shard_shape(shape) == tuple(ref_shard), (rname, path)


# ---------------------------------------------------------------------------
# spec -> placements
# ---------------------------------------------------------------------------


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    multi = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert placements_for(P(("pod", "data")), multi) == (Shard(0), Shard(0), Replicate())
    assert placements_for(P(None, "model"), multi) == (Replicate(), Replicate(), Shard(1))
    assert placements_for(P("data", None, "model"), multi) == (Replicate(), Shard(0), Shard(2))
    assert placements_for(P(), multi) == (Replicate(),) * 3
    single = AbstractMesh((16, 16), ("data", "model"))
    # the batch rule on the single-pod mesh: pod dropped
    spec = spec_for(("batch", "seq"), DEFAULT_RULES, single)
    assert placements_for(spec, single) == (Shard(0), Replicate())


def test_placements_refuse_an_order_the_mesh_cannot_express():
    multi = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    with pytest.raises(ValueError, match="out of the mesh's order"):
        placements_for(P(("data", "pod")), multi)
    with pytest.raises(ValueError, match="out of the mesh's order"):
        placements_for(P(None, ("model", "data")), multi)
