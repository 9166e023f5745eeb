"""The port's roofline machinery (``repro_torch.analysis``).

- ``tests/test_analysis.py``'s FLOP cases in torch: a plain matmul is
  exactly 2·64·128·32; a loop of 10 multiplies counts each trip (exactly,
  since the loop unrolls, and the same for one trip inside ``alike(10)``);
  the backward is more than twice the forward.
- The dry-run's folded attention (``launch.specs.folded_attention``) counts
  what the unfolded block loops count, op by op, for both schedules at
  S = 2,048 with and without a window, alone and in a model's forward.
- Its collective case as a traced function on a fake 8-rank (2, 4) mesh:
  one all-gather over the 4-rank axis and 7 all-reduces in a loop give
  the stated raw and global bytes (``corrected == raw``: loops unroll).
- Each family's reduced ``forward``: the port's matmul FLOPs equal the
  matmul FLOPs of the reference's jaxpr of its unsharded ``forward``
  exactly, summed by this file's own walk of ``dot_general`` (scan bodies
  times their length); on ``meta`` tensors and on real CPU tensors.
- The H100 roofline arithmetic on fixed inputs, and which mesh axes it
  charges to NVLink and to InfiniBand.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.analysis import roofline as RL  # noqa: E402
from repro_torch.analysis.flops import count_flops  # noqa: E402
from repro_torch.analysis.hlo import _shape_bytes, count_collectives  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, reduced  # noqa: E402
from repro_torch.models.model import build_model, param_shapes  # noqa: E402
from repro_torch.models.sharding import alike  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

META = torch.device("meta")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# tests/test_analysis.py's FLOP cases
# ---------------------------------------------------------------------------


def test_flops_plain_matmul():
    got = count_flops(lambda x, y: x @ y, _meta(64, 128), _meta(128, 32))
    assert got.dot == 2 * 64 * 128 * 32
    assert got.total == got.dot  # no elementwise op


def test_flops_loop_multiplies_by_length():
    w, x = _meta(16, 16), _meta(4, 16)

    def f(w, x):
        for _ in range(10):
            x = x @ w
        return x

    got = count_flops(f, w, x)
    assert got.dot == 10 * 2 * 4 * 16 * 16
    # one traced trip standing for the loop's ten counts the same
    with_fold = count_flops(lambda w, x: _folded(w, x, 10), w, x)
    assert with_fold.dot == got.dot
    # trips=: one traced trip of a data-dependent loop, counted n times
    assert count_flops(lambda w, x: x @ w, w, x, trips=10).dot == got.dot


def _folded(w, x, n):
    with alike(n):
        return x @ w


def test_flops_includes_backward():
    w = torch.randn(32, 32, requires_grad=True)
    x = torch.randn(8, 32)

    def loss(w, x):
        return torch.sum((x @ w) ** 2)

    def grad(w, x):
        return torch.autograd.grad(loss(w, x), w)[0]

    fwd = count_flops(loss, w, x)
    both = count_flops(grad, w, x)
    assert both.total > 2 * fwd.total  # bwd matmuls ≈ 2× fwd
    assert both.dot == 2 * fwd.dot  # the forward matmul and the weight gradient's


def test_shape_bytes():
    assert _shape_bytes((16, 512, 128), torch.bfloat16) == 16 * 512 * 128 * 2
    assert _shape_bytes((4,), torch.float32) + _shape_bytes((2, 2), torch.float32) == 16 + 16
    assert _shape_bytes((), torch.bool) == 1


# ---------------------------------------------------------------------------
# the dry-run's folded attention
# ---------------------------------------------------------------------------


class _Ops(TorchDispatchMode):
    """Counts the aten ops dispatched."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _counted(fn, *args):
    with _Ops() as ops:
        got = count_flops(fn, *args)
    return got, ops.n


def _same_counts(a, b):
    assert (a.dot, a.other) == (b.dot, b.other)
    assert dict(a.by_op) == dict(b.by_op)


@pytest.mark.parametrize("window", [0, 300])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_folded_attention_counts_equal_unfolded(sparse, window):
    """S = 2,048: 4 q blocks of 512 against 2 kv blocks of 1,024 (dense) or
    4 of 512 (sparse: 10 causal pairs, 7 inside a 300-token window)."""
    from repro_torch.launch.specs import folded_attention
    from repro_torch.models import layers

    q = _meta(2, 2048, 8, 16, dtype=torch.bfloat16)
    k, v = _meta(2, 2048, 4, 16, dtype=torch.bfloat16), _meta(2, 2048, 4, 16, dtype=torch.bfloat16)

    def attn(q, k, v):
        fn = layers.flash_attention_sparse if sparse else layers.flash_attention
        return fn(q, k, v, causal=True, window=window)

    plain, plain_ops = _counted(attn, q, k, v)
    with folded_attention():
        folded, folded_ops = _counted(attn, q, k, v)
    assert plain.dot > 0
    _same_counts(folded, plain)
    assert folded_ops < plain_ops / 2  # it did fold
    if sparse:
        pairs = layers.visible_pairs(4, 4, 512, 512, 0, True, window)
        assert len(pairs) == (7 if window else 10)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mixtral-8x7b"])
def test_folded_forward_counts_equal_unfolded(arch):
    """A reduced forward of 2,048 tokens (mixtral: a 64-token window)."""
    from repro_torch.launch.specs import folded_attention

    model = build_model(reduced(get_config(arch)), device=META)
    params = param_shapes(model)
    ids = torch.zeros((1, 2048), dtype=torch.int64, device=META)
    plain, plain_ops = _counted(model.forward, params, ids)
    with folded_attention():
        folded, folded_ops = _counted(model.forward, params, ids)
    _same_counts(folded, plain)
    assert folded_ops < plain_ops


# ---------------------------------------------------------------------------
# the collective case, traced on a fake (2, 4) mesh
# ---------------------------------------------------------------------------


def test_collectives_of_a_traced_function():
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import destroy, init_fake_world

    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    init_fake_world(8)
    try:
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor

        def done(t):
            return t.wait() if hasattr(t, "wait") else t

        def f(a, x):
            g = done(gather(a, 0, mesh.get_group("model")))  # f32[2] -> f32[8] on 4 ranks
            for _ in range(7):
                x = done(funcol.all_reduce(x, "sum", mesh.get_group("model")))  # f32[4] on 4 ranks
            return g, x

        stats = count_collectives(f, torch.zeros(2), torch.zeros(4), mesh=mesh)
    finally:
        destroy()
    # raw: one all-gather (8*4=32B) + 7 all-reduces (4*4=16B); loops unroll
    assert stats.raw_bytes == 32 + 7 * 16
    assert stats.corrected_bytes == stats.raw_bytes
    # global: ag ×4 participants, ar ×4 participants
    assert stats.global_bytes == 32 * 4 + 7 * 16 * 4
    assert stats.by_kind == {"all-gather": 32 * 4, "all-reduce": 7 * 16 * 4}
    assert stats.by_axis == {"model": 32 * 4 + 7 * 16 * 4}
    assert stats.ops == 8


# ---------------------------------------------------------------------------
# each family's forward: matmul FLOPs against the reference's jaxpr
# ---------------------------------------------------------------------------


def _ref_dot_flops(jaxpr) -> float:
    """Sum of 2·batch·M·N·K over every ``dot_general`` of ``jaxpr``, scan
    bodies times their length, calls and remat regions entered."""
    total = 0.0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "dot_general":
            (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
            lhs, rhs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
            batch = int(np.prod([lhs[i] for i in lb])) if lb else 1
            k = int(np.prod([lhs[i] for i in lc])) if lc else 1
            m = int(np.prod([s for i, s in enumerate(lhs) if i not in set(lc) | set(lb)]))
            n = int(np.prod([s for i, s in enumerate(rhs) if i not in set(rc) | set(rb)]))
            total += 2.0 * batch * m * n * k
            continue
        if prim == "while":
            raise AssertionError("a while loop in forward: its trips are not static")
        mult = eqn.params["length"] if prim == "scan" else 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    total += mult * _ref_dot_flops(inner)
    return total


SEQ = 64


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_dot_flops_equal_the_reference_jaxpr(arch):
    ref_model = ref_build_model(ref_reduced(ref_get_config(arch)))
    ref_params = jax.eval_shape(ref_model.init, jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch))
    ids_shape = (2, SEQ) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    closed = jax.make_jaxpr(ref_model.forward)(ref_params, jax.ShapeDtypeStruct(ids_shape, jnp.int32))
    want = _ref_dot_flops(closed.jaxpr)
    assert want > 0

    model = build_model(cfg, device=META)
    params = param_shapes(model)
    got = count_flops(model.forward, params, torch.zeros(ids_shape, dtype=torch.int64, device=META))
    assert got.dot == want
    if arch in ("qwen2.5-3b", "mixtral-8x7b"):  # the unfolded loops on real tensors too
        real = build_model(dataclasses.replace(cfg, dtype="float32"), device="cpu")
        p = real.init(torch.Generator().manual_seed(0))
        got_real = count_flops(real.forward, p, torch.zeros(ids_shape, dtype=torch.int64))
        assert got_real.dot == want


def test_sharded_train_step_counts_the_unsharded_flops():
    """A train step (remat, 2 microbatches) traced on a fake (2, 4) mesh
    counts the FLOPs of the same step without a mesh: the counter sees
    global shapes, and attention's per-device blocks count once per
    block, forward, recompute and backward."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import destroy, init_fake_world
    from repro_torch.training.optimizer import AdamWState, tree_map
    from repro_torch.training.train_loop import TrainStepConfig, make_train_step

    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), num_heads=8, num_kv_heads=4)
    model = build_model(cfg, tp=4, device=META)
    ids = torch.empty((8, 64), dtype=torch.int64, device=META)

    def state():
        p = tree_map(lambda t: _meta(*t.shape), param_shapes(model))
        return p, AdamWState(tree_map(lambda t: _meta(*t.shape), p), tree_map(lambda t: _meta(*t.shape), p),
                             _meta(dtype=torch.int32))

    counts = []
    init_fake_world(8)
    try:
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        for m in (None, mesh):
            step, _ = make_train_step(model, m, cfg=TrainStepConfig(microbatches=2, remat=True),
                                      device=META)
            counts.append(count_flops(step, *state(), ids, ids))
    finally:
        destroy()
    plain, sharded = counts
    assert sharded.dot == plain.dot > 0
    assert {k: sharded.by_op[k] for k in ("mm", "bmm")} == {k: plain.by_op[k] for k in ("mm", "bmm")}


# ---------------------------------------------------------------------------
# the H100 roofline
# ---------------------------------------------------------------------------


def test_roofline_arithmetic_with_h100_constants():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.NVLINK_BW, RL.IB_BW) == (989e12, 3.35e12, 450e9, 50e9)
    chips = 256
    t = RL.compute_roofline(
        arch="a", shape="s", mesh="single", chips=chips,
        hlo_flops_raw=0.0, hlo_bytes_raw=0.0,
        jaxpr_flops=2 * chips * 989e12,  # 2 s of compute
        model_bytes=chips * 3.35e12,  # 1 s of HBM
        coll_bytes_raw=0.0,
        coll_bytes=chips * 450e9,  # 1 s of NVLink
        dcn_bytes=chips * 50e9 * 1.5,  # 1.5 s of InfiniBand
        model_flops=chips * 989e12,
    )
    assert t.t_compute == pytest.approx(2.0)
    assert t.t_memory == pytest.approx(1.0)
    assert t.t_collective == pytest.approx(2.5)
    assert t.bottleneck == "collective"
    assert t.useful_ratio == pytest.approx(0.5)
    assert t.roofline_fraction == pytest.approx(1.0 / 2.5)


def test_mesh_axes_links():
    assert RL.axis_links({"data": 16, "model": 16}) == {"data": "ib", "model": "ib"}
    assert RL.axis_links({"pod": 2, "data": 16, "model": 16}) == {
        "pod": "ib", "data": "ib", "model": "ib"}
    assert RL.axis_links({"data": 2, "model": 4}) == {"data": "nvlink", "model": "nvlink"}
    assert RL.axis_links({"data": 4, "model": 8}) == {"data": "ib", "model": "nvlink"}
    assert RL.axis_links({"data": 1, "model": 1}) == {"data": "nvlink", "model": "nvlink"}
    assert RL.split_by_link({"data": 10, "model": 6}, {"data": 4, "model": 8}) == {
        "nvlink": 6.0, "ib": 10.0}
