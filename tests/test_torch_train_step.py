"""The port's train step held to an unsharded oracle of the reference's.

The reference's ``make_train_step`` fails on this tree (the embedding gather
under its explicit mesh; ROADMAP Queue 3), so the oracle is its step body
(``repro/training/train_loop.py:88-113``) built from its unsharded pieces:
``Model.forward``, ``cross_entropy`` and ``adamw_update``, the microbatches
as its ``lax.scan``, the loss under ``jax.checkpoint``, jitted.  The port
gets the reference's ``model.init`` weights through ``params_from_numpy``.

Families: qwen2.5 (dense), mixtral (MoE: the aux loss, capacity drops),
rwkv6, zamba2 (mamba2 + the shared block; 3 layers, the block after every
2) and musicgen (the codebook CE), each reduced with 2 layers, batch 4 of
32 tokens from ``SyntheticTokens(seed=7)``, ``microbatches=2``, lr 1e-3.
Two steps, each from one state: before each step the reference's state is
copied into the port, so step 2 runs with nonzero moments and the bias
corrections of step 2.  Each step is held in three links:

- the loss and the pre-clip grad norm, relative to max(1, |ref|);
- the accumulated gradient the step hands to AdamW (captured from the
  port's call) and the updated moments ``m`` and ``v``, each leaf relative
  to its own scale (max |ref leaf|);
- the updated params, ``m`` and ``v`` against the reference's
  ``adamw_update`` applied to the same start state and the port's gradient:
  params to 1e-6 of max(1, |p|), the moments to 1e-5 of their scale (the
  two packages sum the grad norm that sets the clipping scale in other
  orders).

The params are not compared with the reference's own update elementwise:
AdamW divides by sqrt(v) + eps with eps = 1e-8, so where a gradient is
near 0 a difference of d in it moves the update by up to lr * d / eps (at
f32 the two summation orders already move one element of zamba2's w_out
by 1.3e-4).  The gradient link and the given-the-gradient link together
are the step.

Tolerances: 1e-4 at f32 compute (the two summation orders leave about
5e-6); at bf16 compute 0.1 on the gradients and moments and 5e-3 on the
loss and grad norm: XLA and torch round the bf16 intermediates at
different points (``test_torch_models.py`` holds the forward's logits to
0.02), and the backward compounds it (up to 0.064 of a leaf's scale, on
mixtral's ``wk`` at step 2, and 0.0020 on its grad norm).  The ``embed`` gradient is the case the
port had to change for: cast-then-gather (the reference's order, now the
port's) against gather-then-cast, which sums a repeated token's rows in
f32 and splits from the reference at bf16
(``test_embed_gradient_order_at_bf16``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models.layers import flash_attention_sparse as ref_flash_sparse  # noqa: E402
from repro.training.optimizer import adamw_init as ref_adamw_init  # noqa: E402
from repro.training.optimizer import adamw_update as ref_adamw_update  # noqa: E402
from repro.training.train_loop import cross_entropy as ref_cross_entropy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as PM  # noqa: E402
from repro_torch.training import train_loop as TL  # noqa: E402
from repro_torch.training.optimizer import AdamWState, tree_leaves  # noqa: E402

FAMILIES = ["qwen2.5-3b", "mixtral-8x7b", "rwkv6-3b", "zamba2-1.2b", "musicgen-medium"]
OVER = {"zamba2-1.2b": dict(num_layers=3, shared_attn_every=2)}
# (gradients and moments, loss and grad norm) by compute dtype: see the docstring
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (0.1, 5e-3)}
STEP_CFG = TL.TrainStepConfig(microbatches=2, lr=1e-3, remat=True)
BATCH, SEQ = 4, 32



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its steps are thousands
    of small ops, and under the suite's parallel workers torch's thread
    pool turns each into a wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _pair(arch, dtype, **over):
    over = {"num_layers": 2, **OVER.get(arch, {}), **over}
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), dtype=dtype, **over)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype, **over)
    ref_model = RM.build_model(ref_cfg)
    return ref_model, ref_model.init(jax.random.PRNGKey(0)), PM.build_model(cfg, device="cpu")


def ref_train_step(ref_model, cfg):
    """``train_loop.py:88-113`` without the mesh: (params, opt, ids, labels)
    -> (params, opt, metrics, the gradient handed to AdamW)."""
    def loss_fn(params, ids, labels):
        logits, aux = ref_model.forward(params, ids)
        return ref_cross_entropy(logits, labels) + cfg.aux_loss_weight * aux

    loss_for_grad = jax.checkpoint(loss_fn) if cfg.remat else loss_fn

    def train_step(params, opt_state, ids, labels):
        n_micro = cfg.microbatches
        mb = ids.shape[0] // n_micro
        ids_m = ids.reshape((n_micro, mb) + ids.shape[1:])
        labels_m = labels.reshape((n_micro, mb) + labels.shape[1:])

        def micro(acc, inp):
            loss, grads = jax.value_and_grad(loss_for_grad)(params, *inp)
            acc_g, acc_l = acc
            return (jax.tree.map(jnp.add, acc_g, grads), acc_l + loss), None

        zero_g = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        (grads, loss_sum), _ = jax.lax.scan(micro, (zero_g, jnp.float32(0.0)), (ids_m, labels_m))
        grads = jax.tree.map(lambda g: g / n_micro, grads)
        params2, opt2, stats = ref_adamw_update(
            params, grads, opt_state, lr=cfg.lr, weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm)
        return params2, opt2, {"loss": loss_sum / n_micro, **stats}, grads

    return jax.jit(train_step)


def port_step_capturing(model, cfg, params, opt, ids, labels):
    """One port step; returns (params, opt, metrics, the gradient it handed
    to ``adamw_update``, copied)."""
    seen = {}
    real = TL.adamw_update

    def spy(p, grads, state, **kw):
        seen["grads"] = jax.tree.map(lambda g: g.detach().clone(), grads)
        return real(p, grads, state, **kw)

    TL.adamw_update = spy
    try:
        step, none = TL.make_train_step(model, None, cfg=cfg, device="cpu")
        assert none is None
        params, opt, metrics = step(params, opt, ids, labels)
    finally:
        TL.adamw_update = real
    return params, opt, metrics, seen["grads"]


def _to_port(model, ref_params, ref_opt):
    conv = lambda t: PM.params_from_numpy(model, _np(t))  # noqa: E731
    return conv(ref_params), AdamWState(conv(ref_opt.m), conv(ref_opt.v),
                                        torch.tensor(int(ref_opt.step), dtype=torch.int32))


def _port_np(tree):
    return jax.tree.map(lambda t: t.float().numpy(), tree)


def run_steps(arch, dtype, cfg=STEP_CFG, n_steps=2, **over):
    """Per step: (ref metrics, ref grads, ref opt, port metrics, port grads,
    port params, port opt, the reference's update of the step's start
    state with the port's gradient), all numpy."""
    ref_model, ref_params, model = _pair(arch, dtype, **over)
    ref_opt = ref_adamw_init(ref_params)
    ref_step = ref_train_step(ref_model, cfg)
    c = model.cfg
    data = SyntheticTokens(vocab_size=c.vocab_size, seq_len=SEQ, batch_size=BATCH,
                           num_codebooks=c.num_codebooks, seed=7)
    out = []
    for s in range(n_steps):
        ids, labels = data.batch(s)
        params, opt = _to_port(model, ref_params, ref_opt)
        p, o, met, grads = port_step_capturing(model, cfg, params, opt, ids, labels)
        given = ref_adamw_update(ref_params, jax.tree.map(jnp.asarray, _port_np(grads)), ref_opt,
                                 lr=cfg.lr, weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm)
        ref_params, ref_opt, ref_met, ref_grads = ref_step(ref_params, ref_opt, jnp.asarray(ids),
                                                           jnp.asarray(labels))
        out.append(dict(
            ref_met={k: float(v) for k, v in ref_met.items()}, ref_grads=_np(ref_grads),
            ref_m=_np(ref_opt.m), ref_v=_np(ref_opt.v), ref_step=int(ref_opt.step),
            met={k: float(v) for k, v in met.items()}, grads=_port_np(grads),
            params=_port_np(p), m=_port_np(o.m), v=_port_np(o.v), step=int(o.step),
            given_params=_np(given[0]), given_m=_np(given[1].m), given_v=_np(given[1].v)))
    return out


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def leaf_errors(ref, got, floor=0.0):
    """{leaf: max |got - ref| / max(floor, max |ref|)}."""
    got = dict(_paths(got))
    out = {}
    for name, r in _paths(ref):
        scale = max(floor, float(np.abs(r).max()))
        out[name] = float(np.abs(got[name] - r).max()) / scale if scale else float(np.abs(got[name]).max())
    return out


_RUNS: dict = {}


def _runs(arch, dtype):
    if (arch, dtype) not in _RUNS:
        _RUNS[arch, dtype] = run_steps(arch, dtype)
    return _RUNS[arch, dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grad_norm_match_reference(arch, dtype):
    tol = TOL[dtype][1]
    for i, r in enumerate(_runs(arch, dtype)):
        for k in ("loss", "grad_norm"):
            want, got = r["ref_met"][k], r["met"][k]
            assert abs(got - want) <= tol * max(1.0, abs(want)), (arch, i, k, got, want)
        assert r["step"] == r["ref_step"] == i + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_and_moments_match_reference(arch, dtype):
    tol = TOL[dtype][0]
    for i, r in enumerate(_runs(arch, dtype)):
        for what, ref, got in (("grad", r["ref_grads"], r["grads"]), ("m", r["ref_m"], r["m"]),
                               ("v", r["ref_v"], r["v"])):
            errs = leaf_errors(ref, got)
            bad = {k: e for k, e in errs.items() if e > tol}
            assert not bad, (arch, dtype, i, what, bad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_update_matches_reference_given_the_gradient(arch, dtype):
    for i, r in enumerate(_runs(arch, dtype)):
        for what, floor, tol in (("params", 1.0, 1e-6), ("m", 0.0, 1e-5), ("v", 0.0, 1e-5)):
            errs = leaf_errors(r[f"given_{what}"], r[what], floor=floor)
            bad = {k: e for k, e in errs.items() if e > tol}
            assert not bad, (arch, dtype, i, what, bad)


def _port_one_step(arch, cfg):
    """The port's first step from the reference's init: (metrics, grads,
    params, m, v), numpy."""
    _ref_model, ref_params, model = _pair(arch, "float32")
    params, opt = _to_port(model, ref_params, ref_adamw_init(ref_params))
    c = model.cfg
    ids, labels = SyntheticTokens(vocab_size=c.vocab_size, seq_len=SEQ, batch_size=BATCH,
                                  num_codebooks=c.num_codebooks, seed=7).batch(0)
    p, o, met, grads = port_step_capturing(model, cfg, params, opt, ids, labels)
    return dict(met={k: float(v) for k, v in met.items()}, grads=_port_np(grads),
                params=_port_np(p), m=_port_np(o.m), v=_port_np(o.v))


def test_remat_on_and_off_give_the_same_step():
    """``remat`` recomputes the forward in the backward: on the CPU the same
    ops on the same inputs, so the step is bit for bit the same (mixtral:
    the MoE's capacity drops recomputed too)."""
    a, b = (_port_one_step("mixtral-8x7b", dataclasses.replace(STEP_CFG, remat=remat))
            for remat in (True, False))
    assert a["met"] == b["met"]
    for what in ("grads", "params", "m", "v"):
        for (name, x), (_n, y) in zip(_paths(a[what]), _paths(b[what])):
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {name}")


def test_microbatches_accumulate_as_one_batch():
    """At f32 one microbatch of 4 and two of 2 give the same gradient (the
    mean of the two halves' means) to summation order, as the reference's
    scan does."""
    one, two = (_port_one_step("qwen2.5-3b", dataclasses.replace(STEP_CFG, microbatches=n))
                for n in (1, 2))
    errs = leaf_errors(one["grads"], two["grads"])
    assert max(errs.values()) < 1e-4, errs
    assert abs(one["met"]["loss"] - two["met"]["loss"]) < 1e-5


def _embed_grad(model, params, ids, gather_first: bool):
    """d(sum of the embedded rows x fixed weights)/d(embed) through
    ``_embed`` (cast then gather) or the other order."""
    cfg, dt = model.cfg, model.dtype
    table = params["embed"].detach().requires_grad_(True)
    if gather_first:
        x = table[ids].to(dt)
    else:
        x = PM._embed({"embed": table}, cfg, ids, dt)
    w = torch.linspace(-1, 1, x.shape[-1]).to(dt)
    (x * w).float().sum().backward()
    return table.grad.numpy()


def test_embed_gradient_order_at_bf16():
    """At bf16 the reference casts the table and then gathers, so a token
    that repeats has its rows' cotangents summed in bf16 and then widened.
    The port's ``_embed`` does the same and gives the reference's gradient
    bit for bit; gathering first and summing in f32 splits from it on the
    Zipf head tokens (by more than a bf16 step of the gradient's scale)."""
    ref_model, ref_params, model = _pair("qwen2.5-3b", "bfloat16")
    params = PM.params_from_numpy(model, _np(ref_params))
    ids, _ = SyntheticTokens(vocab_size=model.cfg.vocab_size, seq_len=128, batch_size=8, seed=7).batch(0)
    d = ref_params["embed"].shape[1]
    w = jnp.linspace(-1, 1, d).astype(jnp.bfloat16)

    def f(table):
        x = RM._embed({"embed": table}, ref_model.cfg, jnp.asarray(ids), jnp.bfloat16)
        return jnp.sum((x * w).astype(jnp.float32))

    want = np.asarray(jax.grad(f)(ref_params["embed"]))
    tids = torch.from_numpy(ids).long()
    cast_first = _embed_grad(model, params, tids, gather_first=False)
    gather_first = _embed_grad(model, params, tids, gather_first=True)
    np.testing.assert_array_equal(cast_first, want)
    split = np.abs(gather_first - want).max() / np.abs(want).max()
    assert split > 2 ** -8, split


@pytest.mark.parametrize("window", [0, 24])
def test_flash_attention_sparse_gradient(window):
    """``flash_attention_sparse`` with several kv blocks a q block (blocks of
    16 over 64 positions) runs its backward; its gradients equal
    ``jax.grad`` of the reference's sparse schedule and the port's dense
    ``flash_attention``'s, f32."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    wt = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=16, kv_chunk=16)

    def ref_loss(q, k, v):
        return jnp.sum(ref_flash_sparse(q, k, v, **kw) * wt)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for attn in (L.flash_attention_sparse, L.flash_attention):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        (attn(tq, tk, tv, **kw) * torch.from_numpy(wt)).sum().backward()
        for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5,
                                       err_msg=f"{attn.__name__} d{name}")


@pytest.mark.parametrize("arch,seq", [("qwen2.5-3b", 40), ("rwkv6-3b", 40), ("zamba2-1.2b", 40),
                                      ("mixtral-8x7b", 40)])
def test_backward_runs_past_one_chunk(arch, seq):
    """The backward of every family's forward at a sequence that takes more
    than one chunk of its mixer (attention q / kv blocks of 16 through
    ``attn_impl="sparse"`` and the dense schedule, the rwkv6 and mamba2
    chunk scans, the MoE's GShard dispatch): finite, nonzero gradients on
    every stacked leaf, and the dense and sparse attention schedules give
    the same gradient."""
    _ref_model, ref_params, model = _pair(arch, "float32")
    params = PM.params_from_numpy(model, _np(ref_params))
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, model.cfg.vocab_size, (2, seq)))
    labels = torch.roll(ids, -1, dims=1)
    grads = {}
    impls = ("dense", "sparse") if model.cfg.attention != "none" else ("dense",)
    for impl in impls:
        m = PM.build_model(dataclasses.replace(model.cfg, attn_impl=impl), device="cpu")
        leaves = jax.tree.map(lambda t: t.clone().requires_grad_(True), params)
        with _small_blocks():
            logits, aux = m.forward(leaves, ids)
        (TL.cross_entropy(logits, labels) + 0.01 * aux).backward()
        grads[impl] = jax.tree.map(lambda t: t.grad.numpy(), leaves)
    for name, g in _paths(grads["dense"]["layers"]):
        assert np.isfinite(g).all() and np.abs(g).max() > 0, (arch, name)
    if "sparse" in grads:
        errs = leaf_errors(grads["dense"], grads["sparse"])
        assert max(errs.values()) < 1e-5, errs


class _small_blocks:
    """Attention blocks of 8 (q and kv) and scan chunks of 8 while the
    block runs, so a 40-token sequence takes several of each."""

    def __enter__(self):
        from repro_torch.models import mamba2, rwkv6

        self.saved = [(L, "flash_attention", dict(q_chunk=8, kv_chunk=8)),
                      (L, "flash_attention_sparse", dict(q_chunk=8, kv_chunk=8)),
                      (rwkv6, "rwkv6_chunked", dict(chunk=8)),
                      (mamba2, "mamba2_chunked", dict(chunk=8))]
        self.saved = [(mod, name, getattr(mod, name), kw) for mod, name, kw in self.saved]
        for mod, name, fn, kw in self.saved:
            setattr(mod, name, _with(fn, kw))
        return self

    def __exit__(self, *exc):
        for mod, name, fn, _kw in self.saved:
            setattr(mod, name, fn)


def _with(fn, fixed):
    def call(*a, **kw):
        return fn(*a, **{**kw, **fixed})
    return call


def test_step_refuses_a_model_on_another_device():
    """(The default device, CUDA, is refused without a card:
    ``test_torch_system.py::test_entry_points_refuse_missing_cuda``.)"""
    _ref_model, _ref_params, model = _pair("qwen2.5-3b", "float32")
    with pytest.raises(ValueError, match="lives on"):
        TL.make_train_step(model, device="meta")


def test_no_leaf_of_a_step_is_left_requiring_grad():
    """The step hands back the caller's tensors, updated in place: plain
    tensors (no autograd history), the same objects."""
    _ref_model, ref_params, model = _pair("qwen2.5-3b", "float32")
    params, opt = _to_port(model, ref_params, ref_adamw_init(ref_params))
    before = [t.data_ptr() for t in tree_leaves(params) + tree_leaves(opt)]
    ids, labels = SyntheticTokens(vocab_size=model.cfg.vocab_size, seq_len=SEQ, batch_size=BATCH).batch(0)
    step, _ = TL.make_train_step(model, None, cfg=STEP_CFG, device="cpu")
    p2, o2, m = step(params, opt, ids, labels)
    assert p2 is params and o2 is opt
    assert [t.data_ptr() for t in tree_leaves(p2) + tree_leaves(o2)] == before
    assert not any(t.requires_grad for t in tree_leaves(p2) + tree_leaves(o2))
    assert m["loss"].shape == () and not m["loss"].requires_grad
