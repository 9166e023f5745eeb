"""The port's decoders, all four families, held to the reference's.

- Parity: for each of the ten architectures (reduced, 2 layers; zamba2 at 3
  layers with its shared block after every 2, so one full group runs the
  shared block and the last, partial group does not), the
  reference's ``model.init`` weights carried across by ``params_from_numpy``
  and the same numpy-seeded ids go through the reference's jitted
  ``forward`` / ``prefill`` / ``decode`` (no mesh) and the port's CPU path.
  Logits, prefill logits and every decode step agree to 1e-4 of the
  logit scale (``max(1, |ref logits|max)``) with equal argmax at f32
  compute, the reference's summation order being the only difference; to
  0.02 of it at bf16 compute, where XLA and torch round the bf16
  intermediates at different points (about two bf16 steps of a logit).
  The caches agree entry for entry (the KV ring, the rwkv6 carries and wkv
  state, the mamba2 conv and SSM states, zamba2's shared KV slots), integer
  entries (``positions``) exactly.
- A sliding-window case whose prompt is longer than the window (the
  prefill's ring wraps, then decode writes slot ``pos % W``), with the
  dense and the block-sparse attention schedules.
- ``flash_attention_sparse`` against ``flash_attention`` (port) and against
  the reference's, and parameter shapes and logical axes against the
  reference's for tp 1 and 16 (the KV padding rule: mixtral and dbrx pad
  their 8 KV heads to 16), every family's init scales.
- The activations the port writes out step by step (sigmoid, silu, the tanh
  gelu) give ``jax.nn``'s bits at bf16 and f32.
- The reference's cases of ``tests/test_models.py`` run on the port for
  every architecture: forward shapes and finiteness, prefill/decode against
  forward, the SWA window masking old tokens, the configs against the
  assignment, the 500k flags (its mixer oracles are in
  ``test_torch_moe_ssm.py``).
- The model runs on the card unless given ``device="cpu"``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.models.model import param_shapes as ref_param_shapes  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, reduced, shape_cells  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import build_model, param_shapes, params_from_numpy  # noqa: E402

NEW = ["dbrx-132b", "mixtral-8x7b", "rwkv6-3b", "zamba2-1.2b"]  # MoE, rwkv6, mamba2
# per-architecture changes to the 2-layer parity config
OVER = {"zamba2-1.2b": dict(num_layers=3, shared_attn_every=2)}
# (relative bound, argmax must agree) by compute dtype: see the docstring
TOL = {"float32": (1e-4, True), "bfloat16": (0.02, False)}
B, S, P = 2, 32, 24


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _ids(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks else (b, s)
    return rng.integers(0, cfg.vocab_size, size=shape)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _pair(arch, dtype, **over):
    """(reference model, its params, port model, port params) for a reduced
    2-layer config of ``arch`` at compute ``dtype``."""
    over = {"num_layers": 2, **OVER.get(arch, {}), **over}
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), dtype=dtype, **over)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype=dtype, **over)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    return ref_model, ref_params, model, params_from_numpy(model, _np_tree(ref_params))


def _run_both(ref_model, ref_params, model, params, ids, prompt_len):
    """forward, prefill and each decode step of both packages; returns
    (ref forward, port forward, [(ref step, port step)], ref cache, port
    cache)."""
    ref_fwd, _ = jax.jit(ref_model.forward)(ref_params, jnp.asarray(ids))
    fwd, _ = model.forward(params, torch.from_numpy(ids))
    n = ids.shape[1]
    ref_cache = ref_model.init_cache(ids.shape[0], n)
    cache = model.init_cache(ids.shape[0], n)
    ref_lp, ref_cache = jax.jit(ref_model.prefill)(ref_params, jnp.asarray(ids[:, :prompt_len]),
                                                  ref_cache)
    lp, cache = model.prefill(params, torch.from_numpy(ids[:, :prompt_len]), cache)
    steps = [(ref_lp, lp)]
    dec = jax.jit(ref_model.decode)
    for t in range(prompt_len, n):
        ref_l, ref_cache = dec(ref_params, jnp.asarray(ids[:, t:t + 1]), ref_cache, jnp.int32(t))
        got, cache = model.decode(params, torch.from_numpy(ids[:, t:t + 1]), cache, t)
        steps.append((ref_l, got))
    return ref_fwd, fwd, steps, ref_cache, cache


_RUNS: dict = {}


def _runs(arch, dtype):
    key = (arch, dtype)
    if key not in _RUNS:
        ref_model, ref_params, model, params = _pair(arch, dtype)
        cfg = model.cfg
        _RUNS[key] = _run_both(ref_model, ref_params, model, params, _ids(cfg, B, S, seed=3), P)
    return _RUNS[key]


def _assert_close(ref, got, dtype, what):
    rel, same_argmax = TOL[dtype]
    ref, got = _f32(ref), _f32(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ref - got).max())
    assert err <= rel * scale, (what, err, scale)
    if same_argmax:
        np.testing.assert_array_equal(ref.argmax(-1), got.argmax(-1), err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch, dtype):
    ref_fwd, fwd, _steps, _rc, _c = _runs(arch, dtype)
    _assert_close(ref_fwd, fwd, dtype, f"{arch} forward")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_match_reference(arch, dtype):
    _rf, _f, steps, ref_cache, cache = _runs(arch, dtype)
    for i, (ref_l, got) in enumerate(steps):
        _assert_close(ref_l, got, dtype, f"{arch} {'prefill' if i == 0 else f'decode {P + i - 1}'}")
    assert set(cache) == set(ref_cache), (sorted(cache), sorted(ref_cache))
    for name, got in cache.items():
        if got.dtype.is_floating_point:
            _assert_close(ref_cache[name], got, dtype, f"{arch} cache {name}")
        else:
            np.testing.assert_array_equal(np.asarray(ref_cache[name]), got.numpy())


@pytest.mark.parametrize("attn_impl", ["dense", "sparse"])
def test_swa_ring_wraps_as_reference(attn_impl):
    """Window 8, prompt 24 (three times the window): the prefill keeps the
    last 8 positions in ring order, decode overwrites slot pos % 8; f32."""
    ref_model, ref_params, model, params = _pair(
        "qwen2.5-3b", "float32", attention="swa", window=8, attn_impl=attn_impl)
    ids = _ids(model.cfg, B, S, seed=5)
    ref_fwd, fwd, steps, ref_cache, cache = _run_both(ref_model, ref_params, model, params, ids, P)
    assert cache["k"].shape[2] == 8
    _assert_close(ref_fwd, fwd, "float32", "swa forward")
    for ref_l, got in steps:
        _assert_close(ref_l, got, "float32", "swa step")
    np.testing.assert_array_equal(np.asarray(ref_cache["positions"]), cache["positions"].numpy())
    assert sorted(cache["positions"].tolist()) == list(range(S - 8, S))
    # and the decode steps are the full forward's logits at those positions
    for t, (_ref_l, got) in zip(range(P - 1, S), steps):
        np.testing.assert_allclose(got[:, 0].numpy(), fwd[:, t].numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0), (True, 24, 0), (True, 16, 32),
                                                    (False, 0, 0)])
def test_flash_attention_sparse_matches_dense(causal, window, q_offset):
    """The block-sparse schedule against the dense one (port) and against
    the reference's sparse schedule; blocks of 16 over 64 positions, GQA
    with 2 query heads a KV head, f32."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 64 + q_offset, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 64 + q_offset, 2, 16)).astype(np.float32)
    kw = dict(q_offset=q_offset, causal=causal, window=window, q_chunk=16, kv_chunk=16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    sparse = L.flash_attention_sparse(tq, tk, tv, **kw).numpy()
    dense = L.flash_attention(tq, tk, tv, **kw).numpy()
    ref = np.asarray(RL.flash_attention_sparse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    np.testing.assert_allclose(sparse, dense, rtol=0, atol=1e-5)
    np.testing.assert_allclose(sparse, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shapes_match_reference(arch, tp):
    """Published widths, KV heads padded to the TP degree by the
    reference's rule: every parameter's shape is the reference's."""
    cfg = get_config(arch)
    model = build_model(cfg, tp=tp, device="cpu")
    ref = ref_build_model(ref_get_config(arch), tp=tp)
    want = jax.tree.map(lambda s: tuple(s.shape), ref_param_shapes(ref))
    got = _tree_map(lambda t: tuple(t.shape), param_shapes(model))
    assert got == want
    assert model.kv_eff == ref.kv_eff
    if arch in ("mixtral-8x7b", "dbrx-132b"):  # 8 KV heads padded to tp 16
        assert model.kv_eff == (16 if tp == 16 else 8)
    assert model.axes == ref.axes


def test_init_draws_fan_in_scales():
    """``init`` draws from the generator: reproducible, ones / zeros where
    the reference puts them, normal weights at the reference's fan-in
    scales (0.02 for embeddings and the head)."""
    cfg = reduced(get_config("qwen2.5-3b"))
    model = build_model(cfg, device="cpu")
    a = model.init(torch.Generator().manual_seed(1))
    b = model.init(torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(L.tree_leaves(a), L.tree_leaves(b)))
    lay = a["layers"]
    assert torch.equal(lay["ln_att"]["scale"], torch.ones_like(lay["ln_att"]["scale"]))
    assert not lay["attn"]["bq"].any()
    for t, want in ((a["embed"], 0.02), (lay["attn"]["wq"], cfg.d_model ** -0.5),
                    (lay["mlp"]["wo"], cfg.d_ff ** -0.5)):
        assert abs(float(t.std()) / want - 1) < 0.05
    bf = model.init(torch.Generator().manual_seed(1), dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in L.tree_leaves(bf))
    assert model.param_count(a) == model.param_count()


def test_params_from_numpy_checks_shapes():
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), num_layers=2)
    model = build_model(cfg, device="cpu")
    tree = _tree_map(lambda t: np.zeros(t.shape, np.float32), param_shapes(model))
    tree["lm_head"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(model, tree)


# (path, expected std or "ones" / "zeros") per new family, at reduced widths
_INIT = {
    "dbrx-132b": [("layers/moe/router", "d"), ("layers/moe/wi_gate", "d"),
                  ("layers/moe/wo", "ff"), ("layers/ln_att/bias", "zeros")],
    "mixtral-8x7b": [("layers/moe/wi_up", "d"), ("layers/moe/wo", "ff"),
                     ("layers/ln_mlp/scale", "ones")],
    "rwkv6-3b": [("layers/tmix/wr", "d"), ("layers/tmix/w_lora_b", 0.05),
                 ("layers/tmix/u_bonus", 0.5), ("layers/tmix/w_base", "zeros"),
                 ("layers/tmix/mu_g", "zeros"), ("layers/cmix/wv", "ff"),
                 ("layers/cmix/mu_r", "zeros")],
    "zamba2-1.2b": [("layers/mixer/w_x", "d"), ("layers/mixer/conv_x", 0.5),
                    ("layers/mixer/A_log", "zeros"), ("layers/mixer/D_skip", "ones"),
                    ("layers/mixer/norm_scale", "ones"), ("shared/attn/wq", "d"),
                    ("shared/mlp/wo", "ff")],
}


def _at(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


@pytest.mark.parametrize("arch", NEW)
def test_init_scales_of_new_families(arch):
    """Each new family's params: ones / zeros where the reference puts them,
    normal draws at its scales (fan-in 1/sqrt(d) or 1/sqrt(d_ff), or the
    fixed 0.05 / 0.5), and the reference's keys (``params_from_numpy``
    accepts the reference's ``init`` tree)."""
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(2))
    scales = {"d": cfg.d_model ** -0.5, "ff": cfg.d_ff ** -0.5}
    for path, want in _INIT[arch]:
        t = _at(params, path)
        if want in ("ones", "zeros"):
            assert torch.equal(t, torch.full_like(t, 1.0 if want == "ones" else 0.0)), path
        else:
            assert abs(float(t.std()) / scales.get(want, want) - 1) < 0.05, (path, float(t.std()))
    ref_model = ref_build_model(ref_reduced(ref_get_config(arch)))
    tree = _np_tree(ref_model.init(jax.random.PRNGKey(0)))
    got = params_from_numpy(model, tree)
    assert model.param_count(got) == model.param_count(params) == ref_model.param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["sigmoid", "silu", "gelu"])
def test_activations_match_jax_bits(act, dtype):
    x = np.random.default_rng(4).normal(size=20_000).astype(np.float32) * 4
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    ref = {"sigmoid": jax.nn.sigmoid, "silu": jax.nn.silu, "gelu": jax.nn.gelu}[act]
    port = {"sigmoid": L.sigmoid, "silu": L.silu, "gelu": L.gelu_tanh}[act]
    want = _f32(jax.jit(ref)(jnp.asarray(x).astype(jdt)))
    got = port(torch.from_numpy(x).to(tdt)).float().numpy()
    if dtype == "bfloat16":  # the same bits, all but a few transcendental last-bit ties
        assert float(np.mean(got != want)) < 0.002, act
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    else:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


def test_model_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(reduced(get_config("qwen2.5-3b")))


# ---------------------------------------------------------------------------
# tests/test_models.py's cases, run on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch_setup(request):
    """The reference case's own setup: its reduced config (bf16 compute)
    and its ``init(PRNGKey(0))`` weights, carried over.  At bf16 a MoE
    router's near-tie can pick another expert in ``forward`` than in
    ``decode`` (their attention rounds differently), in the reference too:
    its own case fails at 6 of PRNGKey(8..27) on reduced mixtral; the port's
    f32 consistency on its own draws is in ``test_torch_moe_ssm.py``."""
    arch = request.param
    cfg = reduced(get_config(arch))
    model = build_model(cfg, device="cpu")
    ref_model = ref_build_model(ref_reduced(ref_get_config(arch)))
    params = params_from_numpy(model, _np_tree(ref_model.init(jax.random.PRNGKey(0))))
    return arch, cfg, model, params


def test_forward_shapes_and_finite(arch_setup):
    arch, cfg, model, params = arch_setup
    ids = torch.from_numpy(_ids(cfg, 2, 64))
    logits, aux = model.forward(params, ids)
    expect = (2, 64, cfg.num_codebooks, cfg.vocab_size) if cfg.num_codebooks else (2, 64, cfg.vocab_size)
    assert tuple(logits.shape) == expect
    assert bool(torch.isfinite(logits.float()).all()), arch


def test_prefill_decode_matches_forward(arch_setup):
    arch, cfg, model, params = arch_setup
    b, s, p = 2, 32, 24
    ids = torch.from_numpy(_ids(cfg, b, s, seed=3))
    full_logits, _ = model.forward(params, ids)
    cache = model.init_cache(b, s)
    lp, cache = model.prefill(params, ids[:, :p], cache)
    errs = [float((lp[:, 0] - full_logits[:, p - 1]).abs().max())]
    for t in range(p, s):
        lg, cache = model.decode(params, ids[:, t:t + 1], cache, t)
        errs.append(float((lg[:, 0] - full_logits[:, t]).abs().max()))
    scale = float(full_logits.abs().max())
    assert max(errs) < 0.06 * max(scale, 1.0), (arch, errs)


def test_swa_window_masks_old_tokens():
    """Mixtral SWA: tokens beyond the window must not influence logits."""
    cfg = dataclasses.replace(reduced(get_config("mixtral-8x7b")), window=8, num_layers=1)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(7))
    rng = np.random.default_rng(8)
    ids1 = rng.integers(0, cfg.vocab_size, size=(1, 32))
    ids2 = ids1.copy()
    ids2[0, :8] = (ids2[0, :8] + 7) % cfg.vocab_size  # outside last token's window
    l1, _ = model.forward(params, torch.from_numpy(ids1))
    l2, _ = model.forward(params, torch.from_numpy(ids2))
    l1, l2 = l1.float(), l2.float()
    np.testing.assert_allclose(l1[0, -1].numpy(), l2[0, -1].numpy(), rtol=1e-4, atol=1e-4)
    assert float((l1[0, 8] - l2[0, 8]).abs().max()) > 1e-4  # inside the window it does


def test_long_500k_applicability_flags():
    """The long_500k skip set is exactly the pure full-attention archs."""
    expected_runs = {"mixtral-8x7b", "rwkv6-3b", "zamba2-1.2b"}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        names = {s.name for s in shape_cells(cfg)}
        assert ("long_500k" in names) == (arch in expected_runs), arch


def test_configs_match_assignment():
    """Exact public config numbers from the assignment table, and each
    port config equal to the reference's."""
    spec = {
        "dbrx-132b": (40, 6144, 48, 8, 10752, 100352, 16, 4),
        "mixtral-8x7b": (32, 4096, 32, 8, 14336, 32000, 8, 2),
        "chameleon-34b": (48, 8192, 64, 8, 22016, 65536, 0, 0),
        "chatglm3-6b": (28, 4096, 32, 2, 13696, 65024, 0, 0),
        "qwen2.5-3b": (36, 2048, 16, 2, 11008, 151936, 0, 0),
        "minitron-8b": (32, 4096, 32, 8, 16384, 256000, 0, 0),
        "phi4-mini-3.8b": (32, 3072, 24, 8, 8192, 200064, 0, 0),
        "musicgen-medium": (48, 1536, 24, 24, 6144, 2048, 0, 0),
        "rwkv6-3b": (32, 2560, 40, 40, 8960, 65536, 0, 0),
        "zamba2-1.2b": (38, 2048, 32, 32, 8192, 32000, 0, 0),
    }
    for arch, (nl, d, H, KV, ff, V, E, K) in spec.items():
        c = get_config(arch)
        assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
                c.vocab_size, c.num_experts, c.top_k) == (nl, d, H, KV, ff, V, E, K), arch
        assert dataclasses.asdict(c) == dataclasses.asdict(ref_get_config(arch)), arch
        assert c.param_count() == ref_get_config(arch).param_count(), arch
