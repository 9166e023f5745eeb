"""The port's mixers (MoE, RWKV-6, Mamba-2) and zamba2's hybrid layout held to
the reference's.

Inputs are drawn from a numpy seed and go through both packages, the
reference's weights carried over by ``params_from_numpy``; f32 compute.

- ``moe_block`` at capacity 1.25 on inputs that overflow the experts'
  buffers: the same tokens dropped (the tokens whose output differs from
  the no-drop dense dispatch are those the port's buffer slots drop), the
  same outputs and aux loss; all-tied router probabilities pick experts as
  ``lax.top_k`` does (lowest index first).  Where nothing drops, the GShard
  block equals ``moe_block_dense_ref`` (``tests/test_models.py:116``).
- ``rwkv6_chunked`` / ``rwkv6_decode`` against the reference's
  ``rwkv6_chunked`` / ``rwkv6_ref`` at chunk 1, 8, 16 and 32 and at a prime S
  (chunk 1), with the reference's own chunked-against-stepwise bounds
  (``tests/test_models.py:133``); the same for ``mamba2``; the decay's
  softplus bit for bit with ``jax.nn.softplus``.
- zamba2 at 14 layers (groups 6, 6, 2: two shared invocations, none after
  the last two layers) and a zamba2 prefill whose prompt is longer than the
  cache, against the reference's forward / prefill / decode and caches.
- The MoE transformer's prefill + decode against its forward at f32 on the
  port's own draws, and every family's decode writes its cache in place.

Tolerance as ``test_torch_models.py``'s f32: 1e-4 of the scale
``max(1, |ref|max)`` with equal argmax on logits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import mamba2 as RM2  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models import rwkv6 as RR6  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import rwkv6 as R6  # noqa: E402
from repro_torch.models.model import build_model, params_from_numpy  # noqa: E402

REL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(ref, got, what, rel=REL, argmax=False):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ref - got).max())
    assert err <= rel * scale, (what, err, scale)
    if argmax:
        np.testing.assert_array_equal(ref.argmax(-1), got.argmax(-1), err_msg=what)


def _pair(arch, seed=0, **over):
    """(reference model, its f32 params, port model, port params): reduced
    ``arch`` at f32 compute."""
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), dtype="float32", **over)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32", **over)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    model = build_model(cfg, device="cpu")
    return ref_model, ref_params, model, params_from_numpy(model, jax.tree.map(np.asarray, ref_params))


def _layer0(ref_params, params, key):
    return (jax.tree.map(lambda a: a[0], ref_params["layers"][key]),
            {k: v[0] for k, v in params["layers"][key].items()})


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_pair():
    ref_model, ref_params, model, params = _pair("mixtral-8x7b", seed=1, num_layers=1)
    rp, p = _layer0(ref_params, params, "moe")
    return model.cfg, rp, p


def _moe_both(cfg, rp, p, x, cf, group_size=1024):
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k, capacity_factor=cf,
              group_size=group_size)
    ref_out, ref_aux = RMOE.moe_block(rp, jnp.asarray(x), **kw)
    out, aux = MOE.moe_block(p, torch.from_numpy(x), **kw)
    return ref_out, ref_aux, out, aux


def _kept(cfg, p, x, cf, group_size=1024):
    """The port's kept (token, choice) mask (T, K) from its buffer slots."""
    B, S, D = x.shape
    gsz = min(group_size, B * S)
    xg = torch.from_numpy(x).reshape(-1, gsz, D)
    _probs, _g, idx = MOE._route(p, xg, cfg.top_k)
    sel = torch.nn.functional.one_hot(idx, cfg.num_experts).float().transpose(2, 3)
    _pos, within = MOE.buffer_slots(sel, MOE.capacity(gsz, cfg.num_experts, cfg.top_k, cf))
    return within.any(dim=2).reshape(B * S, cfg.top_k)


@pytest.mark.parametrize("group_size", [1024, 16])
def test_moe_drops_the_reference_tokens(moe_pair, group_size):
    """Capacity 1.25 on 64 tokens (one group of 64, or four of 16), the
    tokens leaning towards expert 0's router column so that its buffer
    overflows.  The port's output, aux loss and dropped tokens are the
    reference's."""
    cfg, rp, p = moe_pair
    rng = np.random.default_rng(11)
    lean = np.asarray(rp["router"])[:, 0]
    x = (rng.normal(size=(2, 32, cfg.d_model)) + 2.0 * lean / np.linalg.norm(lean)).astype(np.float32)
    ref_out, ref_aux, out, aux = _moe_both(cfg, rp, p, x, 1.25, group_size)
    _close(ref_out, out, "moe_block at 1.25")
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=1e-5)
    kept = _kept(cfg, p, x, 1.25, group_size)
    assert not bool(kept.all()), "no choice was dropped: the case tests nothing"
    # the reference's dropped tokens: where its GShard output leaves the
    # dense (no-drop) dispatch
    dense = _np(RMOE.moe_block_dense_ref(rp, jnp.asarray(x), num_experts=cfg.num_experts,
                                         top_k=cfg.top_k))
    ref_dropped = np.abs(_np(ref_out) - dense).reshape(-1, cfg.d_model).max(-1) > 1e-4
    np.testing.assert_array_equal(ref_dropped, ~kept.all(dim=1).numpy())


def test_moe_ties_break_as_lax_top_k(moe_pair):
    """A zero router gives every expert the same probability: both packages
    send each token to experts 0 and 1 (``lax.top_k``: lowest index first),
    so experts 0 and 1 overflow and drop the same tokens."""
    cfg, rp, p = moe_pair
    rp = dict(rp, router=jnp.zeros_like(rp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = np.random.default_rng(12).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    ref_out, _ra, out, _a = _moe_both(cfg, rp, p, x, 1.25)
    _close(ref_out, out, "tied router")
    _probs, gates, idx = MOE._route(p, torch.from_numpy(x), cfg.top_k)
    assert idx.reshape(-1, cfg.top_k).tolist() == [[0, 1]] * 32
    kept = _kept(cfg, p, x, 1.25)
    C = MOE.capacity(32, cfg.num_experts, cfg.top_k, 1.25)
    assert int(kept[:, 0].sum()) == int(kept[:, 1].sum()) == C < 32


def test_moe_gshard_matches_dense_when_no_drops():
    """``tests/test_models.py:116`` on the port, and against the reference."""
    ref_model, ref_params, model, params = _pair("dbrx-132b", seed=1, num_layers=1)
    cfg = model.cfg
    rp, p = _layer0(ref_params, params, "moe")
    x = np.random.default_rng(2).normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    out, aux = MOE.moe_block(p, torch.from_numpy(x), num_experts=cfg.num_experts,
                             top_k=cfg.top_k, capacity_factor=8.0)
    want = MOE.moe_block_dense_ref(p, torch.from_numpy(x), num_experts=cfg.num_experts,
                                   top_k=cfg.top_k)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
    assert float(aux) >= 1.0  # Switch aux loss lower bound E·Σ f·p ≥ 1
    ref_want = RMOE.moe_block_dense_ref(rp, jnp.asarray(x), num_experts=cfg.num_experts,
                                        top_k=cfg.top_k)
    _close(ref_want, want, "moe_block_dense_ref")


def test_moe_group_size_must_divide_tokens(moe_pair):
    cfg, _rp, p = moe_pair
    with pytest.raises(AssertionError):
        MOE.moe_block(p, torch.zeros((1, 24, cfg.d_model)), num_experts=cfg.num_experts,
                      top_k=cfg.top_k, group_size=16)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b"])
def test_moe_decode_matches_forward_on_port_draws(arch):
    """The MoE transformer on the port's own draws (seed 0), f32: prefill +
    dense-dispatch decode give forward's GShard logits (capacity 4.0, no
    drops).  At bf16 the same draws route a near-tie differently in one of
    the two passes (see ``test_torch_models.py``'s ``arch_setup``)."""
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 32)))
    full, aux = model.forward(params, ids)
    cache = model.init_cache(2, 32)
    lp, cache = model.prefill(params, ids[:, :24], cache)
    _close(full[:, 23], lp[:, 0], f"{arch} prefill", argmax=True)
    for t in range(24, 32):
        lg, cache = model.decode(params, ids[:, t:t + 1], cache, t)
        _close(full[:, t], lg[:, 0], f"{arch} decode {t}", argmax=True)
    assert float(aux) >= 1.0


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rwkv_pair():
    ref_model, ref_params, model, params = _pair("rwkv6-3b", seed=3, num_layers=1)
    rp, p = _layer0(ref_params, params, "tmix")
    return model.cfg, rp, p


def _rwkv_inputs(cfg, S, seed=4):
    rng = np.random.default_rng(seed)
    B, D, H, N = 2, cfg.d_model, cfg.ssm_heads_eff, cfg.head_dim
    x = rng.normal(size=(B, S, D)).astype(np.float32) * 0.5
    xp = rng.normal(size=(B, D)).astype(np.float32) * 0.5
    st = rng.normal(size=(B, H, N, N)).astype(np.float32) * 0.1
    return x, xp, st


@pytest.mark.parametrize("S,chunk", [(64, 1), (64, 8), (64, 16), (64, 32), (37, 32)])
def test_rwkv6_chunked_matches_reference(rwkv_pair, S, chunk):
    """The port's chunked scan against the reference's at the same chunk
    (S = 37 is prime: both take chunk 1) and against the port's stepwise
    oracle within the reference's own bounds (2e-2 outputs, 1e-3 state)."""
    cfg, rp, p = rwkv_pair
    x, xp, st = _rwkv_inputs(cfg, S)
    assert R6.chunk_size(S, chunk) == (1 if S == 37 else chunk)
    ref_o, ref_x, ref_s = RR6.rwkv6_chunked(rp, jnp.asarray(x), jnp.asarray(xp), jnp.asarray(st),
                                            chunk=chunk)
    o, xl, s = R6.rwkv6_chunked(p, *map(torch.from_numpy, (x, xp, st)), chunk=chunk)
    _close(ref_o, o, "rwkv6 out")
    _close(ref_s, s, "rwkv6 state")
    np.testing.assert_array_equal(_np(ref_x), xl.numpy())
    so, sx, ss = R6.rwkv6_ref(p, *map(torch.from_numpy, (x, xp, st)))
    np.testing.assert_allclose(o.numpy(), so.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(s.numpy(), ss.numpy(), rtol=1e-3, atol=1e-3)


def test_rwkv6_stepwise_matches_reference(rwkv_pair):
    """``rwkv6_ref`` (one ``rwkv6_decode`` a token) against the reference's."""
    cfg, rp, p = rwkv_pair
    x, xp, st = _rwkv_inputs(cfg, 12, seed=5)
    ref_o, ref_x, ref_s = RR6.rwkv6_ref(rp, jnp.asarray(x), jnp.asarray(xp), jnp.asarray(st))
    o, xl, s = R6.rwkv6_ref(p, *map(torch.from_numpy, (x, xp, st)))
    _close(ref_o, o, "rwkv6_ref out")
    _close(ref_s, s, "rwkv6_ref state")
    np.testing.assert_array_equal(_np(ref_x), xl.numpy())


def test_rwkv6_softplus_is_exact_above_torch_threshold():
    """The decay's softplus gives ``jax.nn.softplus``'s bits on both sides
    of the threshold (20) above which ``torch.nn.functional.softplus``
    returns x (in f32 the two agree there too: exp(-20) is below its
    resolution at 20)."""
    x = np.array([-30.0, -1.0, 0.0, 15.0, 19.9, 20.1, 25.0, 40.0], np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_array_equal(R6.softplus(torch.from_numpy(x)).numpy(), want)


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba_pair():
    ref_model, ref_params, model, params = _pair("zamba2-1.2b", seed=5, num_layers=1)
    rp, p = _layer0(ref_params, params, "mixer")
    return model.cfg, rp, p


def _mamba_states(cfg, seed):
    rng = np.random.default_rng(seed)
    conv, ssm = M2.init_mamba2_state(cfg, 2)
    conv = tuple((rng.normal(size=c.shape) * 0.5).astype(np.float32) for c in conv)
    return conv, (rng.normal(size=ssm.shape) * 0.1).astype(np.float32)


@pytest.mark.parametrize("S,chunk", [(64, 1), (64, 8), (64, 16), (64, 32), (37, 32)])
def test_mamba2_chunked_matches_reference(mamba_pair, S, chunk):
    """As for rwkv6, from nonzero conv and SSM states: the conv carries
    (3 rows each of x, B and C) and the state against the reference's, and
    the chunked scan against the port's stepwise oracle within the
    reference's bounds (1e-3)."""
    cfg, rp, p = mamba_pair
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32) * 0.5
    conv, ssm = _mamba_states(cfg, 7)
    ref_o, ref_c, ref_s = RM2.mamba2_chunked(rp, jnp.asarray(x), tuple(map(jnp.asarray, conv)),
                                             jnp.asarray(ssm), chunk=chunk)
    tconv = tuple(map(torch.from_numpy, conv))
    o, c, s = M2.mamba2_chunked(p, torch.from_numpy(x), tconv, torch.from_numpy(ssm), chunk=chunk)
    _close(ref_o, o, "mamba2 out")
    _close(ref_s, s, "mamba2 state")
    for rc, pc in zip(ref_c, c):
        assert tuple(pc.shape[1:]) == (M2.CONV_K - 1, rc.shape[-1])
        _close(rc, pc, "mamba2 conv carry")
    so, sc, ss = M2.mamba2_ref(p, torch.from_numpy(x), tconv, torch.from_numpy(ssm))
    np.testing.assert_allclose(o.numpy(), so.numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(s.numpy(), ss.numpy(), rtol=1e-3, atol=1e-3)


def test_mamba2_stepwise_matches_reference(mamba_pair):
    cfg, rp, p = mamba_pair
    x = np.random.default_rng(8).normal(size=(2, 12, cfg.d_model)).astype(np.float32) * 0.5
    conv, ssm = _mamba_states(cfg, 9)
    ref_o, ref_c, ref_s = RM2.mamba2_ref(rp, jnp.asarray(x), tuple(map(jnp.asarray, conv)),
                                         jnp.asarray(ssm))
    o, c, s = M2.mamba2_ref(p, torch.from_numpy(x), tuple(map(torch.from_numpy, conv)),
                            torch.from_numpy(ssm))
    _close(ref_o, o, "mamba2_ref out")
    _close(ref_s, s, "mamba2_ref state")
    for rc, pc in zip(ref_c, c):
        _close(rc, pc, "mamba2_ref conv")


# ---------------------------------------------------------------------------
# zamba2's hybrid layout, and the caches
# ---------------------------------------------------------------------------


def _serve_both(ref_model, ref_params, model, params, ids, prompt, max_len):
    """Prefill ``prompt`` tokens then decode the rest, both packages; returns
    [(ref logits, port logits)], ref cache, port cache."""
    ref_cache = ref_model.init_cache(ids.shape[0], max_len)
    cache = model.init_cache(ids.shape[0], max_len)
    ref_l, ref_cache = jax.jit(ref_model.prefill)(ref_params, jnp.asarray(ids[:, :prompt]), ref_cache)
    got, cache = model.prefill(params, torch.from_numpy(ids[:, :prompt]), cache)
    steps = [(ref_l, got)]
    dec = jax.jit(ref_model.decode)
    for t in range(prompt, ids.shape[1]):
        ref_l, ref_cache = dec(ref_params, jnp.asarray(ids[:, t:t + 1]), ref_cache, jnp.int32(t))
        got, cache = model.decode(params, torch.from_numpy(ids[:, t:t + 1]), cache, t)
        steps.append((ref_l, got))
    return steps, ref_cache, cache


def _caches_equal(ref_cache, cache, what):
    assert set(cache) == set(ref_cache), what
    for name, t in cache.items():
        if t.dtype.is_floating_point:
            _close(ref_cache[name], t, f"{what} cache {name}")
        else:
            np.testing.assert_array_equal(np.asarray(ref_cache[name]), t.numpy(), err_msg=name)


def test_zamba2_14_layers_last_group_has_no_shared_block():
    """14 layers, the shared block every 6: it runs after layers 5 and 11
    (two KV slots) and not after the last two."""
    ref_model, ref_params, model, params = _pair("zamba2-1.2b", seed=2, num_layers=14)
    assert model.n_shared == 2 and model.shared_after == {5: 0, 11: 1}
    ids = np.random.default_rng(13).integers(0, model.cfg.vocab_size, size=(2, 20))
    ref_fwd, _ = jax.jit(ref_model.forward)(ref_params, jnp.asarray(ids))
    fwd, _ = model.forward(params, torch.from_numpy(ids))
    _close(ref_fwd, fwd, "zamba2-14 forward", argmax=True)
    steps, ref_cache, cache = _serve_both(ref_model, ref_params, model, params, ids, 14, 20)
    for i, (r, g) in enumerate(steps):
        _close(r, g, f"zamba2-14 step {i}", argmax=True)
    assert tuple(cache["shared_k"].shape[:3]) == (2, 2, 20)
    _caches_equal(ref_cache, cache, "zamba2-14")


def test_zamba2_prefill_longer_than_cache():
    """A 24-token prompt into a 16-slot cache: each shared slot keeps the
    last 16 keys at slots 0..15 and ``positions`` reads 0..15, as the
    reference lays them out (a plain ring would label slot i with the position
it holds, 8 + i); four decode steps follow."""
    ref_model, ref_params, model, params = _pair("zamba2-1.2b", seed=4, num_layers=6)
    ids = np.random.default_rng(14).integers(0, model.cfg.vocab_size, size=(2, 28))
    steps, ref_cache, cache = _serve_both(ref_model, ref_params, model, params, ids, 24, 16)
    for i, (r, g) in enumerate(steps):
        _close(r, g, f"zamba2 long-prompt step {i}", argmax=True)
    _caches_equal(ref_cache, cache, "zamba2 long prompt")
    want = list(range(16))
    for t in range(24, 28):  # decode writes position t at slot t % 16
        want[t % 16] = t
    assert cache["positions"].tolist() == want


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "rwkv6-3b", "zamba2-1.2b"])
def test_decode_writes_every_cache_entry_in_place(arch):
    """``decode`` returns the cache it was given, every entry the same
    storage, now holding the reference's next cache."""
    ref_model, ref_params, model, params = _pair(arch, seed=6, num_layers=2,
                                                 **({"shared_attn_every": 1}
                                                    if arch == "zamba2-1.2b" else {}))
    ids = np.random.default_rng(15).integers(0, model.cfg.vocab_size, size=(2, 10))
    ref_cache = ref_model.init_cache(2, 12)
    _, ref_cache = jax.jit(ref_model.prefill)(ref_params, jnp.asarray(ids[:, :9]), ref_cache)
    _, cache = model.prefill(params, torch.from_numpy(ids[:, :9]), model.init_cache(2, 12))
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    _, ref_cache = jax.jit(ref_model.decode)(ref_params, jnp.asarray(ids[:, 9:]), ref_cache,
                                             jnp.int32(9))
    _, got = model.decode(params, torch.from_numpy(ids[:, 9:]), cache, 9)
    assert got is cache and {k: v.data_ptr() for k, v in got.items()} == ptrs
    _caches_equal(ref_cache, got, f"{arch} decode")
