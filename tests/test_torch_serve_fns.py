"""The port's LM serving steps (``make_serve_fns``) held to the reference.

The reference's ``make_serve_fns`` does not run on this tree (its jitted
decode under explicit mesh shardings raises ``ShardingTypeError`` in
``_attn_decode``), so the oracle is built from the reference parts that do
run: its model's jitted ``prefill`` / ``decode`` without a mesh, its
``make_probe_fn`` on a one-device mesh, and the kNN-LM mixing formula of
``repro/serving/serve_loop.py:653-679``, written out in numpy below.

- kNN-LM decode at f32 (a plain head and musicgen's codebook heads, and the
  rwkv6, zamba2 and MoE families, whose caches are their own): the
  port's probe returns the oracle probe's neighbour tokens, its soft-
  embedding queries agree to 1e-5, and its mixed logits to 1e-4.
- ``tests/test_serving.py``'s two serving cases (``:61``, ``:96``) on the
  port, in bf16 serving params as the reference serves.
- A greedy loop gives the reference's unsharded greedy loop's tokens on the
  same weights (f32).
- Sampling draws from an explicit generator; params not in the serving
  dtype are refused; the steps run on the card unless told otherwise.
- The launcher's ``main`` serves each new family reduced on the CPU with
  retrieval, and ``--full`` counts a MoE's experts against the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.vamana import VamanaParams as RefVamanaParams  # noqa: E402
from repro.core.vamana import build_vamana as ref_build_vamana  # noqa: E402
from repro.launch.mesh import make_debug_mesh  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.serving.device_index import DeviceAnnIndex as RefIndex  # noqa: E402
from repro.serving.device_index import make_probe_fn as ref_make_probe_fn  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.vamana import VamanaParams, build_vamana  # noqa: E402
from repro_torch.models.model import build_model, params_from_numpy  # noqa: E402
from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn  # noqa: E402
from repro_torch.serving.serve_loop import ServeConfig, make_serve_fns  # noqa: E402

CPU = "cpu"


# zamba2 at 3 layers with its shared block every 2: one shared invocation
OVER = {"zamba2-1.2b": dict(num_layers=3, shared_attn_every=2)}
NEW = ["rwkv6-3b", "zamba2-1.2b", "mixtral-8x7b"]


def _pair(arch, seed=0, **over):
    """Reference model + f32 params and the port's twin on the CPU (f32
    compute), reduced to 2 layers."""
    over = {"num_layers": 2, **OVER.get(arch, {}), **over}
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)), dtype="float32", **over)
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32", **over)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    model = build_model(cfg, device=CPU)
    tree = jax.tree.map(np.asarray, ref_params)
    return ref_model, ref_params, model, params_from_numpy(model, tree)


def _knn_lm_oracle(logits, head, dists, tokens, lam, temp, codebooks):
    """``serve_loop.py:653-679`` in numpy: the soft-embedding query, then
    the neighbour tokens' softmax(-d / T) weights scattered into a vocab
    distribution and mixed with the model's."""
    x = logits.astype(np.float64)
    probs = np.exp(x - x.max(-1, keepdims=True))
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    if codebooks:
        q = np.einsum("bscv,cdv->bsd", probs, head)[:, 0]
    else:
        q = np.einsum("bsv,dv->bsd", probs, head)[:, 0]
    if dists is None:
        return q, None
    e = np.exp(-(dists - dists.min(-1, keepdims=True)) / temp)
    w = e / e.sum(-1, keepdims=True)
    V = logits.shape[-1]
    knn = np.zeros((q.shape[0], V), np.float64)
    for b in range(q.shape[0]):
        for j in range(tokens.shape[1]):
            knn[b, np.clip(tokens[b, j], 0, V - 1)] += w[b, j] * (tokens[b, j] >= 0)
    base = probs[:, 0]
    mixed = (1 - lam) * base + lam * (knn[:, None, :] if codebooks else knn)
    return q, np.log(np.maximum(mixed, 1e-20))[:, None]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "musicgen-medium"] + NEW)
def test_knn_lm_decode_matches_oracle(arch):
    ref_model, ref_params, model, params = _pair(arch)
    cfg = model.cfg
    rng = np.random.default_rng(2)
    corpus = rng.normal(size=(500, cfg.d_model)).astype(np.float32) * 0.05
    tokens = rng.integers(0, cfg.vocab_size, size=500)
    g = ref_build_vamana(corpus, RefVamanaParams(R=8, L=16), passes=1, batch=128)
    shape = (2, 8, cfg.num_codebooks) if cfg.num_codebooks else (2, 8)
    ids = rng.integers(0, cfg.vocab_size, size=shape)
    lam, temp = 0.5, 1.0

    # the oracle: the reference's model, then its probe, then the formula
    cache = ref_model.init_cache(2, 16)
    _, cache = jax.jit(ref_model.prefill)(ref_params, jnp.asarray(ids), cache)
    ref_logits, _ = jax.jit(ref_model.decode)(ref_params, jnp.asarray(ids[:, -1:]), cache,
                                              jnp.int32(8))
    head = np.asarray(ref_params["lm_head"])
    want_q, _ = _knn_lm_oracle(np.asarray(ref_logits), head, None, None, lam, temp,
                               cfg.num_codebooks)
    mesh = make_debug_mesh(1, 1)
    ref_idx = RefIndex.from_graphs([g], payloads=[tokens])
    with mesh:
        ref_d, ref_tok = jax.jit(ref_make_probe_fn(mesh, k=4, L=16))(ref_idx, jnp.asarray(want_q))
    ref_d, ref_tok = np.asarray(ref_d), np.asarray(ref_tok)
    _, want = _knn_lm_oracle(np.asarray(ref_logits), head, ref_d, ref_tok, lam, temp,
                             cfg.num_codebooks)

    # the port, its probe captured
    port_probe = make_probe_fn(k=4, L=16, device=CPU)
    seen = {}

    def probe(index, q):
        seen["q"] = q.clone()
        seen["d"], seen["tok"] = port_probe(index, q)
        return seen["d"], seen["tok"]

    prefill, decode, _, _ = make_serve_fns(
        model, cfg=ServeConfig(knn_lambda=lam, knn_temperature=temp, param_dtype="float32"),
        retrieval=probe, device=CPU)
    idx = DeviceAnnIndex.from_graphs([g], payloads=[tokens], device=CPU)
    cache = model.init_cache(2, 16)
    _, cache = prefill(params, torch.from_numpy(ids), cache)
    got, _ = decode(params, torch.from_numpy(ids[:, -1:]), cache, 8, idx)

    np.testing.assert_allclose(seen["q"].numpy(), want_q, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(seen["tok"].numpy(), ref_tok)
    np.testing.assert_allclose(seen["d"].numpy(), ref_d, rtol=1e-5, atol=1e-6)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_knn_lm_decode_runs_and_mixes():
    """``tests/test_serving.py:61`` on the port (bf16 serving params)."""
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), num_layers=2)
    model = build_model(cfg, device=CPU)
    params = model.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    rng = np.random.default_rng(2)
    # corpus in lm_head space with token payloads
    d = cfg.d_model
    corpus = rng.normal(size=(500, d)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, size=500)
    g = build_vamana(corpus, VamanaParams(R=8, L=16), passes=1, batch=128, device=CPU)
    idx = DeviceAnnIndex.from_graphs([g], payloads=[tokens], device=CPU)
    probe = make_probe_fn(k=4, L=16, device=CPU)
    prefill, decode, sample, _ = make_serve_fns(
        model, cfg=ServeConfig(knn_lambda=0.5), retrieval=probe, device=CPU)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 8)))
    cache = model.init_cache(2, 16)
    _, cache = prefill(params, ids, cache)
    logits, cache = decode(params, ids[:, -1:], cache, 8, idx)
    assert bool(torch.isfinite(logits).all())
    # λ=0 vs λ=0.5 must differ (retrieval actually contributes)
    prefill0, decode0, _, _ = make_serve_fns(
        model, cfg=ServeConfig(knn_lambda=0.0), retrieval=probe, device=CPU)
    cache0 = model.init_cache(2, 16)
    _, cache0 = prefill0(params, ids, cache0)
    logits0, _ = decode0(params, ids[:, -1:], cache0, 8, idx)
    assert float((logits - logits0).abs().max()) > 1e-4


def test_greedy_generation_loop():
    """``tests/test_serving.py:96`` on the port."""
    cfg = dataclasses.replace(reduced(get_config("chatglm3-6b")), num_layers=2)
    model = build_model(cfg, device=CPU)
    params = model.init(torch.Generator().manual_seed(1), dtype=torch.bfloat16)
    prefill, decode, sample, _ = make_serve_fns(model, device=CPU)
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 8)))
    cache = model.init_cache(1, 24)
    logits, cache = prefill(params, prompt, cache)
    tok = sample(logits)
    outs = [int(tok[0, 0])]
    for t in range(8, 16):
        logits, cache = decode(params, tok, cache, t)
        tok = sample(logits)
        outs.append(int(tok[0, 0]))
    assert len(outs) == 9
    assert all(0 <= t < cfg.vocab_size for t in outs)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "musicgen-medium"] + NEW)
def test_greedy_loop_matches_reference(arch):
    """The reference's own greedy loop, unsharded (its jitted prefill and
    decode, argmax), gives the port's tokens on the same f32 weights."""
    ref_model, ref_params, model, params = _pair(arch, seed=1)
    cfg = model.cfg
    rng = np.random.default_rng(3)
    shape = (2, 8, cfg.num_codebooks) if cfg.num_codebooks else (2, 8)
    prompt = rng.integers(0, cfg.vocab_size, size=shape)

    cache = ref_model.init_cache(2, 24)
    logits, cache = jax.jit(ref_model.prefill)(ref_params, jnp.asarray(prompt), cache)
    tok = jnp.argmax(logits, axis=-1)
    want = [np.asarray(tok)]
    dec = jax.jit(ref_model.decode)
    for t in range(8, 24):
        logits, cache = dec(ref_params, tok, cache, jnp.int32(t))
        tok = jnp.argmax(logits, axis=-1)
        want.append(np.asarray(tok))

    prefill, decode, sample, _ = make_serve_fns(model, cfg=ServeConfig(param_dtype="float32"),
                                             device=CPU)
    cache = model.init_cache(2, 24)
    logits, cache = prefill(params, torch.from_numpy(prompt), cache)
    tok = sample(logits)
    got = [tok.numpy()]
    for t in range(8, 24):
        logits, cache = decode(params, tok, cache, t)
        tok = sample(logits)
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_sampling_draws_from_the_generator():
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), num_layers=1)
    model = build_model(cfg, device=CPU)
    _, _, sample, _ = make_serve_fns(model, cfg=ServeConfig(greedy=False), device=CPU)
    logits = torch.randn((4, 1, cfg.vocab_size), generator=torch.Generator().manual_seed(0))
    a = sample(logits, torch.Generator().manual_seed(7))
    b = sample(logits, torch.Generator().manual_seed(7))
    assert tuple(a.shape) == (4, 1) and torch.equal(a, b)
    # a peaked distribution is sampled at its peak
    peaked = torch.full((2, 1, cfg.vocab_size), -1e4)
    peaked[:, :, 5] = 0.0
    assert sample(peaked, torch.Generator().manual_seed(0)).flatten().tolist() == [5, 5]


def test_serving_refuses_params_not_in_serving_dtype():
    """Serving keeps no f32 masters: bf16 is the default serving dtype."""
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), num_layers=1)
    model = build_model(cfg, device=CPU)
    params = model.init(torch.Generator().manual_seed(0))  # f32
    prefill, _, _, _ = make_serve_fns(model, device=CPU)
    with pytest.raises(ValueError, match="bfloat16"):
        prefill(params, torch.zeros((1, 4), dtype=torch.int64), model.init_cache(1, 8))


def test_serve_fns_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), num_layers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_serve_fns(build_model(cfg, device=CPU))


@pytest.mark.parametrize("arch,retrieval", [("dbrx-132b", False), ("mixtral-8x7b", True),
                                            ("rwkv6-3b", False), ("zamba2-1.2b", False)])
def test_launcher_serves_new_families(arch, retrieval, capsys):
    """``python -m repro_torch.launch.serve --arch A [--retrieval] --device
    cpu`` at the reduced config, a short run (the corpus index, the same
    for every family, built once)."""
    from repro_torch.launch.serve import main

    flags = ["--retrieval"] if retrieval else []
    assert main(["--arch", arch, "--batch", "2", "--prompt", "8", "--gen", "4", *flags,
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (f"[serve] {arch}: batch=2 prompt=8 gen=4 "
                      f"retrieval={'on' if retrieval else 'off'}")
    assert out[1].startswith("  prefill: ") and out[2].startswith("  decode:  "), out


def test_full_launch_counts_experts(monkeypatch):
    """``--full`` refuses a model whose bf16 parameters, experts included,
    exceed 85 % of the card: mixtral-8x7b (46.7 B) on an 80 GB card; the
    rwkv6 and zamba2 models fit.  The count is the parameter tree's."""
    from repro_torch.launch import serve

    class Props:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props())
    cuda = torch.device("cuda", 0)
    mixtral = build_model(get_config("mixtral-8x7b"), device=CPU)
    assert mixtral.param_count() > 46_700_000_000
    with pytest.raises(ValueError, match="mixtral-8x7b: 93.4 GB"):
        serve._check_fits(mixtral, cuda, torch.bfloat16)
    for arch in ("rwkv6-3b", "zamba2-1.2b"):
        serve._check_fits(build_model(get_config(arch), device=CPU), cuda, torch.bfloat16)
