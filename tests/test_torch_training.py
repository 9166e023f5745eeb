"""The reference's ``tests/test_training.py`` run against the port, and the
training modules held to the reference's.

The first eleven cases are the reference's, with their assertions, on
``repro_torch.training`` on the CPU: the optimizer, loss descent, gradient
compression, snapshot-bound checkpoints and the resume after a crash.
Where the reference builds a debug mesh the port takes ``device="cpu"``;
``compressed_psum`` runs on a one-rank gloo group made from a ``FileStore``
under ``tmp_path`` in place of the one-device ``shard_map``.  Two of these
cases fail in the reference on this tree (its ``make_train_step`` under an
explicit mesh; ROADMAP Queue 3): they pass on the port.

Then parity with the reference:

- ``adamw_update``: 5 steps on a random tree (nested dicts, a 0-d and a
  bf16 leaf), with and without clipping, against the reference's values to
  1e-6 of each leaf's scale (the bf16 leaf to one bf16 step); and the
  in-place contract (the same tensors come back, updated);
- ``cross_entropy`` with -100 labels and the (B, S, CB, V) codebook case;
- ``quantize_int8`` / ``compress_with_feedback``, bit for bit (both round
  half to even);
- checkpoints across packages both ways: the same leaf names and object
  keys, the same bytes, the same restored values; a bf16 leaf written in
  the reference's bytes;
- an async save, then an in-place step: the restore gives the state before
  the step.
"""

import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_cpu import tmp_store  # noqa: E402,F401
from repro.iceberg.catalog import RestCatalog as RefCatalog  # noqa: E402
from repro.lakehouse.objectstore import ObjectStore as RefObjectStore  # noqa: E402
from repro.training import checkpoint as RCK  # noqa: E402
from repro.training import compression as RC  # noqa: E402
from repro.training import optimizer as RO  # noqa: E402
from repro.training.train_loop import cross_entropy as ref_cross_entropy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens  # noqa: E402
from repro_torch.iceberg.catalog import RestCatalog  # noqa: E402
from repro_torch.lakehouse.objectstore import ObjectStore  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import checkpoint as CK  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.training.compression import (  # noqa: E402
    compress_with_feedback,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update, tree_leaves, tree_map  # noqa: E402
from repro_torch.training.train_loop import TrainStepConfig, cross_entropy, make_train_step  # noqa: E402



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its steps are thousands
    of small ops, and under the suite's parallel workers torch's thread
    pool turns each into a wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _build(cfg):
    return build_model(cfg, device="cpu")


def _init(model, seed=0):
    return model.init(torch.Generator().manual_seed(seed))


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = adamw_init(params)
    target = torch.tensor([1.0, 1.0, 1.0])
    for _ in range(300):
        grads = {"w": 2 * (params["w"] - target)}
        params, opt, _ = adamw_update(params, grads, opt, lr=0.05, weight_decay=0.0)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(4)}
    opt = adamw_init(params)
    grads = {"w": torch.full((4,), 1e6)}
    _, _, stats = adamw_update(params, grads, opt, clip_norm=1.0)
    assert float(stats["grad_norm"]) > 1e5  # reported pre-clip


def test_loss_decreases_small_model():
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), num_layers=2)
    model = _build(cfg)
    params = _init(model)
    step, _ = make_train_step(model, None, cfg=TrainStepConfig(microbatches=1, lr=1e-3, remat=False), device="cpu")
    opt = adamw_init(params)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=32, batch_size=8, seed=7)
    losses = []
    for i in range(12):
        ids, labels = data.batch(i % 2)  # small repeating set -> memorizable
        params, opt, m = step(params, opt, ids, labels)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_quantize_roundtrip_error_bounded():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32))
    q, scale = quantize_int8(x)
    err = np.abs((dequantize_int8(q, scale) - x).numpy())
    assert err.max() <= float(scale) / 2 + 1e-6


def test_error_feedback_is_unbiased_over_time():
    """With EF, the *accumulated* compressed sum tracks the true sum."""
    rng = np.random.default_rng(1)
    true_sum = np.zeros(64, np.float32)
    comp_sum = np.zeros(64, np.float32)
    err = torch.zeros(64)
    for i in range(200):
        g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
        q, scale, err = compress_with_feedback(g, err)
        comp_sum += dequantize_int8(q, scale).numpy()
        true_sum += g.numpy()
    drift = np.abs(comp_sum - true_sum).max()
    # residual error is bounded by one quantization step, not O(steps)
    assert drift < 0.2, drift


def test_compressed_psum_one_rank_group(tmp_path):
    import torch.distributed as dist

    from repro_torch.training.compression import compressed_psum

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "pg"), 1), rank=0,
                            world_size=1)
    try:
        grads = {"a": torch.arange(8.0), "b": torch.ones((3, 3))}
        errors = tree_map(torch.zeros_like, grads)
        out, new_e = compressed_psum(grads, errors)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(out["a"].numpy(), np.arange(8.0), atol=0.05)
    # one rank: the mean is the dequantized gradient, the error its residual
    for k in grads:
        q, scale, e = compress_with_feedback(grads[k], errors[k])
        torch.testing.assert_close(out[k], dequantize_int8(q, scale), rtol=0, atol=0)
        torch.testing.assert_close(new_e[k], e, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# checkpoints (snapshot-bound)
# ---------------------------------------------------------------------------

def test_checkpoint_save_restore_roundtrip(tmp_store):
    cat = RestCatalog(tmp_store)
    mgr = CheckpointManager(cat, async_save=False)
    state = {"w": torch.arange(6.0).reshape(2, 3), "step_data": {"b": torch.ones(4)}}
    mgr.save(10, state, metrics={"loss": 3.25})
    like = tree_map(torch.zeros_like, state)
    restored, step = mgr.restore(like)
    assert step == 10
    np.testing.assert_allclose(restored["w"].numpy(), state["w"].numpy())


def test_checkpoint_resume_latest_and_time_travel(tmp_store):
    cat = RestCatalog(tmp_store)
    mgr = CheckpointManager(cat, async_save=False, keep_last=3)
    state = {"w": torch.zeros(3)}
    for s in (1, 2, 3):
        mgr.save(s, {"w": torch.full((3,), float(s))})
    assert mgr.latest_step() == 3
    assert mgr.available_steps() == [1, 2, 3]
    restored, step = mgr.restore(state, step=2)
    assert step == 2 and float(restored["w"][0]) == 2.0


def test_checkpoint_async_and_crash_atomicity(tmp_store):
    cat = RestCatalog(tmp_store)
    mgr = CheckpointManager(cat, async_save=True)
    mgr.save(5, {"w": torch.ones(8)})
    mgr.wait()
    assert mgr.latest_step() == 5
    # a "crashed" save = objects without a commit -> invisible + orphaned
    meta = cat.load_table("__checkpoints")
    tmp_store.put(f"{meta.location}/data/step-00000099/w.npy", b"junk")
    assert mgr.latest_step() == 5
    from repro_torch.iceberg.gc import collect_orphans

    orphans = collect_orphans(tmp_store, cat.load_table("__checkpoints"))
    assert any("step-00000099" in o for o in orphans)


def test_checkpoint_retention(tmp_store):
    cat = RestCatalog(tmp_store)
    mgr = CheckpointManager(cat, async_save=False, keep_last=2)
    for s in range(5):
        mgr.save(s, {"w": torch.full((2,), float(s))})
    assert mgr.available_steps() == [3, 4]


def test_train_resume_after_crash(tmp_store):
    """checkpoint → 'crash' → restore → continue: loss trajectory intact."""
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), num_layers=2)
    model = _build(cfg)
    step, _ = make_train_step(model, None, cfg=TrainStepConfig(microbatches=1, lr=1e-3, remat=False), device="cpu")
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=16, batch_size=4, seed=3)
    params = _init(model)
    opt = adamw_init(params)
    cat = RestCatalog(tmp_store)
    mgr = CheckpointManager(cat, async_save=False)
    for i in range(3):
        ids, labels = data.batch(i)
        params, opt, _ = step(params, opt, ids, labels)
    mgr.save(3, {"params": params, "opt": opt})
    ids, labels = data.batch(3)
    params4, opt4, m4 = step(params, opt, ids, labels)
    # crash + restore
    like = {"params": tree_map(torch.zeros_like, params4),
            "opt": tree_map(torch.zeros_like, opt4)}
    restored, s = mgr.restore(like)
    assert s == 3
    p2, o2, m4b = step(restored["params"], restored["opt"], ids, labels)
    assert abs(float(m4["loss"]) - float(m4b["loss"])) < 1e-4  # deterministic resume


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


def _random_tree(rng):
    return {
        "embed": rng.normal(size=(6, 4)).astype(np.float32),
        "layers": {"w": rng.normal(size=(2, 4, 3)).astype(np.float32),
                   "b": rng.normal(size=(2, 3)).astype(np.float32)},
        "scale": np.float32(rng.normal()),
    }


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), tree)


def _scaled_err(ref, got):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    return float(np.abs(ref - got).max()) / max(1e-30, float(np.abs(ref).max()))


@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_adamw_update_matches_reference(clip_norm):
    """Five steps, a fresh random gradient each (scaled by 3 so the clip at
    1.0 bites), lr 1e-2, weight decay 0.1: params, moments, step and the
    reported grad norm against the reference's, each leaf to 1e-6 of its
    scale; the bf16 leaf to one bf16 step."""
    rng = np.random.default_rng(5)
    tree = _random_tree(rng)
    ref_params = jax.tree.map(jnp.asarray, tree)
    ref_params["half"] = jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16)
    params = _to_torch(tree)
    params["half"] = torch.from_numpy(np.asarray(ref_params["half"], np.float32)).bfloat16()
    ref_opt, opt = RO.adamw_init(ref_params), adamw_init(params)
    ids = [t.data_ptr() for t in tree_leaves(params) + tree_leaves(opt)]
    kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=clip_norm)
    for _ in range(5):
        g = jax.tree.map(lambda a: 3 * rng.normal(size=np.shape(a)).astype(np.float32), tree)
        g["half"] = 3 * rng.normal(size=(5,)).astype(np.float32)
        ref_params, ref_opt, ref_stats = RO.adamw_update(ref_params, jax.tree.map(jnp.asarray, g),
                                                         ref_opt, **kw)
        got_params, got_opt, stats = adamw_update(params, _to_torch(g), opt, **kw)
        assert got_params is params and got_opt is opt
        assert _scaled_err(ref_stats["grad_norm"], stats["grad_norm"].numpy()) < 1e-6
    assert [t.data_ptr() for t in tree_leaves(params) + tree_leaves(opt)] == ids
    assert int(opt.step) == int(ref_opt.step) == 5 and opt.step.dtype == torch.int32
    for name in ("embed", "scale"):
        assert _scaled_err(ref_params[name], params[name].numpy()) < 1e-6, name
    for name in ("w", "b"):
        assert _scaled_err(ref_params["layers"][name], params["layers"][name].numpy()) < 1e-6, name
    for ref_t, t in ((ref_opt.m, opt.m), (ref_opt.v, opt.v)):
        for r, p in zip(jax.tree_util.tree_leaves(ref_t), tree_leaves(t)):
            assert _scaled_err(r, p.numpy()) < 1e-6
    assert params["half"].dtype == torch.bfloat16
    np.testing.assert_allclose(params["half"].float().numpy(), np.asarray(ref_params["half"], np.float32),
                               rtol=2 ** -8, atol=0)


def test_adamw_update_reads_grads_and_no_host_value():
    """The gradient tree is left as it was; the step counter stays a 0-d
    int32 tensor on the params' device."""
    params = {"w": torch.ones(3)}
    grads = {"w": torch.full((3,), 5.0)}
    opt = adamw_init(params)
    adamw_update(params, grads, opt, clip_norm=1.0)
    assert torch.equal(grads["w"], torch.full((3,), 5.0))
    assert opt.step.shape == () and opt.step.device == params["w"].device


@pytest.mark.parametrize("codebooks", [0, 3])
def test_cross_entropy_matches_reference(codebooks):
    rng = np.random.default_rng(2)
    shape = (2, 5) + ((codebooks,) if codebooks else ())
    logits = (4 * rng.normal(size=shape + (11,))).astype(np.float32)
    labels = rng.integers(0, 11, size=shape).astype(np.int32)
    labels[0, :2] = -100  # masked positions
    want = float(ref_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * abs(want)
    # bf16 logits are widened to f32 first, as the reference does
    want16 = float(ref_cross_entropy(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels)))
    got16 = float(cross_entropy(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels)))
    assert abs(got16 - want16) <= 1e-6 * abs(want16)
    # every label masked: 0 / max(0, 1)
    none = np.full_like(labels, -100)
    assert float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0


def test_compression_matches_reference_bit_for_bit():
    """Error feedback over 20 steps: the int8 values, scales and residuals
    of the two packages have the same bits (every fourth gradient on a
    grid of tenths, so that many values share a quantization cell)."""
    rng = np.random.default_rng(9)
    err_r, err_t = jnp.zeros(257), torch.zeros(257)
    for i in range(20):
        g = rng.normal(size=257).astype(np.float32)
        if i % 4 == 0:
            g = (np.round(g * 10) + 0.5).astype(np.float32) / 10
        q_r, s_r, err_r = RC.compress_with_feedback(jnp.asarray(g), err_r)
        q_t, s_t, err_t = compress_with_feedback(torch.from_numpy(g), err_t)
        np.testing.assert_array_equal(np.asarray(q_r), q_t.numpy())
        assert np.asarray(s_r).tobytes() == s_t.numpy().tobytes()
        assert np.asarray(err_r).tobytes() == err_t.numpy().tobytes()
        assert q_t.dtype == torch.int8


def _state(seed=0):
    """A train state of each package with the same values: (reference tree,
    port tree)."""
    rng = np.random.default_rng(seed)
    p = {"embed": rng.normal(size=(5, 4)).astype(np.float32),
         "layers": {"w": rng.normal(size=(2, 4, 4)).astype(np.float32)}}
    m = jax.tree.map(lambda a: (0.1 * a).astype(np.float32), p)
    v = jax.tree.map(lambda a: (a * a).astype(np.float32), p)
    ref = {"params": jax.tree.map(jnp.asarray, p),
           "opt": RO.AdamWState(jax.tree.map(jnp.asarray, m), jax.tree.map(jnp.asarray, v),
                                jnp.asarray(7, jnp.int32))}
    port = {"params": _to_torch(p),
            "opt": AdamWState(_to_torch(m), _to_torch(v), torch.tensor(7, dtype=torch.int32))}
    return ref, port


def test_leaf_names_match_reference():
    ref, port = _state()
    want = [name for name, _ in RCK._flatten_with_paths(ref)[0]]
    got = [name for name, _ in CK._flatten_with_paths(port)]
    assert got == want
    assert "opt/.m/embed" in got and "opt/.step" in got and "params/layers/w" in got


def _objects(store, root):
    import os

    base = os.path.join(store.root, root)
    out = {}
    for dirpath, _dirs, files in os.walk(base):
        for f in files:
            if f.endswith(".npy"):
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(dirpath, f), base)] = fh.read()
    return out


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A checkpoint saved by one package restores in the other with the
    same values; both packages write the same object keys and bytes."""
    ref, port = _state()
    roots = {}
    for who in ("port", "reference"):
        root = str(tmp_path / who)
        if who == "port":
            CheckpointManager(RestCatalog(ObjectStore(root)), async_save=False).save(7, port)
        else:
            RCK.CheckpointManager(RefCatalog(RefObjectStore(root)), async_save=False).save(7, ref)
        roots[who] = root
    objs = {who: _objects(ObjectStore(r), "") for who, r in roots.items()}
    strip = {who: {k.split("/data/", 1)[1]: v for k, v in o.items()} for who, o in objs.items()}
    assert strip["port"] == strip["reference"]
    assert "step-00000007/opt_.m_embed.npy" in strip["port"]

    src = roots[writer]
    zeros_r = jax.tree.map(jnp.zeros_like, ref)
    got_r, s_r = RCK.CheckpointManager(RefCatalog(RefObjectStore(src))).restore(zeros_r)
    got_t, s_t = CheckpointManager(RestCatalog(ObjectStore(src))).restore(tree_map(torch.zeros_like, port))
    assert s_r == s_t == 7
    for (name, want), (_n, got) in zip(RCK._flatten_with_paths(ref)[0],
                                       CK._flatten_with_paths(got_t)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    for (name, want), (_n, got) in zip(RCK._flatten_with_paths(ref)[0],
                                       RCK._flatten_with_paths(got_r)[0]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)
    assert got_t["opt"].step.dtype == torch.int32 and got_t["opt"].step.shape == ()


def test_bf16_leaf_in_the_reference_bytes(tmp_path):
    """The reference saves a bf16 leaf as two-byte void records and hands
    it back as a ``|V2`` array; the port writes the same bytes and restores
    them into a bf16 leaf bit for bit (and refuses them for an f32 one)."""
    x = jnp.asarray(np.random.default_rng(4).normal(size=(3, 5)), jnp.bfloat16)
    root_r, root_t = str(tmp_path / "r"), str(tmp_path / "t")
    RCK.CheckpointManager(RefCatalog(RefObjectStore(root_r)), async_save=False).save(1, {"h": x})
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    CheckpointManager(RestCatalog(ObjectStore(root_t)), async_save=False).save(1, {"h": xt})
    (k_r, b_r), = _objects(ObjectStore(root_r), "").items()
    (k_t, b_t), = _objects(ObjectStore(root_t), "").items()
    assert b_r == b_t and k_r.endswith("h.npy")
    assert np.load(io.BytesIO(b_r), allow_pickle=False).dtype == np.dtype("V2")
    got, _ = CheckpointManager(RestCatalog(ObjectStore(root_r))).restore({"h": torch.zeros(3, 5, dtype=torch.bfloat16)})
    assert torch.equal(got["h"].view(torch.int16), xt.view(torch.int16))
    with pytest.raises(ValueError, match="cannot restore"):
        CheckpointManager(RestCatalog(ObjectStore(root_r))).restore({"h": torch.zeros(3, 5)})


def test_async_save_then_in_place_step_restores_the_saved_state(tmp_store):
    """The step rewrites the state in place right after an async ``save``;
    the restore still gives the state as it was at ``save`` (the host copies
    are taken before the thread starts)."""
    cfg = dataclasses.replace(reduced(get_config("qwen2.5-3b")), num_layers=2)
    model = _build(cfg)
    step, _ = make_train_step(model, None, cfg=TrainStepConfig(microbatches=2, lr=1e-3), device="cpu")
    params = _init(model)
    opt = adamw_init(params)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=16, batch_size=4, seed=1)
    params, opt, _ = step(params, opt, *data.batch(0))
    saved = tree_map(torch.clone, {"params": params, "opt": opt})
    mgr = CheckpointManager(RestCatalog(tmp_store), async_save=True)
    mgr.save(1, {"params": params, "opt": opt})
    for i in (1, 2):
        params, opt, _ = step(params, opt, *data.batch(i))
    assert not torch.equal(params["embed"], saved["params"]["embed"])
    restored, at = mgr.restore(tree_map(torch.zeros_like, saved))
    assert at == 1
    for (name, want), (_n, got) in zip(CK._flatten_with_paths(saved), CK._flatten_with_paths(restored)):
        assert torch.equal(got, want), name


def test_save_error_surfaces_on_wait(tmp_store):
    """A save that fails on its thread raises from the next ``wait`` (the
    reference's thread would drop it)."""
    mgr = CheckpointManager(RestCatalog(tmp_store), async_save=True)
    store_put = tmp_store.put

    def failing_put(key, data, **kw):
        if "/data/" in key:
            raise OSError("disk full")
        return store_put(key, data, **kw)

    tmp_store.put = failing_put
    mgr.save(2, {"w": torch.ones(3)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    tmp_store.put = store_put
    assert mgr.latest_step() is None
