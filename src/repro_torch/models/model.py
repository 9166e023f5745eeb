"""Model assembly: the dense decoder family.

Port of ``repro/models/model.py``.  ``build_model(cfg, tp=..., device=...)``
returns a :class:`Model` whose methods keep the reference's signatures:

- ``init(generator)``          → params tree (nested dicts of tensors)
- ``axes``                     → parallel tree of logical-axis tuples
- ``forward(params, ids)``     → (logits, aux_loss)
- ``init_cache(B, max_len)``   → serving cache
- ``prefill(params, ids, cache)`` → (logits_last, cache)
- ``decode(params, ids_1, cache, pos)`` → (logits, cache)

The params keep the reference's layout: every per-layer tensor is stacked
under ``layers/...`` with a leading layer dimension, and the cache is
``k``, ``v`` of shape (layers, B, W, KV, hd) with ``positions`` (W,) int32,
so a reference tree or cache converts one to one (:func:`params_from_numpy`).
Where the reference scans over the layer dimension, the port loops over it.
``decode`` writes the new token's keys and values into ``cache`` in place
(the reference donates the cache to the same effect).

KV heads are padded up to the tensor-parallel degree by the reference's rule
(``build_model``), so parameter shapes match the reference's for any ``tp``.

Ported: the dense transformer (full or sliding-window attention, RoPE full
or partial, QKV bias, qk-norm, SwiGLU / squared-ReLU / GELU MLPs, the
codebook heads of musicgen).  Not yet: the MoE block, ``rwkv6`` and
``mamba2`` (ROADMAP Queue 1, item 5): ``build_model`` raises
``NotImplementedError`` for them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.device_cache import concrete_device
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamBuilder

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"`` /
    ``"float32"``)."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# parameter init (dense family)
# ---------------------------------------------------------------------------


def _init_params(cfg: ModelConfig, kv_eff: int, generator, *, dtype=torch.float32,
                 device="cpu", abstract: bool = False):
    b = ParamBuilder(generator, dtype=dtype, device=device, abstract=abstract)
    d, V = cfg.d_model, cfg.vocab_size
    nl = cfg.num_layers
    cfg_kv = dataclasses.replace(cfg, num_kv_heads=kv_eff)
    # embeddings
    if cfg.num_codebooks:
        b.add("embed", (cfg.num_codebooks, V, d), ("codebook", "vocab", "embed"), scale=0.02)
        b.add("lm_head", (cfg.num_codebooks, d, V), ("codebook", "embed", "vocab"), scale=0.02)
        # learned positions sized for the largest assigned serving shape (32k)
        b.add("pos_embed", (32768, d), (None, "embed"), scale=0.02)
    else:
        b.add("embed", (V, d), ("vocab", "embed"), scale=0.02)
        b.add("lm_head", (d, V), ("embed", "vocab"), scale=0.02)
    # per-layer stacks: leading "layers" dim on every per-layer param
    layer_axes = (nl,)
    L.add_norm_params(b, "layers/ln_att", d, cfg.norm, layer_axes)
    L.add_attention_params(b, "layers/attn", cfg_kv, layer_axes, kv_heads=kv_eff)
    L.add_norm_params(b, "layers/ln_mlp", d, cfg.norm, layer_axes)
    L.add_mlp_params(b, "layers/mlp", cfg, layer_axes)
    L.add_norm_params(b, "final_norm", d, cfg.norm)
    return b.params, b.axes


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked ``layers`` tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed(params, cfg: ModelConfig, ids: torch.Tensor, dtype) -> torch.Tensor:
    if cfg.num_codebooks:
        # ids: (B, S, CB)
        tables = params["embed"]  # (CB, V, D)
        x = tables[0][ids[..., 0]].to(dtype)
        for cb in range(1, cfg.num_codebooks):
            x = x + tables[cb][ids[..., cb]].to(dtype)
        S = ids.shape[1]
        return x + params["pos_embed"][:S][None, :, :].to(dtype)
    return params["embed"][ids].to(dtype)


def _embed_decode(params, cfg: ModelConfig, ids: torch.Tensor, pos: int, dtype) -> torch.Tensor:
    if cfg.num_codebooks:
        tables = params["embed"]
        x = tables[0][ids[..., 0]].to(dtype)
        for cb in range(1, cfg.num_codebooks):
            x = x + tables[cb][ids[..., cb]].to(dtype)
        pe = params["pos_embed"][pos:pos + 1]
        return x + pe.to(dtype)[None, :, :]
    return params["embed"][ids].to(dtype)


def _head(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.num_codebooks:
        return torch.einsum("bsd,cdv->bscv", x, params["lm_head"].to(x.dtype))
    return x @ params["lm_head"].to(x.dtype)


# ---------------------------------------------------------------------------
# attention blocks
# ---------------------------------------------------------------------------


def _rope_frac(cfg: ModelConfig) -> float:
    return cfg.rope_frac if cfg.rope == "partial" else 1.0


def _attn_full(p, cfg: ModelConfig, x, q_offset: int = 0):
    q, k, v = L._project_qkv(p, cfg, x)
    if cfg.rope != "none":
        S = x.shape[1]
        pos = (q_offset + torch.arange(S, device=x.device)).expand(x.shape[0], S)
        q = L.apply_rope(q, pos, _rope_frac(cfg), cfg.rope_theta)
        k = L.apply_rope(k, pos, _rope_frac(cfg), cfg.rope_theta)
    window = cfg.window if cfg.attention == "swa" else 0
    attn = L.flash_attention_sparse if cfg.attn_impl == "sparse" else L.flash_attention
    out = attn(q, k, v, q_offset=q_offset, causal=True, window=window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype)), (k, v)


def _attn_decode(p, cfg: ModelConfig, x, k_cache, v_cache, cache_positions, pos: int):
    """One token's attention; writes its k / v into slot ``pos % W`` of
    ``k_cache`` / ``v_cache`` (B, W, KV, hd) in place."""
    q, k, v = L._project_qkv(p, cfg, x)
    if cfg.rope != "none":
        posb = torch.full((x.shape[0], 1), pos, dtype=torch.int64, device=x.device)
        q = L.apply_rope(q, posb, _rope_frac(cfg), cfg.rope_theta)
        k = L.apply_rope(k, posb, _rope_frac(cfg), cfg.rope_theta)
    slot = pos % k_cache.shape[1]
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    window = cfg.window if cfg.attention == "swa" else 0
    out = L.decode_attention(q, k_cache, v_cache, cache_positions, pos, window=window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# family: dense transformer
# ---------------------------------------------------------------------------


class Model:
    """The dense decoder on one device; the methods mirror the reference's
    ``Model`` fields."""

    def __init__(self, cfg: ModelConfig, kv_eff: int, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.kv_eff = kv_eff  # kv heads after TP padding
        self.device = device
        self.generator = generator
        self.dtype = _compute_dtype(cfg)
        self._cfg_kv = dataclasses.replace(cfg, num_kv_heads=kv_eff)
        self.axes = _init_params(cfg, kv_eff, None, abstract=True)[1]

    # -- params -------------------------------------------------------------

    def init(self, generator: Optional[torch.Generator] = None, dtype=torch.float32):
        """Fresh params on the model's device, drawn from ``generator`` (the
        one given to ``build_model`` by default) and stored in ``dtype``: f32
        as the reference's masters, or ``cfg.param_dtype`` for serving."""
        gen = generator if generator is not None else self.generator
        if gen is None:
            raise ValueError("init needs a torch.Generator (here or in build_model)")
        return _init_params(self.cfg, self.kv_eff, gen, dtype=dtype, device=self.device)[0]

    def param_count(self, params=None) -> int:
        return L.param_count(params if params is not None else param_shapes(self))

    # -- full sequence --------------------------------------------------------

    def _block(self, lp, x, q_offset: int = 0):
        cfg = self.cfg
        h = L.apply_norm(cfg.norm, lp["ln_att"], x)
        att, kv = _attn_full(lp["attn"], self._cfg_kv, h, q_offset)
        x = x + att
        h = L.apply_norm(cfg.norm, lp["ln_mlp"], x)
        return x + L.mlp_block(lp["mlp"], h, cfg.mlp), kv

    def forward(self, params, ids):
        cfg = self.cfg
        x = _embed(params, cfg, ids, self.dtype)
        for i in range(cfg.num_layers):
            x, _ = self._block(_layer(params["layers"], i), x)
        x = L.apply_norm(cfg.norm, params["final_norm"], x)
        return _head(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)

    # -- serving --------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int):
        cfg = self.cfg
        W = min(max_len, cfg.window) if cfg.attention == "swa" and cfg.window else max_len
        shape = (cfg.num_layers, batch, W, self.kv_eff, cfg.head_dim)
        cache_dt = getattr(torch, cfg.cache_dtype) if cfg.cache_dtype else self.dtype
        return {
            "k": torch.zeros(shape, dtype=cache_dt, device=self.device),
            "v": torch.zeros(shape, dtype=cache_dt, device=self.device),
            "positions": torch.full((W,), -1, dtype=torch.int32, device=self.device),
        }

    def cache_axes(self, batch: int, max_len: int):
        ax = ("layers", "cache_batch", "cache_seq", "cache_heads", "head_dim")
        return {"k": ax, "v": ax, "positions": ("cache_seq",)}

    def prefill(self, params, ids, cache):
        """Run the full prompt, filling the cache; returns last-token logits
        and the cache in ring layout: position p at slot p % W."""
        cfg = self.cfg
        x = _embed(params, cfg, ids, self.dtype)
        S = ids.shape[1]
        W = cache["k"].shape[2]
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, (k, v) = self._block(_layer(params["layers"], i), x)
            # keep the last W positions of k/v for the cache
            ks.append(k[:, -W:].to(self.dtype))
            vs.append(v[:, -W:].to(self.dtype))
        x = L.apply_norm(cfg.norm, params["final_norm"], x)
        logits = _head(params, cfg, x[:, -1:, :])
        ks, vs = torch.stack(ks), torch.stack(vs)  # (layers, B, min(S, W), KV, hd)
        kept = torch.arange(W, device=x.device)
        if S >= W:
            # slots hold positions S-W .. S-1 at slot p%W
            pos_of_slot = (S - W) + (kept - (S - W) % W + W) % W
            src_idx = pos_of_slot - (S - W)
        else:
            pos_of_slot = torch.where(kept < S, kept, -1)
            src_idx = pos_of_slot.clamp(0, S - 1)
        live = (pos_of_slot >= 0)[None, None, :, None, None]
        k_ring = torch.where(live, ks[:, :, src_idx], 0)
        v_ring = torch.where(live, vs[:, :, src_idx], 0)
        return logits, {"k": k_ring, "v": v_ring, "positions": pos_of_slot.to(torch.int32)}

    def decode(self, params, ids, cache, pos):
        """One token at absolute position ``pos`` (an int); updates ``cache``
        in place and returns (logits, cache)."""
        cfg = self.cfg
        pos = int(pos)
        x = _embed_decode(params, cfg, ids, pos, self.dtype)
        W = cache["k"].shape[2]
        positions = cache["positions"]
        positions[pos % W] = pos
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            h = L.apply_norm(cfg.norm, lp["ln_att"], x)
            x = x + _attn_decode(lp["attn"], self._cfg_kv, h, cache["k"][i], cache["v"][i],
                                 positions, pos)
            h = L.apply_norm(cfg.norm, lp["ln_mlp"], x)
            x = x + L.mlp_block(lp["mlp"], h, cfg.mlp)
        x = L.apply_norm(cfg.norm, params["final_norm"], x)
        return _head(params, cfg, x), cache


# ---------------------------------------------------------------------------
# public factory
# ---------------------------------------------------------------------------


def build_model(cfg: ModelConfig, *, tp: int = 1, device="cuda",
                generator: Optional[torch.Generator] = None) -> Model:
    """The model of ``cfg`` on ``device`` (CUDA by default; raises without a
    card).  ``generator`` is ``init``'s default source of draws."""
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: the MoE block is not ported yet (ROADMAP Queue 1, item 5)")
    if cfg.ssm:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.ssm} family is not ported yet (ROADMAP Queue 1, item 5)")
    # Pad KV heads up to the TP degree so GQA caches shard cleanly — only
    # when the padding keeps a valid grouping (KV | H) and is a true
    # replication (kv | tp); otherwise keep the native kv heads.
    kv_eff = cfg.num_kv_heads
    if (
        cfg.pad_kv_to_tp
        and cfg.attention != "none"
        and tp > cfg.num_kv_heads
        and cfg.num_heads % tp == 0
        and tp % cfg.num_kv_heads == 0
    ):
        kv_eff = tp
    return Model(cfg, kv_eff, concrete_device(device), generator)


def param_shapes(model: Model):
    """Shape-only (``meta``) tree of the params (no allocation)."""
    return _init_params(model.cfg, model.kv_eff, None, abstract=True)[0]


def params_from_numpy(model: Model, tree, dtype: torch.dtype = torch.float32) -> Any:
    """The reference's ``model.init(key)`` tree (numpy arrays, the stacked
    ``layers/...`` dimension included) as the port's params on the model's
    device, stored in ``dtype``.  Keys and shapes are checked against the
    port's."""
    shapes = param_shapes(model)

    def convert(want, got):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                raise ValueError(f"params tree keys {sorted(got)} != {sorted(want)}")
            return {k: convert(want[k], got[k]) for k in want}
        arr = np.asarray(got)
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"param shape {arr.shape} != {tuple(want.shape)}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        return t.to(device=model.device, dtype=dtype)

    return convert(shapes, tree)
