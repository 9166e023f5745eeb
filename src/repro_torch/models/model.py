"""Model assembly: one decoder skeleton, four families.

Port of ``repro/models/model.py``.  ``build_model(cfg, tp=..., device=...)``
returns a :class:`Model` whose methods keep the reference's signatures:

- ``init(generator)``          → params tree (nested dicts of tensors)
- ``axes``                     → parallel tree of logical-axis tuples
- ``forward(params, ids)``     → (logits, aux_loss)
- ``init_cache(B, max_len)``   → serving cache
- ``prefill(params, ids, cache)`` → (logits_last, cache)
- ``decode(params, ids_1, cache, pos)`` → (logits, cache)

The params keep the reference's layout: every per-layer tensor is stacked
under ``layers/...`` with a leading layer dimension (zamba2's shared block
under ``shared/...``, unstacked), and so does each family's cache, so a
reference tree or cache converts one to one (:func:`params_from_numpy`).
Where the reference scans over the layer dimension, the port loops over it.
``prefill`` starts from the states of the cache it is given and returns a
new cache; ``decode`` writes every cache entry in place (the reference
donates the cache to the same effect).

The families:

- dense / MoE transformer (full or sliding-window attention, RoPE full or
  partial, QKV bias, qk-norm, SwiGLU / squared-ReLU / GELU MLPs, the
  codebook heads of musicgen; the MoE block's GShard dispatch in
  ``forward`` / ``prefill`` and its dense dispatch in ``decode``, as the
  reference splits them): cache ``k``, ``v`` (layers, B, W, KV, hd) and
  ``positions`` (W,) int32;
- ``rwkv6``: cache ``x_att``, ``x_ffn`` (layers, B, D), the token-shift
  carries of the time- and channel-mix, and ``wkv`` (layers, B, H, N, N)
  f32;
- ``mamba2`` (+ zamba2's shared attention + MLP block after every full
  group of ``shared_attn_every`` layers): cache ``conv_x``, ``conv_B``,
  ``conv_C`` (layers, B, 3, ·) in the compute dtype, ``ssm`` (layers, B,
  H, N, P) f32, and, with a shared block, ``shared_k`` / ``shared_v``
  (n_shared, B, max_len, KV, hd) and ``positions``.

KV heads are padded up to the tensor-parallel degree by the reference's rule
(``build_model``), so parameter shapes match the reference's for any ``tp``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.device_cache import concrete_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.models.layers import ParamBuilder
from repro_torch.models.sharding import pinned, vocab_rows, vocab_split

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"bfloat16"`` /
    ``"float32"``)."""
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# parameter init (all families)
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
    if cfg.ssm == "rwkv6":
        L.add_norm_params(b, "layers/ln_att", d, cfg.norm, layer_axes)
        R6.add_rwkv6_params(b, "layers/tmix", cfg, layer_axes)
        L.add_norm_params(b, "layers/ln_ffn", d, cfg.norm, layer_axes)
        # channel-mix (token-shifted relu^2 FFN with receptance gate)
        la = (None,)
        b.add("layers/cmix/wk", layer_axes + (d, cfg.d_ff), la + ("embed", "mlp"), scale=1.0 / np.sqrt(d))
        b.add("layers/cmix/wv", layer_axes + (cfg.d_ff, d), la + ("mlp", "embed"), scale=1.0 / np.sqrt(cfg.d_ff))
        b.add("layers/cmix/wr", layer_axes + (d, d), la + ("embed", None), scale=1.0 / np.sqrt(d))
        b.add("layers/cmix/mu_k", layer_axes + (d,), la + ("embed",), init="zeros")
        b.add("layers/cmix/mu_r", layer_axes + (d,), la + ("embed",), init="zeros")
    elif cfg.ssm == "mamba2":
        L.add_norm_params(b, "layers/ln", d, cfg.norm, layer_axes)
        M2.add_mamba2_params(b, "layers/mixer", cfg, layer_axes)
        if cfg.shared_attn_every:
            # zamba2 shared attention + mlp block (params NOT stacked)
            L.add_norm_params(b, "shared/ln_att", d, cfg.norm)
            L.add_attention_params(b, "shared/attn", cfg_kv, (), kv_heads=kv_eff)
            L.add_norm_params(b, "shared/ln_mlp", d, cfg.norm)
            L.add_mlp_params(b, "shared/mlp", cfg)
    else:
        L.add_norm_params(b, "layers/ln_att", d, cfg.norm, layer_axes)
        L.add_attention_params(b, "layers/attn", cfg_kv, layer_axes, kv_heads=kv_eff)
        L.add_norm_params(b, "layers/ln_mlp", d, cfg.norm, layer_axes)
        if cfg.num_experts:
            MOE.add_moe_params(b, "layers/moe", cfg, layer_axes)
        else:
            L.add_mlp_params(b, "layers/mlp", cfg, layer_axes)
    L.add_norm_params(b, "final_norm", d, cfg.norm)
    return b.params, b.axes


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked ``layers`` tree (views), or entry
    ``i`` of a list of per-layer trees (the train step's split)."""
    if isinstance(tree, list):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


# ``_embed`` casts the table before the gather, as the reference does: the
# values are the same either way, but the gradient is not.  Cast first, the
# rows of a repeated token are summed into the table's gradient in the
# compute dtype and only then widened to f32, the reference's order (at bf16
# the other order, summing in f32, splits the ``embed`` gradient from the
# reference's).


# On a mesh that splits the vocabulary, both take the vocabulary-parallel
# lookup (``sharding.vocab_rows``): each device gathers the rows its block
# holds and the partial rows are summed, where indexing the split table
# would all-gather all of it to every device.  A table whole on every
# device (one rank) keeps the indexing below, bit for bit.


def _embed(params, cfg: ModelConfig, ids: torch.Tensor, dtype) -> torch.Tensor:
    if vocab_split(params["embed"]):
        x = vocab_rows(params["embed"].to(dtype), ids)
        if cfg.num_codebooks:
            x = x + params["pos_embed"][:ids.shape[1]][None, :, :].to(dtype)
        return x
    if cfg.num_codebooks:
        # ids: (B, S, CB)
        tables = params["embed"].to(dtype)  # (CB, V, D)
        x = tables[0][ids[..., 0]]
        for cb in range(1, cfg.num_codebooks):
            x = x + tables[cb][ids[..., cb]]
        S = ids.shape[1]
        return x + params["pos_embed"][:S][None, :, :].to(dtype)
    return params["embed"].to(dtype)[ids]


def _embed_decode(params, cfg: ModelConfig, ids: torch.Tensor, pos: int, dtype) -> torch.Tensor:
    # no gradient here: the rows are gathered first and only they are cast
    if vocab_split(params["embed"]):
        x = vocab_rows(params["embed"], ids, dtype)
        if cfg.num_codebooks:
            x = x + params["pos_embed"][pos:pos + 1].to(dtype)[None, :, :]
        return x
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
# the model: what every family shares
# ---------------------------------------------------------------------------


class Model:
    """A decoder on one device; the methods mirror the reference's ``Model``
    fields, each family (a subclass) giving ``forward``, ``init_cache``,
    ``cache_axes``, ``prefill`` and ``decode``."""

    def __init__(self, cfg: ModelConfig, kv_eff: int, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.kv_eff = kv_eff  # kv heads after TP padding
        self.device = device
        self.generator = generator
        self.dtype = _compute_dtype(cfg)
        self._cfg_kv = dataclasses.replace(cfg, num_kv_heads=kv_eff)
        self.axes = _init_params(cfg, kv_eff, None, abstract=True)[1]

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

    def _zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    def _finish(self, params, x, last: bool):
        """Final norm and head, of the last position only with ``last``."""
        x = L.apply_norm(self.cfg.norm, params["final_norm"], pinned(x))
        return _head(params, self.cfg, x[:, -1:, :] if last else x)


# ---------------------------------------------------------------------------
# family: dense / moe transformer
# ---------------------------------------------------------------------------


class Transformer(Model):

    def _ffn(self, lp, h, dense_moe: bool = False):
        """The block's MLP, or its MoE: GShard dispatch (with capacity
        drops) unless ``dense_moe``; returns (out, aux)."""
        cfg = self.cfg
        if not cfg.num_experts:
            return L.mlp_block(lp["mlp"], h, cfg.mlp), 0.0
        if dense_moe:
            # decode is weight-read-bound: dense dispatch is exact (no
            # capacity drops) and its extra FLOPs are negligible at S=1.
            return MOE.moe_block_dense_ref(lp["moe"], h, num_experts=cfg.num_experts,
                                           top_k=cfg.top_k), 0.0
        return MOE.moe_block(lp["moe"], h, num_experts=cfg.num_experts, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)

    def _block(self, lp, x, q_offset: int = 0):
        # on a mesh, the residual stream is pinned at each sublayer's edges
        # (split over the batch only, both ways: ``sharding.pinned``)
        cfg = self.cfg
        h = L.apply_norm(cfg.norm, lp["ln_att"], pinned(x))
        att, kv = _attn_full(lp["attn"], self._cfg_kv, h, q_offset)
        x = x + pinned(att)
        h = L.apply_norm(cfg.norm, lp["ln_mlp"], pinned(x))
        out, aux = self._ffn(lp, h)
        return x + pinned(out), kv, aux

    def forward(self, params, ids):
        cfg = self.cfg
        x = _embed(params, cfg, ids, self.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.num_layers):
            x, _, a = self._block(_layer(params["layers"], i), x)
            aux = aux + a
        return self._finish(params, x, last=False), aux / cfg.num_layers

    def init_cache(self, batch: int, max_len: int):
        cfg = self.cfg
        W = min(max_len, cfg.window) if cfg.attention == "swa" and cfg.window else max_len
        shape = (cfg.num_layers, batch, W, self.kv_eff, cfg.head_dim)
        cache_dt = getattr(torch, cfg.cache_dtype) if cfg.cache_dtype else self.dtype
        return {
            "k": self._zeros(shape, cache_dt),
            "v": self._zeros(shape, cache_dt),
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
            x, (k, v), _ = self._block(_layer(params["layers"], i), x)
            # keep the last W positions of k/v for the cache
            ks.append(k[:, -W:].to(self.dtype))
            vs.append(v[:, -W:].to(self.dtype))
        logits = self._finish(params, x, last=True)
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
            x = x + pinned(_attn_decode(lp["attn"], self._cfg_kv, h, cache["k"][i], cache["v"][i],
                                        positions, pos))
            h = L.apply_norm(cfg.norm, lp["ln_mlp"], x)
            x = x + pinned(self._ffn(lp, h, dense_moe=True)[0])
        return self._finish(params, x, last=False), cache


# ---------------------------------------------------------------------------
# family: rwkv6
# ---------------------------------------------------------------------------


class Rwkv(Model):

    def _cmix(self, lp, x, x_prev):
        xs = R6._token_shift(x, x_prev)
        xk = R6._mix(x, xs, lp["mu_k"])
        xr = R6._mix(x, xs, lp["mu_r"])
        k = torch.square(F.relu(xk @ lp["wk"].to(x.dtype)))
        r = L.sigmoid(xr @ lp["wr"].to(x.dtype))
        return r * (k @ lp["wv"].to(x.dtype)), x[:, -1, :]

    def _block(self, lp, x, x_att, x_ffn, wkv, chunked: bool):
        """One layer from its carries; returns (x, (x_att, x_ffn, wkv))."""
        cfg = self.cfg
        h = L.apply_norm(cfg.norm, lp["ln_att"], x)
        mix = R6.rwkv6_chunked if chunked else R6.rwkv6_decode
        att, x_att, wkv = mix(lp["tmix"], h, x_att, wkv)
        x = x + att
        h = L.apply_norm(cfg.norm, lp["ln_ffn"], x)
        ff, x_ffn = self._cmix(lp["cmix"], h, x_ffn)
        return x + ff, (x_att, x_ffn, wkv)

    def init_cache(self, batch: int, max_len: int):
        cfg = self.cfg
        H, N = cfg.ssm_heads_eff, cfg.head_dim
        return {
            "x_att": self._zeros((cfg.num_layers, batch, cfg.d_model)),
            "x_ffn": self._zeros((cfg.num_layers, batch, cfg.d_model)),
            "wkv": self._zeros((cfg.num_layers, batch, H, N, N), torch.float32),
        }

    def cache_axes(self, batch: int, max_len: int):
        return {
            "x_att": ("layers", "cache_batch", "embed"),
            "x_ffn": ("layers", "cache_batch", "embed"),
            "wkv": ("layers", "cache_batch", "ssm_heads", None, None),
        }

    def _run(self, params, x, cache, chunked: bool):
        """Every layer from the cache's carries; returns (x, the new
        carries stacked by layer)."""
        outs = []
        for i in range(self.cfg.num_layers):
            x, carry = self._block(_layer(params["layers"], i), x, cache["x_att"][i],
                                   cache["x_ffn"][i], cache["wkv"][i], chunked)
            outs.append(carry)
        return x, [torch.stack(c) for c in zip(*outs)]

    def forward(self, params, ids):
        x = _embed(params, self.cfg, ids, self.dtype)
        x, _ = self._run(params, x, self.init_cache(ids.shape[0], 0), chunked=True)
        return self._finish(params, x, last=False), torch.zeros((), dtype=torch.float32,
                                                                 device=x.device)

    def prefill(self, params, ids, cache):
        x = _embed(params, self.cfg, ids, self.dtype)
        x, (ca, cf, st) = self._run(params, x, cache, chunked=True)
        return self._finish(params, x, last=True), {"x_att": ca, "x_ffn": cf, "wkv": st}

    def decode(self, params, ids, cache, pos):
        """One token; updates ``cache`` in place and returns (logits,
        cache)."""
        x = _embed_decode(params, self.cfg, ids, int(pos), self.dtype)
        x, new = self._run(params, x, cache, chunked=False)
        for name, t in zip(("x_att", "x_ffn", "wkv"), new):
            cache[name].copy_(t)
        return self._finish(params, x, last=False), cache


# ---------------------------------------------------------------------------
# family: mamba2 (+ zamba2 hybrid shared attention)
# ---------------------------------------------------------------------------


class Mamba(Model):

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        cfg = self.cfg
        every = self.every = cfg.shared_attn_every
        self.n_shared = (cfg.num_layers // every) if every else 0
        # the shared attention block runs after every full group of
        # ``every`` mamba layers: {last layer of the group: its KV slot}
        self.shared_after = {(g + 1) * every - 1: g for g in range(self.n_shared)}

    def _shared(self, params, x, attend):
        """The shared attention + MLP block; ``attend(p, h)`` gives the
        attention output."""
        cfg = self.cfg
        sp = params["shared"]
        h = L.apply_norm(cfg.norm, sp["ln_att"], x)
        x = x + attend(sp["attn"], h)
        h = L.apply_norm(cfg.norm, sp["ln_mlp"], x)
        return x + L.mlp_block(sp["mlp"], h, cfg.mlp)

    def init_cache(self, batch: int, max_len: int):
        cfg = self.cfg
        inner = cfg.ssm_expand * cfg.d_model
        H, N, K = cfg.ssm_heads_eff, cfg.ssm_state, M2.CONV_K
        nl = cfg.num_layers
        cache = {
            "conv_x": self._zeros((nl, batch, K - 1, inner)),
            "conv_B": self._zeros((nl, batch, K - 1, N)),
            "conv_C": self._zeros((nl, batch, K - 1, N)),
            "ssm": self._zeros((nl, batch, H, N, inner // H), torch.float32),
        }
        if self.every:
            cache["shared_k"] = self._zeros((self.n_shared, batch, max_len, self.kv_eff, cfg.head_dim))
            cache["shared_v"] = torch.zeros_like(cache["shared_k"])
            cache["positions"] = torch.full((max_len,), -1, dtype=torch.int32, device=self.device)
        return cache

    def cache_axes(self, batch: int, max_len: int):
        ax = {
            "conv_x": ("layers", "cache_batch", "conv", "mlp"),
            "conv_B": ("layers", "cache_batch", "conv", "ssm_state"),
            "conv_C": ("layers", "cache_batch", "conv", "ssm_state"),
            "ssm": ("layers", "cache_batch", "ssm_heads", "ssm_state", None),
        }
        if self.every:
            ax["shared_k"] = (None, "cache_batch", "cache_seq", "cache_heads", "head_dim")
            ax["shared_v"] = (None, "cache_batch", "cache_seq", "cache_heads", "head_dim")
            ax["positions"] = ("cache_seq",)
        return ax

    def _run(self, params, x, cache, chunked: bool, shared):
        """Every mamba layer from the cache's states, ``shared(x, slot)``
        after each full group; returns (x, the new states stacked by
        layer)."""
        cfg = self.cfg
        mix = M2.mamba2_chunked if chunked else M2.mamba2_decode
        outs = []
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            h = L.apply_norm(cfg.norm, lp["ln"], x)
            conv = (cache["conv_x"][i], cache["conv_B"][i], cache["conv_C"][i])
            out, conv, st = mix(lp["mixer"], h, conv, cache["ssm"][i])
            x = x + out
            outs.append(conv + (st,))
            if i in self.shared_after:
                x = shared(x, self.shared_after[i])
        return x, [torch.stack(c) for c in zip(*outs)]

    def forward(self, params, ids):
        x = _embed(params, self.cfg, ids, self.dtype)

        def shared(x, _slot):
            return self._shared(params, x, lambda p, h: _attn_full(p, self._cfg_kv, h, 0)[0])

        x, _ = self._run(params, x, self.init_cache(ids.shape[0], 0), True, shared)
        return self._finish(params, x, last=False), torch.zeros((), dtype=torch.float32,
                                                                 device=x.device)

    def prefill(self, params, ids, cache):
        """The prompt from the cache's states.  Each shared invocation keeps
        the last ``max_len`` positions' keys and values at slots 0.. of its
        own KV slot, and ``positions`` marks the first ``min(S, max_len)``
        slots as positions 0.. (the reference's layout, also when S >
        max_len)."""
        x = _embed(params, self.cfg, ids, self.dtype)
        new = {}
        if self.every:
            sk, sv = cache["shared_k"].clone(), cache["shared_v"].clone()
            W = sk.shape[2]

            def shared(x, slot):
                def attend(p, h):
                    att, (k, v) = _attn_full(p, self._cfg_kv, h, 0)
                    kept = k[:, -W:].shape[1]
                    sk[slot].zero_()
                    sv[slot].zero_()
                    sk[slot, :, :kept] = k[:, -W:].to(sk.dtype)
                    sv[slot, :, :kept] = v[:, -W:].to(sv.dtype)
                    return att
                return self._shared(params, x, attend)

            slots = torch.arange(W, device=x.device)
            new = {"shared_k": sk, "shared_v": sv,
                   "positions": torch.where(slots < min(ids.shape[1], W), slots, -1).to(torch.int32)}
        else:
            shared = None
        x, (cx, cb, cc, st) = self._run(params, x, cache, True, shared)
        return (self._finish(params, x, last=True),
                {"conv_x": cx, "conv_B": cb, "conv_C": cc, "ssm": st, **new})

    def decode(self, params, ids, cache, pos):
        """One token at ``pos``; updates ``cache`` in place (the shared
        block's keys and values at slot ``pos % max_len`` of each
        invocation's KV slot) and returns (logits, cache)."""
        pos = int(pos)
        x = _embed_decode(params, self.cfg, ids, pos, self.dtype)
        if self.every:
            positions = cache["positions"]
            positions[pos % cache["shared_k"].shape[2]] = pos

        def shared(x, slot):
            return self._shared(params, x, lambda p, h: _attn_decode(
                p, self._cfg_kv, h, cache["shared_k"][slot], cache["shared_v"][slot], positions, pos))

        x, new = self._run(params, x, cache, False, shared)
        for name, t in zip(("conv_x", "conv_B", "conv_C", "ssm"), new):
            cache[name].copy_(t)
        return self._finish(params, x, last=False), cache


# ---------------------------------------------------------------------------
# public factory
# ---------------------------------------------------------------------------


def build_model(cfg: ModelConfig, *, tp: int = 1, device="cuda",
                generator: Optional[torch.Generator] = None) -> Model:
    """The model of ``cfg`` on ``device`` (CUDA by default; raises without a
    card).  ``generator`` is ``init``'s default source of draws."""
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
    family = {"rwkv6": Rwkv, "mamba2": Mamba}.get(cfg.ssm, Transformer)
    return family(cfg, kv_eff, concrete_device(device), generator)


def param_shapes(model: Model):
    """Shape-only (``meta``) tree of the params (no allocation)."""
    return _init_params(model.cfg, model.kv_eff, None, abstract=True)[0]


def cache_shapes(model: Model, batch: int, max_len: int):
    """Shape-only (``meta``) tree of ``model.init_cache(batch, max_len)``."""
    meta = copy.copy(model)
    meta.device = torch.device("meta")
    return meta.init_cache(batch, max_len)


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
