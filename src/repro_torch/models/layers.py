"""Shared layer library: norms, RoPE, attention (flash + decode), MLPs.

Port of ``repro/models/layers.py``.  Functions are pure: a params tree
(nested dicts of tensors) in, tensors out.  :class:`ParamBuilder` records a
parallel tree of logical-axis tuples beside the params, as the reference's
does, for the sharding rules of ``models/sharding.py``.  On a mesh (q a
DTensor) attention runs on each device's own (batch, head) block
(``sharding.on_blocks``).

The math is the reference's, operation for operation: each weight is cast
to the activation dtype where it is used, norms compute in f32, RoPE
rotates interleaved pairs, and attention scores and the probability-weighted
values accumulate in f32 (the reference's ``preferred_element_type=f32``:
the operands are upcast, so a bf16 product is exact and the sum runs in
f32).  Attention is plain torch, blockwise online softmax over KV chunks
(no library attention call): the models hold no Pallas kernel, so this
layer owes no hand-written one.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.sharding import is_dtensor, on_blocks

# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------


class ParamBuilder:
    """Collects params + logical axes as parallel nested dicts.

    Normal draws come from ``generator`` on ``device`` (f32, then cast to
    ``dtype``, as the reference draws f32 and casts).  ``abstract=True``
    records shape-only ``meta`` tensors instead of allocating, to derive the
    shape tree without paying for a full init."""

    def __init__(
        self,
        generator: Optional[torch.Generator],
        dtype: torch.dtype = torch.float32,
        device="cpu",
        abstract: bool = False,
    ):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device("meta") if abstract else torch.device(device)
        self.abstract = abstract
        self.params: Dict[str, Any] = {}
        self.axes: Dict[str, Any] = {}

    def add(self, path: str, shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
            init: str = "normal", scale: Optional[float] = None) -> None:
        assert len(shape) == len(axes), (path, shape, axes)
        if self.abstract:
            arr = torch.empty(shape, dtype=self.dtype, device=self.device)
        elif init == "zeros":
            arr = torch.zeros(shape, dtype=self.dtype, device=self.device)
        elif init == "ones":
            arr = torch.ones(shape, dtype=self.dtype, device=self.device)
        elif init == "normal":
            if scale is None:
                # fan-in init, skipping leading stacked-layer dims (their
                # axes entries are None) and the output dim
                prefix = 0
                for a in axes:
                    if a is None:
                        prefix += 1
                    else:
                        break
                fan_in = max(1, int(np.prod(shape[prefix:-1])))
                scale = 1.0 / np.sqrt(fan_in)
            arr = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                              device=self.device)
            arr = arr.mul_(float(scale)).to(self.dtype)
        else:
            raise ValueError(init)
        self._set(self.params, path, arr)
        self._set(self.axes, path, tuple(axes))

    @staticmethod
    def _set(tree: dict, path: str, value) -> None:
        parts = path.split("/")
        for p in parts[:-1]:
            tree = tree.setdefault(p, {})
        tree[parts[-1]] = value


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def param_count(params) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(norm_kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    if norm_kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def add_norm_params(b: ParamBuilder, path: str, d: int, norm_kind: str, layer_axes=()) -> None:
    b.add(f"{path}/scale", layer_axes + (d,), tuple([None] * len(layer_axes)) + ("embed",), init="ones")
    if norm_kind == "layernorm":
        b.add(f"{path}/bias", layer_axes + (d,), tuple([None] * len(layer_axes)) + ("embed",), init="zeros")


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, frac: float, theta: float, device="cpu") -> torch.Tensor:
    rot = int(head_dim * frac) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    # a Python scalar base: no host-to-device copy (which would sync)
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, frac: float, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Rotates
    interleaved pairs (``x[..., 0::2]``, ``x[..., 1::2]``) of the first
    ``int(hd * frac) // 2 * 2`` features; the rest pass through."""
    hd = x.shape[-1]
    rot = int(hd * frac) // 2 * 2
    if rot == 0:
        return x
    freqs = rope_freqs(hd, frac, theta, x.device)  # (rot/2,)
    angles = positions[..., :, None].float() * freqs  # (..., S, rot/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, rot/2)
    sin = torch.sin(angles)[..., :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    # x (bf16) times f32 cos promotes to f32, as jnp does
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape)
    return torch.cat([y.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def add_attention_params(b: ParamBuilder, path: str, cfg, layer_axes=(), kv_heads=None) -> None:
    d = cfg.d_model
    H, hd = cfg.num_heads, cfg.head_dim
    KV = kv_heads if kv_heads is not None else cfg.num_kv_heads
    la = tuple([None] * len(layer_axes))
    s_in = 1.0 / np.sqrt(d)
    b.add(f"{path}/wq", layer_axes + (d, H, hd), la + ("embed", "heads", "head_dim"), scale=s_in)
    b.add(f"{path}/wk", layer_axes + (d, KV, hd), la + ("embed", "kv_heads", "head_dim"), scale=s_in)
    b.add(f"{path}/wv", layer_axes + (d, KV, hd), la + ("embed", "kv_heads", "head_dim"), scale=s_in)
    b.add(f"{path}/wo", layer_axes + (H, hd, d), la + ("heads", "head_dim", "embed"), scale=1.0 / np.sqrt(H * hd))
    if cfg.qkv_bias:
        b.add(f"{path}/bq", layer_axes + (H, hd), la + ("heads", "head_dim"), init="zeros")
        b.add(f"{path}/bk", layer_axes + (KV, hd), la + ("kv_heads", "head_dim"), init="zeros")
        b.add(f"{path}/bv", layer_axes + (KV, hd), la + ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        b.add(f"{path}/q_norm", layer_axes + (hd,), la + ("head_dim",), init="ones")
        b.add(f"{path}/k_norm", layer_axes + (hd,), la + ("head_dim",), init="ones")


def _project_qkv(p: dict, cfg, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    return q, k, v


def _online_softmax_step(m, l, acc, s, mask, v_blk):
    """One KV block of the online softmax (the reference's ``kv_step``
    body): ``s`` (..., qc, kc) f32 scores, ``mask`` (qc, kc), ``v_blk``
    (B, kc, KV, hd); the state ``m``, ``l`` (B, KV, G, qc), ``acc`` (B, KV,
    G, qc, hd), all f32."""
    s = torch.where(mask, s, -math.inf)
    new_m = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows
    new_m_safe = torch.where(torch.isfinite(new_m), new_m, 0.0)
    p = torch.exp(s - new_m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    corr = torch.exp(torch.where(torch.isfinite(m), m - new_m_safe, -math.inf))
    corr = torch.where(torch.isfinite(corr), corr, 0.0)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_blk.dtype).float(), v_blk.float())
    acc = acc * corr[..., None] + pv
    return new_m, l, acc


def _block_mask(q_pos, kv_pos, causal: bool, window: int) -> torch.Tensor:
    mask = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= kv_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    return mask


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    *,
    q_offset: int = 0,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Blockwise online-softmax attention with GQA-grouped einsums: every
    (q chunk, kv chunk) pair is computed and masked afterwards, as the
    reference's dense schedule does.  Memory per step is O(q_chunk ×
    kv_chunk)."""
    if is_dtensor(q):
        return on_blocks(partial(flash_attention, q_offset=q_offset, causal=causal, window=window,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk), q, k, v)
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    assert Sq % q_chunk == 0 and Skv % kv_chunk == 0
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd)
    dev = q.device
    outs = []
    for qi in range(nq):
        q_blk = qg[:, qi * q_chunk:(qi + 1) * q_chunk].float()
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KV, G, q_chunk), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            k_blk = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            v_blk = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
            kv_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk.float()) * scale
            mask = _block_mask(q_pos, kv_pos, causal, window)
            m, l, acc = _online_softmax_step(m, l, acc, s, mask, v_blk)
        out = acc / torch.clamp(l, min=1e-20)[..., None]
        # (B, KV, G, qc, hd) -> (B, qc, KV, G, hd)
        outs.append(out.permute(0, 3, 1, 2, 4))
    out = torch.cat(outs, dim=1)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def visible_pairs(nq: int, nk: int, q_chunk: int, kv_chunk: int, q_offset: int, causal: bool,
                  window: int):
    """The block-sparse schedule: every (q block, kv block) pair that is
    neither entirely in the future nor entirely outside the window."""
    pairs = []
    for qi in range(nq):
        q_lo = q_offset + qi * q_chunk
        q_hi = q_lo + q_chunk - 1
        for ki in range(nk):
            kv_lo = ki * kv_chunk
            kv_hi = kv_lo + kv_chunk - 1
            if causal and kv_lo > q_hi:
                continue  # entirely in the future
            if window and kv_hi <= q_lo - window:
                continue  # entirely outside the window
            pairs.append((qi, ki))
    return pairs


def flash_attention_sparse(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Skv, KV, hd)
    v: torch.Tensor,  # (B, Skv, KV, hd)
    *,
    q_offset: int = 0,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 512,
    kv_chunk: int = 512,
) -> torch.Tensor:
    """Block-sparse flash attention: only *visible* (q-block, kv-block)
    pairs are computed, from the reference's static schedule (a pair
    entirely in the future or entirely outside the window is skipped), each
    q block with its own online-softmax state."""
    if is_dtensor(q):
        return on_blocks(partial(flash_attention_sparse, q_offset=q_offset, causal=causal,
                                 window=window, q_chunk=q_chunk, kv_chunk=kv_chunk), q, k, v)
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    assert Sq % q_chunk == 0 and Skv % kv_chunk == 0
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd)
    dev = q.device

    pairs = visible_pairs(nq, nk, q_chunk, kv_chunk, q_offset, causal, window)

    # each q block's state in a list of its own (as the dense schedule keeps
    # it in locals): rebinding an entry, never writing into a tensor that
    # autograd saved for the backward
    m = [torch.full((B, KV, G, q_chunk), -math.inf, dtype=torch.float32, device=dev)
         for _ in range(nq)]
    l = [torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev) for _ in range(nq)]
    acc = [torch.zeros((B, KV, G, q_chunk, hd), dtype=torch.float32, device=dev)
           for _ in range(nq)]
    for qi, ki in pairs:
        q_blk = qg[:, qi * q_chunk:(qi + 1) * q_chunk].float()
        k_blk = k[:, ki * kv_chunk:(ki + 1) * kv_chunk]
        v_blk = v[:, ki * kv_chunk:(ki + 1) * kv_chunk]
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        kv_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
        s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk.float()) * scale
        mask = _block_mask(q_pos, kv_pos, causal, window)
        m[qi], l[qi], acc[qi] = _online_softmax_step(m[qi], l[qi], acc[qi], s, mask, v_blk)
    out = torch.stack(acc) / torch.clamp(torch.stack(l), min=1e-20)[..., None]  # (nq, B, KV, G, qc, hd)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, KV, G, hd)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd)
    k_cache: torch.Tensor,  # (B, W, KV, hd)  (positions already roped)
    v_cache: torch.Tensor,  # (B, W, KV, hd)
    cache_positions: torch.Tensor,  # (W,) int32 absolute positions, -1 = empty
    pos: int,  # current position
    window: int = 0,
) -> torch.Tensor:
    if is_dtensor(q):
        return on_blocks(lambda a, b, c, d: decode_attention(a, b, c, d, pos, window),
                         q, k_cache, v_cache, cache_positions)
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(B, KV, G, hd)
    # low-precision cache storage (e.g. f8) is upcast after the HBM read
    k_cache = k_cache.to(q.dtype)
    v_cache = v_cache.to(q.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    valid = (cache_positions >= 0) & (cache_positions <= pos)
    if window:
        valid &= cache_positions > pos - window
    s = torch.where(valid[None, None, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# activations, step by step as the reference's compile to
# ---------------------------------------------------------------------------
#
# XLA expands ``jax.nn.sigmoid`` and the tanh ``jax.nn.gelu`` into their
# elementary operations and rounds each one to the input's dtype; torch's
# fused activations round once.  At bf16 the two differ in about a third of
# the elements, so the port writes them out as the reference computes them.


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x)), each step in x's dtype."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · sigmoid(x), each step in x's dtype."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``, each step in x's dtype, its
    constants rounded to that dtype first."""
    c = torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype)
    a = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def add_mlp_params(b: ParamBuilder, path: str, cfg, layer_axes=()) -> None:
    d, ff = cfg.d_model, cfg.d_ff
    la = tuple([None] * len(layer_axes))
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(ff)
    if cfg.mlp == "swiglu":
        b.add(f"{path}/wi_gate", layer_axes + (d, ff), la + ("embed", "mlp"), scale=s_in)
        b.add(f"{path}/wi_up", layer_axes + (d, ff), la + ("embed", "mlp"), scale=s_in)
        b.add(f"{path}/wo", layer_axes + (ff, d), la + ("mlp", "embed"), scale=s_out)
    else:  # squared_relu | gelu
        b.add(f"{path}/wi", layer_axes + (d, ff), la + ("embed", "mlp"), scale=s_in)
        b.add(f"{path}/wo", layer_axes + (ff, d), la + ("mlp", "embed"), scale=s_out)


def mlp_block(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        g = x @ p["wi_gate"].to(x.dtype)
        u = x @ p["wi_up"].to(x.dtype)
        h = silu(g) * u
    elif kind == "squared_relu":
        h = torch.square(F.relu(x @ p["wi"].to(x.dtype)))
    elif kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = gelu_tanh(x @ p["wi"].to(x.dtype))
    else:
        raise ValueError(kind)
    return h @ p["wo"].to(x.dtype)
