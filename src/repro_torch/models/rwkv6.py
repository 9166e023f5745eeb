"""RWKV-6 (Finch) time-mix — chunked parallel scan with data-dependent decay.

Port of ``repro/models/rwkv6.py``.  Per head (size N): state
``S ∈ R^{N×N}`` (key-dim × value-dim), inputs r_t, k_t, v_t ∈ R^N,
data-dependent decay w_t ∈ (0,1)^N, bonus u ∈ R^N:

    o_t = r_tᵀ (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

Chunked form (chunk C): with A_i = Π_{t≤i} w_t (within-chunk cumulative
decay, f32),

    inter:  o_i += (r_i ⊙ A_{i-1})ᵀ S_prev
    intra:  o_i += Σ_{j<i} ((r_i ⊙ A_{i-1}/A_j)·k_j) v_j + ((r_i⊙u)·k_i) v_i
    carry:  S_new = diag(A_last) S_prev + Σ_j (A_last/A_j ⊙ k_j) v_jᵀ

Decay products are computed in log space, the state is kept in f32, and the
chunk is the largest divisor of S that is ≤ 32 (a prime S gives chunk 1).
The log-decay is ``-softplus(w_raw) - 1e-4`` with the exact softplus
``logaddexp(x, 0)`` (``torch.nn.functional.softplus`` switches to x above
its threshold, where ``jax.nn.softplus`` does not).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import ParamBuilder
from repro_torch.models.sharding import split_only, splittable


def add_rwkv6_params(b: ParamBuilder, path: str, cfg, layer_axes=()) -> None:
    d = cfg.d_model
    H, N = cfg.ssm_heads_eff, cfg.head_dim
    la = tuple([None] * len(layer_axes))
    lora = 64
    s_in = 1.0 / np.sqrt(d)
    for name in ("wr", "wk", "wv", "wg"):
        b.add(f"{path}/{name}", layer_axes + (d, H, N), la + ("embed", "ssm_heads", "head_dim"), scale=s_in)
    b.add(f"{path}/wo", layer_axes + (H, N, d), la + ("ssm_heads", "head_dim", "embed"), scale=1.0 / np.sqrt(H * N))
    # data-dependent decay projection (two-layer)
    b.add(f"{path}/w_lora_a", layer_axes + (d, lora), la + ("embed", None), scale=s_in)
    b.add(f"{path}/w_lora_b", layer_axes + (lora, H, N), la + (None, "ssm_heads", "head_dim"), scale=0.05)
    b.add(f"{path}/w_base", layer_axes + (H, N), la + ("ssm_heads", "head_dim"), init="zeros")
    b.add(f"{path}/u_bonus", layer_axes + (H, N), la + ("ssm_heads", "head_dim"), scale=0.5)
    # static token-shift mix coefficients per projection
    for name in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
        b.add(f"{path}/{name}", layer_axes + (d,), la + ("embed",), init="zeros")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) at every x, no linear cut-over."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """shift(x)_t = x_{t-1}; x_prev supplies position -1 (decode carry)."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _mix(x, x_shift, mu):
    m = L.sigmoid(mu.float()).to(x.dtype)
    return x + m * (x_shift - x)


def _heads(x, w):
    """(B,S,D) @ (D,H,N) -> (B,S,H,N) in x's dtype."""
    D, H, N = w.shape
    y = splittable(x @ w.to(x.dtype).reshape(D, H * N), -1, H)
    return y.reshape(x.shape[:-1] + (H, N))


def _project(p, x, xs):
    """Compute r,k,v,g,(log w) from mixed inputs.  Shapes: (B,S,H,N)."""
    r = _heads(_mix(x, xs, p["mu_r"]), p["wr"])
    k = _heads(_mix(x, xs, p["mu_k"]), p["wk"])
    v = _heads(_mix(x, xs, p["mu_v"]), p["wv"])
    g = _heads(_mix(x, xs, p["mu_g"]), p["wg"])
    wx = _mix(x, xs, p["mu_w"])
    h = torch.tanh(wx @ p["w_lora_a"].to(x.dtype))
    w_raw = p["w_base"].float() + _heads(h, p["w_lora_b"]).float()
    # log-decay in (-inf, 0):  log w = -softplus(w_raw) - eps
    log_w = -softplus(w_raw) - 1e-4
    return r, k, v, g, log_w


def _out(p, o, g, x):
    """Gate the (B,S,H,N) wkv output and project it back to (B,S,D)."""
    o = o.to(x.dtype) * L.silu(g)
    H, N, D = p["wo"].shape
    o = splittable(o, 2, H)  # an uneven split of the heads cannot merge into H·N
    return o.reshape(o.shape[:2] + (H * N,)) @ p["wo"].to(x.dtype).reshape(H * N, D)


def chunk_size(S: int, chunk: int) -> int:
    """The largest divisor of S that is ≤ ``chunk``."""
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    return chunk


def rwkv6_chunked(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    x_prev: torch.Tensor,  # (B, D) token-shift carry
    state: torch.Tensor,  # (B, H, N, N) wkv state carry
    *,
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training/prefill form.  Returns (out (B,S,D), x_last (B,D), state)."""
    B, S, D = x.shape
    chunk = chunk_size(S, chunk)
    xs = _token_shift(x, x_prev)
    r, k, v, g, log_w = _project(p, x, xs)
    H, N = r.shape[2], r.shape[3]
    u = p["u_bonus"].float()
    nC = S // chunk
    # on a mesh the scan keeps the batch split and the rest whole: its
    # per-chunk contractions merge the head dim with others
    r, k, v, log_w, state = (split_only(t, (0,)) for t in (r, k, v, log_w, state))

    def to_chunks(a):  # (B,S,H,N) -> (nC, B, H, C, N)
        return a.reshape(B, nC, chunk, H, N).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, log_w))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device), diagonal=-1)
    S_prev = state.float()
    outs = []
    for c in range(nC):
        rb, kb, vb, lwb = rc[c].float(), kc[c].float(), vc[c].float(), lwc[c]  # (B,H,C,N)
        A = torch.cumsum(lwb, dim=2)  # log cumulative decay incl. self
        A_prev = A - lwb  # exclusive (A_{i-1})
        r_t = rb * torch.exp(A_prev)  # r_i ⊙ A_{i-1}  (exponent ≤ 0: safe)
        o_inter = r_t @ S_prev  # (B,H,C,N) @ (B,H,N,N)
        # intra-chunk scores via pairwise decay differences, the exponent
        # masked to -inf above the diagonal before exp
        expo = A_prev[:, :, :, None, :] - A[:, :, None, :, :]  # (B,H,i,j,N)
        expo = torch.where(tri[None, None, :, :, None], expo, -torch.inf)
        gate = torch.exp(expo)
        # the reference's contractions, as matmuls: r_i ⊗ k_j over each n
        # (inner dim 1, exact), then its dot with the gate over n
        outer = rb.transpose(2, 3)[..., :, None] @ kb.transpose(2, 3)[..., None, :]  # (B,H,N,i,j)
        s = (outer.permute(0, 1, 3, 4, 2)[..., None, :] @ gate[..., :, None])[..., 0, 0]  # (B,H,C,C)
        o_intra = s @ vb
        # diagonal bonus term
        diag = ((rb * u[None, :, None, :])[..., None, :] @ kb[..., :, None])[..., 0, 0]  # (B,H,C)
        o_diag = diag[..., None] * vb
        # state carry
        A_last = A[:, :, -1:, :]  # (B,H,1,N)
        decay_chunk = torch.exp(A_last[:, :, 0, :])  # (B,H,N)
        k_carry = kb * torch.exp(A_last - A)  # k_j ⊙ A_last/A_j
        S_prev = decay_chunk[..., None] * S_prev + k_carry.transpose(2, 3) @ vb
        outs.append(o_inter + o_intra + o_diag)
    # (nC, B, H, C, N) -> (B, S, H, N)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, S, H, N)
    return _out(p, o, g, x), x[:, -1, :], S_prev


def rwkv6_decode(
    p: dict,
    x: torch.Tensor,  # (B, 1, D)
    x_prev: torch.Tensor,  # (B, D)
    state: torch.Tensor,  # (B, H, N, N)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token step: O(H·N²)."""
    xs = x_prev[:, None, :].to(x.dtype)
    r, k, v, g, log_w = _project(p, x, xs)
    u = p["u_bonus"].float()
    r32 = r[:, 0].float()  # (B,H,N)
    k32 = k[:, 0].float()
    v32 = v[:, 0].float()
    w = torch.exp(log_w[:, 0])  # (B,H,N)
    kv = k32[..., :, None] * v32[..., None, :]  # (B,H,N,N)
    state = state.float()
    o = (r32[..., None, :] @ (state + u[None, :, :, None] * kv))[..., 0, :]  # (B,H,N)
    state = w[..., None] * state + kv
    return _out(p, o[:, None], g, x), x[:, -1, :], state


def rwkv6_ref(p: dict, x: torch.Tensor, x_prev: torch.Tensor, state: torch.Tensor):
    """Step-by-step oracle (one ``rwkv6_decode`` a token)."""
    xp, st = x_prev, state.float()
    outs = []
    for t in range(x.shape[1]):
        out, xp, st = rwkv6_decode(p, x[:, t:t + 1], xp, st)
        outs.append(out[:, 0])
    return torch.stack(outs, dim=1), xp, st
