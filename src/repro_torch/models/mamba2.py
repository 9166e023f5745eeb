"""Mamba-2 (SSD) block — chunked state-space scan (zamba2 backbone).

Port of ``repro/models/mamba2.py``.  Per head (head dim P, state dim N):

    h_t = exp(Δ_t A) h_{t-1} + Δ_t · (B_t ⊗ x_t)        h ∈ R^{N×P}
    y_t = C_tᵀ h_t + D ⊙ x_t

with scalar A = -exp(A_log) < 0 per head, Δ_t = softplus(dt), and a
depthwise causal conv (kernel 4) on each of the streams x, B and C before
the scan, each carrying its last K-1 = 3 rows.

Chunked computation (chunk: the largest divisor of S that is ≤ 128):
cumulative log-decays within a chunk give a lower-triangular intra-chunk
term plus an inter-chunk carried state.  All decay math in f32 log space;
the SSM state is f32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import ParamBuilder
from repro_torch.models.rwkv6 import chunk_size, softplus

CONV_K = 4


def add_mamba2_params(b: ParamBuilder, path: str, cfg, layer_axes=()) -> None:
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    H = cfg.ssm_heads_eff  # inner // P
    N = cfg.ssm_state
    la = tuple([None] * len(layer_axes))
    s_in = 1.0 / np.sqrt(d)
    b.add(f"{path}/w_x", layer_axes + (d, inner), la + ("embed", "mlp"), scale=s_in)
    b.add(f"{path}/w_z", layer_axes + (d, inner), la + ("embed", "mlp"), scale=s_in)
    b.add(f"{path}/w_B", layer_axes + (d, N), la + ("embed", "ssm_state"), scale=s_in)
    b.add(f"{path}/w_C", layer_axes + (d, N), la + ("embed", "ssm_state"), scale=s_in)
    b.add(f"{path}/w_dt", layer_axes + (d, H), la + ("embed", "ssm_heads"), scale=s_in)
    b.add(f"{path}/dt_bias", layer_axes + (H,), la + ("ssm_heads",), init="zeros")
    b.add(f"{path}/A_log", layer_axes + (H,), la + ("ssm_heads",), init="zeros")
    b.add(f"{path}/D_skip", layer_axes + (H,), la + ("ssm_heads",), init="ones")
    b.add(f"{path}/conv_x", layer_axes + (CONV_K, inner), la + ("conv", "mlp"), scale=0.5)
    b.add(f"{path}/conv_B", layer_axes + (CONV_K, N), la + ("conv", "ssm_state"), scale=0.5)
    b.add(f"{path}/conv_C", layer_axes + (CONV_K, N), la + ("conv", "ssm_state"), scale=0.5)
    b.add(f"{path}/norm_scale", layer_axes + (inner,), la + ("mlp",), init="ones")
    b.add(f"{path}/w_out", layer_axes + (inner, d), la + ("mlp", "embed"), scale=1.0 / np.sqrt(inner))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, carry: torch.Tensor):
    """Depthwise causal conv, kernel CONV_K.

    x: (B,S,Ch), w: (K,Ch), carry: (B,K-1,Ch) previous tokens.
    Returns (y (B,S,Ch), new_carry (B,K-1,Ch))."""
    S = x.shape[1]
    full = torch.cat([carry.to(x.dtype), x], dim=1)  # (B, S+K-1, Ch)
    w = w.to(x.dtype)
    y = torch.zeros_like(x)
    for k in range(CONV_K):
        y = y + full[:, k:k + S, :] * w[k][None, None, :]
    return L.silu(y), full[:, -(CONV_K - 1):, :]


def _project(p, x):
    z = x @ p["w_z"].to(x.dtype)
    xin = x @ p["w_x"].to(x.dtype)
    Braw = x @ p["w_B"].to(x.dtype)
    Craw = x @ p["w_C"].to(x.dtype)
    dt = softplus((x @ p["w_dt"].to(x.dtype)).float() + p["dt_bias"].float())  # (B,S,H)
    return z, xin, Braw, Craw, dt


def _gated_norm(y, z, scale):
    # the product is not rounded to y's dtype: XLA drops the round trip
    # bf16 -> f32 that the reference's astype would make
    yf = y.float() * L.silu(z).float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + 1e-6) * scale.float()).to(y.dtype)


def _convs(p, x, conv_state):
    """The projections and the three causal convs; returns (z, x, B, C,
    dt, new conv state)."""
    z, xin, Braw, Craw, dt = _project(p, x)
    xin, cx = _causal_conv(xin, p["conv_x"], conv_state[0])
    Bc, cb = _causal_conv(Braw, p["conv_B"], conv_state[1])
    Cc, cc = _causal_conv(Craw, p["conv_C"], conv_state[2])
    return z, xin, Bc, Cc, dt, (cx, cb, cc)


def _finish(p, y, xh, z, x):
    """The D skip, the gated norm and the output projection of the
    (B,S,H,P) f32 scan output ``y``."""
    B, S, H, P = y.shape
    y = y + p["D_skip"].float()[None, None, :, None] * xh.float()
    y = y.reshape(B, S, H * P).to(x.dtype)
    y = _gated_norm(y, z, p["norm_scale"])
    return y @ p["w_out"].to(x.dtype)


def mamba2_chunked(
    p: dict,
    x: torch.Tensor,  # (B,S,D)
    conv_state: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # per-stream (B,K-1,·)
    ssm_state: torch.Tensor,  # (B,H,N,P) f32
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, tuple, torch.Tensor]:
    B, S, D = x.shape
    chunk = chunk_size(S, chunk)
    z, xin, Bc, Cc, dt, conv = _convs(p, x, conv_state)
    inner = xin.shape[-1]
    H = p["A_log"].shape[-1]
    P = inner // H
    xh = xin.reshape(B, S, H, P)
    A = -torch.exp(p["A_log"].float())  # (H,) negative
    la = dt * A[None, None, :]  # (B,S,H) log-decay per token
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    h = ssm_state.float()
    ys = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        xb, Bb, Cb = xh[:, sl].float(), Bc[:, sl].float(), Cc[:, sl].float()
        dtb, lab = dt[:, sl], la[:, sl]  # (B,chunk,H)
        cum = torch.cumsum(lab, dim=1)  # (B,chunk,H) inclusive
        # intra-chunk: y_i += C_i · Σ_{j<=i} exp(cum_i - cum_j) Δ_j B_j x_jᵀ
        scores = Cb @ Bb.transpose(1, 2)  # (B,chunk,chunk)
        decay = cum[:, :, None, :] - cum[:, None, :, :]  # (B,i,j,H)
        # mask the exponent before exp: above the diagonal it is positive
        decay = torch.where(tri[None, :, :, None], decay, -torch.inf)
        w = scores[..., None] * torch.exp(decay) * dtb[:, None, :, :]  # (B,i,j,H)
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xb)
        # inter-chunk: y_i += C_i · exp(cum_i) h_prev, in the reference's
        # contraction order: the outer product C_i ⊗ exp(cum_i) (a matmul of
        # inner dim 1, exact), then the contraction with the state over n
        ce = Cb[..., :, None] @ torch.exp(cum)[..., None, :]  # (B,i,n,h)
        y_inter = torch.einsum("binh,bhnp->bihp", ce, h)
        # carry: h_new = exp(cum_last) h_prev + Σ_j exp(cum_last-cum_j) Δ_j B_j x_jᵀ
        cl = cum[:, -1, :]  # (B,H)
        carry_gate = torch.exp(cl[:, None, :] - cum) * dtb  # (B,chunk,H)
        gb = carry_gate[..., :, None] @ Bb[..., None, :]  # (B,j,h,n): the outer product, exact
        h = torch.exp(cl)[:, :, None, None] * h + torch.einsum("bjhn,bjhp->bhnp", gb, xb)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)  # (B,S,H,P)
    return _finish(p, y, xh, z, x), conv, h


def mamba2_decode(
    p: dict,
    x: torch.Tensor,  # (B,1,D)
    conv_state: tuple,
    ssm_state: torch.Tensor,  # (B,H,N,P)
):
    """Single-token step: O(H·N·P) state update."""
    B = x.shape[0]
    z, xin, Bc, Cc, dt, conv = _convs(p, x, conv_state)
    inner = xin.shape[-1]
    H = p["A_log"].shape[-1]
    P = inner // H
    xh = xin.reshape(B, H, P).float()
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt[:, 0] * A[None, :])  # (B,H)
    dB = dt[:, 0][:, :, None] * Bc[:, 0].float()[:, None, :]  # (B,H,N)
    h_new = decay[:, :, None, None] * ssm_state.float() + dB[..., :, None] * xh[..., None, :]
    y = torch.einsum("bn,bhnp->bhp", Cc[:, 0].float(), h_new)
    return _finish(p, y[:, None], xh[:, None], z, x), conv, h_new


def mamba2_ref(p: dict, x: torch.Tensor, conv_state: tuple, ssm_state: torch.Tensor):
    """Token-by-token oracle (one ``mamba2_decode`` a token)."""
    cs, hs = conv_state, ssm_state.float()
    outs = []
    for t in range(x.shape[1]):
        out, cs, hs = mamba2_decode(p, x[:, t:t + 1], cs, hs)
        outs.append(out[:, 0])
    return torch.stack(outs, dim=1), cs, hs


def init_mamba2_state(cfg, batch: int, device="cpu"):
    inner = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads_eff
    P = inner // H
    N = cfg.ssm_state
    conv = (
        torch.zeros((batch, CONV_K - 1, inner), dtype=torch.float32, device=device),
        torch.zeros((batch, CONV_K - 1, N), dtype=torch.float32, device=device),
        torch.zeros((batch, CONV_K - 1, N), dtype=torch.float32, device=device),
    )
    return conv, torch.zeros((batch, H, N, P), dtype=torch.float32, device=device)
