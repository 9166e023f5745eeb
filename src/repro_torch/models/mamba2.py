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

from functools import partial
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.device_cache import concrete_device
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamBuilder
from repro_torch.models.rwkv6 import chunk_size, softplus
from repro_torch.models.sharding import on_scan_blocks, pinned

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
    # on a mesh that splits the features, the variance's sum is reduced
    # whole (one all-reduce), as the reference's: left to DTensor it is
    # scattered over the sequence and every feature moves after it
    var = pinned(torch.mean(yf * yf, dim=-1, keepdim=True))
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
    # on a mesh each device scans its own (batch, head) block
    y, h = on_scan_blocks(partial(_ssd_scan, chunk=chunk), (xh, Bc, Cc, dt, p["A_log"], ssm_state),
                          dims=((0, 2), (0, None), (0, None), (0, 2), (None, 0), (0, 1)),
                          out_dims=((0, 2), (0, 1)))
    return _finish(p, y, xh, z, x), conv, h


def _ssd_scan(xh, Bc, Cc, dt, A_log, ssm_state, *, chunk: int):
    """The chunked SSD recurrence of (B,S,H,P) x, (B,S,N) B and C and
    (B,S,H) Δ from the (B,H,N,P) state; returns (y (B,S,H,P) f32, the last
    state f32)."""
    A = -torch.exp(A_log.float())  # (H,) negative
    la = dt * A[None, None, :]  # (B,S,H) log-decay per token
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    h = ssm_state.float()
    ys = []
    # split, not sliced: the backward concatenates the chunks' gradients
    # where slicing would add S / chunk zero-padded copies
    for xb, Bb, Cb, dtb, lab in zip(*(t.split(chunk, dim=1) for t in (xh, Bc, Cc, dt, la))):
        xb, Bb, Cb = xb.float(), Bb.float(), Cb.float()  # dtb, lab: (B,chunk,H)
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
    return torch.cat(ys, dim=1), h  # (B,S,H,P)


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
    # on a mesh each device steps its own (batch, head) block
    y, h_new = on_scan_blocks(_ssd_step, (xh, Bc, Cc, dt, p["A_log"], ssm_state),
                              dims=((0, 1), (0, None), (0, None), (0, 2), (None, 0), (0, 1)),
                              out_dims=((0, 1), (0, 1)))
    return _finish(p, y[:, None], xh[:, None], z, x), conv, h_new


def _ssd_step(xh, Bc, Cc, dt, A_log, ssm_state):
    """One token's SSD step of (B,H,P) f32 x, (B,1,N) B and C and (B,1,H) Δ
    from the (B,H,N,P) state; returns (y (B,H,P) f32, the new state)."""
    A = -torch.exp(A_log.float())
    decay = torch.exp(dt[:, 0] * A[None, :])  # (B,H)
    dB = dt[:, 0][:, :, None] * Bc[:, 0].float()[:, None, :]  # (B,H,N)
    h_new = decay[:, :, None, None] * ssm_state.float() + dB[..., :, None] * xh[..., None, :]
    return torch.einsum("bn,bhnp->bhp", Cc[:, 0].float(), h_new), h_new


def mamba2_ref(p: dict, x: torch.Tensor, conv_state: tuple, ssm_state: torch.Tensor):
    """Token-by-token oracle (one ``mamba2_decode`` a token)."""
    cs, hs = conv_state, ssm_state.float()
    outs = []
    for t in range(x.shape[1]):
        out, cs, hs = mamba2_decode(p, x[:, t:t + 1], cs, hs)
        outs.append(out[:, 0])
    return torch.stack(outs, dim=1), cs, hs


def init_mamba2_state(cfg, batch: int, device="cuda"):
    """Zero conv and SSM states on ``device`` (CUDA by default; raises
    without a card)."""
    device = concrete_device(device)
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
