"""Mixture-of-Experts block — GShard-style dispatch/combine.

Port of ``repro/models/moe.py``:

- top-k routing with renormalized gates (mixtral/dbrx convention), the
  top k taken in ``lax.top_k``'s order (descending, ties to the lower
  expert index: a stable sort, where ``torch.topk``'s order is unspecified);
- tokens are re-grouped into fixed-size groups (``group_size``) so the
  dispatch one-hot is (G, S_g, E, C) with C = ceil(S_g·topk·cf / E);
- capacity-factor token dropping (dropped tokens pass through the residual:
  the block adds nothing for them), positions in an expert's buffer taken
  k outer, s inner, plus the standard load-balancing auxiliary loss.

``moe_block_dense_ref`` runs every token through every expert, gated: the
exact (no-drop) form that decode uses.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.layers import ParamBuilder
from repro_torch.models.sharding import placed_like


def add_moe_params(b: ParamBuilder, path: str, cfg, layer_axes=()) -> None:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    la = tuple([None] * len(layer_axes))
    s_in, s_out = 1.0 / np.sqrt(d), 1.0 / np.sqrt(ff)
    b.add(f"{path}/router", layer_axes + (d, E), la + ("embed", "expert"), scale=s_in)
    b.add(f"{path}/wi_gate", layer_axes + (E, d, ff), la + ("expert", "expert_embed", "expert_mlp"), scale=s_in)
    b.add(f"{path}/wi_up", layer_axes + (E, d, ff), la + ("expert", "expert_embed", "expert_mlp"), scale=s_in)
    b.add(f"{path}/wo", layer_axes + (E, ff, d), la + ("expert", "expert_mlp", "expert_embed"), scale=s_out)


def _route(p: dict, x: torch.Tensor, top_k: int):
    """Router probabilities (..., E) in f32 and the renormalized top-k
    gates and expert ids (..., K), in ``lax.top_k``'s order."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[..., :top_k], gate_idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gate_vals, gate_idx


def capacity(group: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Slots in each expert's buffer for a group of ``group`` tokens."""
    return int(math.ceil(group * top_k * capacity_factor / num_experts))


def buffer_slots(sel: torch.Tensor, C: int):
    """Each choice's slot in its expert's capacity buffer, by k-th choice
    priority then sequence order (k outer, s inner), and whether it fits:
    ``sel`` (G,S,E,K) one-hot choices -> (slot, kept), both (G,S,E,K); a
    choice that is not kept is dropped."""
    G, S, E, K = sel.shape
    mask_k = sel.permute(0, 3, 1, 2)  # (G,K,S,E)
    pos_k = torch.cumsum(mask_k.reshape(G, K * S, E), dim=1) - 1.0
    pos = pos_k.reshape(G, K, S, E).permute(0, 2, 3, 1)  # (G,S,E,K)
    within = (pos < C) & (sel > 0)
    return torch.where(within, pos, 0.0), within


def moe_block(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    *,
    num_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    group_size: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,D), aux_loss ())."""
    B, S, D = x.shape
    E, K = num_experts, top_k
    T = B * S
    gsz = min(group_size, T)
    assert T % gsz == 0, (T, gsz)
    G = T // gsz
    xg = x.reshape(G, gsz, D)

    probs, gate_vals, gate_idx = _route(p, xg, K)  # (G,S,E), (G,S,K)
    # mask (G, S, E, K): expert e selected as the k-th choice
    sel = F.one_hot(gate_idx, E).float().transpose(2, 3)  # (G,S,E,K)
    combine_w = torch.einsum("gsek,gsk->gse", sel, gate_vals)  # (G,S,E)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    density = sel.sum(dim=-1).mean(dim=1)  # (G, E) fraction routed
    router_prob = probs.mean(dim=1)  # (G, E)
    aux = E * torch.mean(torch.sum(density * router_prob, dim=-1))

    C = capacity(gsz, E, K, capacity_factor)
    pos, within = buffer_slots(sel, C)
    disp_k = F.one_hot(pos.long(), C).to(x.dtype) * within[..., None].to(x.dtype)
    dispatch = disp_k.sum(dim=3)  # (G,S,E,C)
    combine = dispatch.float() * combine_w[..., None]  # (G,S,E,C)

    # each (e, g, c) slot holds at most one token: the dispatch is a gather
    expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xg)  # (E,G,C,D)
    h_in = expert_in.reshape(E, G * C, D)
    g = torch.bmm(h_in, p["wi_gate"].to(x.dtype))
    u = torch.bmm(h_in, p["wi_up"].to(x.dtype))
    h = L.silu(g) * u
    expert_out = torch.bmm(h, p["wo"].to(x.dtype)).reshape(E, G, C, D)
    out = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), expert_out)
    # on a mesh, back in the tokens' layout before the groups unflatten
    # into (B, S): DTensor may split the groups over more devices than B
    return placed_like(out, xg).reshape(B, S, D), aux


def moe_block_dense_ref(p: dict, x: torch.Tensor, *, num_experts: int, top_k: int) -> torch.Tensor:
    """Dense-dispatch oracle: every token through every expert, gated.

    Exact (no capacity drops): the GShard block matches it wherever no
    token was dropped."""
    B, S, D = x.shape
    _probs, gate_vals, gate_idx = _route(p, x, top_k)
    gates = (F.one_hot(gate_idx, num_experts).float() * gate_vals[..., None]).sum(dim=-2)  # (B,S,E)
    # the tokens broadcast against each expert's weights in place (an einsum
    # would copy a permuted weight)
    xt = x.reshape(1, B * S, D)
    g = xt @ p["wi_gate"].to(x.dtype)  # (E, T, F)
    u = xt @ p["wi_up"].to(x.dtype)
    h = L.silu(g) * u
    eo = h @ p["wo"].to(x.dtype)  # (E, T, D)
    out = torch.einsum("te,etd->td", gates.reshape(B * S, num_experts).to(x.dtype), eo)
    return out.reshape(B, S, D)
