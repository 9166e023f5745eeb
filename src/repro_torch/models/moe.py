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

On a mesh of more than one device the dispatch, the expert FFN and the
combine run on each device's block (:func:`_experts_on_blocks`), as the
reference's partitioner keeps the tokens where they are split (DTensor's
own strategy for the expert ``bmm`` would move its activations between a
token and an ff split).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import sharding
from repro_torch.models.layers import ParamBuilder
from repro_torch.models.sharding import SUM, is_dtensor, pinned, placed_like


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
    gate_idx = torch.sort(probs.detach(), dim=-1, descending=True, stable=True).indices[..., :top_k]
    # the gates read through a one-hot mask, and so their gradient: the
    # sort's own backward is a scatter, which torch 2.11's DTensor
    # computes on the whole (G, S, E) gathered over the batch
    gate_vals = (probs[..., None, :] * F.one_hot(gate_idx, probs.shape[-1]).to(probs.dtype)).sum(dim=-1)
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
    # on a mesh, the groups split over the batch only, and so is their
    # gradient (the router's and the experts' pending sums settled at once)
    xg = pinned(x.reshape(G, gsz, D))

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

    ws = (p["wi_gate"], p["wi_up"], p["wo"])
    if is_dtensor(xg) and xg.device_mesh.size() > 1:
        out = _experts_on_blocks(xg, dispatch, combine_w, ws, x.dtype)
    else:
        out = _combined(dispatch, combine_w, _experts(_dispatched(dispatch, xg), *ws), x.dtype)
    # on a mesh, back in the tokens' layout before the groups unflatten
    # into (B, S): DTensor may split the groups over more devices than B
    return placed_like(out, xg).reshape(B, S, D), aux


def _dispatched(dispatch, xg):
    """Each expert's buffer (E, G, C, D) of tokens: each (e, g, c) slot holds
    at most one token, so the dispatch is a gather."""
    return torch.einsum("gsec,gsd->egcd", dispatch, xg)


def _gated(h_in, wi_gate, wi_up):
    """The experts' gated products silu(x Wg) * (x Wu), (E, G·C, F), of
    their buffers (E, G, C, D)."""
    E, G, C, D = h_in.shape
    h_in = h_in.reshape(E, G * C, D)
    g = torch.bmm(h_in, wi_gate.to(h_in.dtype))
    u = torch.bmm(h_in, wi_up.to(h_in.dtype))
    return g, u


def _experts(expert_in, wi_gate, wi_up, wo):
    """The experts' FFN of their buffers (E, G, C, D), the same shape."""
    g, u = _gated(expert_in, wi_gate, wi_up)
    return _out(L.silu(g) * u, wo, expert_in.shape[1])


def _out(h, wo, G: int):
    """(E, G·C, F) through ``wo`` -> (E, G, C, D)."""
    E, GC, _ = h.shape
    return torch.bmm(h, wo.to(h.dtype)).reshape(E, G, GC // G, -1)


def _combined(dispatch, combine_w, expert_out, dtype):
    """Each token's gated sum of its experts' outputs, (G, S, D)."""
    combine = dispatch.float() * combine_w[..., None]  # (G,S,E,C)
    return torch.einsum("gsec,egcd->gsd", combine.to(dtype), expert_out)


def _experts_on_blocks(xg, dispatch, combine_w, ws, dtype):
    """The dispatch, the expert FFN and the combine of DTensors, run on each
    device's block (:func:`sharding.expert_roles`): the token groups stay
    split over the batch's mesh dims (nothing gathers them), and on the
    mesh dim that splits ``wo`` each device runs its experts (``"expert"``),
    its slice of the ff dim (``"ff"``: ``wi`` re-split on F by one
    all-to-all, as Megatron's column- then row-parallel pair) or of
    ``d_model`` (``"embed"``: the first contraction's pending sum settled by
    one all-reduce before the silu, as a row-parallel layer).  The expert
    weights are gathered over the other mesh dims (their gradients reduced
    back), once a call unless the train step gathered them for the whole
    step; the output is a pending sum over the expert's or ff's mesh dim,
    or split on ``d_model``, for the caller's ``placed_like`` to settle."""
    wg, wu, wo = ws
    mesh, roles = xg.device_mesh, sharding.expert_roles(xg, wo)
    n = math.prod(mesh.size(j) for j, r in enumerate(roles) if r is not None)
    w_in = {"expert": 0, "embed": 1, "ff": 2}
    xl = sharding.block(xg, roles, {"batch": 0, "embed": 2}, grad={"expert": SUM, "ff": SUM})
    dl = sharding.block(dispatch, roles, {"batch": 0, "expert": 2})
    wgl, wul = (sharding.weight_block(w, roles, w_in, dtype) for w in (wg, wu))
    # the buffers are alike on an ff split's devices: they count once
    n_in = math.prod(mesh.size(j) for j, r in enumerate(roles) if r not in (None, "ff"))
    expert_in = sharding.run_blocks(_dispatched, n_in, dl, xl)
    g, u = sharding.run_blocks(_gated, n, expert_in, wgl, wul)
    # (E, G·C, F): the groups lead the rows
    gu_dims = {"batch": 1, "expert": 0, "ff": 2, "embed": SUM}
    g, u = (sharding.unblock(t, mesh, roles, gu_dims) for t in (g, u))
    if "embed" in roles:  # the pending sums settled: one all-reduce each
        g, u = (placed_like(t, t) for t in (g, u))
    # the gradient of h settled once, before the silu's backward splits it
    h = pinned(L.silu(g) * u, dims=(0, 1, 2))
    h_dims = {"batch": 1, "expert": 0, "ff": 2}
    hl = sharding.block(h, roles, h_dims, grad={"embed": SUM})
    wol = sharding.weight_block(wo, roles, {"expert": 0, "ff": 1, "embed": 2}, dtype)
    cl = sharding.block(combine_w, roles, {"batch": 0, "expert": 2}, grad={"ff": SUM, "embed": SUM})
    G = xl.shape[0]
    out = sharding.run_blocks(lambda a, b, c, d: _combined(c, d, _out(a, b, G), dtype), n, hl, wol, dl, cl)
    return sharding.unblock(out, mesh, roles, {"batch": 0, "expert": SUM, "ff": SUM, "embed": 2})


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
