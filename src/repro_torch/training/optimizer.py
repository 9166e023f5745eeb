"""AdamW on tensor trees, updated in place.

Port of ``repro/training/optimizer.py``.  The state is a tree parallel to
the params: first / second moments in f32 plus a 0-d int32 step counter.
Weight decay is decoupled (AdamW); global-norm clipping is fused into the
update, and the norm is reported before clipping.

The arithmetic is the reference's, in its order and in f32.  Where the
reference builds new trees and lets the train step donate the old buffers,
:func:`adamw_update` rewrites ``params``, ``m``, ``v`` and ``step`` in place,
leaf by leaf: at a 3B model a functional update would hold the old and the
new moments at once, more than one card holds.  A caller that needs the old
values copies them first.  No value is read back to the host.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch


class AdamWState(NamedTuple):
    m: Any
    v: Any
    step: torch.Tensor  # 0-d int32


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists, tuples and NamedTuples, dict
    keys in sorted order (the reference's pytree order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the parallel ``rest``),
    keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def adamw_init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    step_dev = tree_leaves(params)[0].device
    return AdamWState(m=zeros, v=tree_map(torch.clone, zeros),
                      step=torch.zeros((), dtype=torch.int32, device=step_dev))


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    *,
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step: ``params``, ``state.m``, ``state.v`` and
    ``state.step`` are updated in place (``grads`` is read only) and
    returned as ``(params, state, {"grad_norm": ...})``."""
    gnorm = global_norm(grads)
    scale = None
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    state.step.add_(1)
    stepf = state.step.float()
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v)):
        g = g.float() if scale is None else g.float() * scale
        # m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g * g
        m.mul_(b1).add_(g * (1 - b1))
        t = g * (1 - b2)
        v.mul_(b2).add_(t.mul_(g))
        del g, t
        # p = p - lr * (m / bc1 / (sqrt(v / bc2) + eps) + wd * p)
        den = (v / bc2).sqrt_().add_(eps)
        delta = (m / bc1).div_(den)
        torch.mul(p.float(), weight_decay, out=den)
        delta.add_(den).mul_(lr)
        del den
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float().sub_(delta))
    return params, state, {"grad_norm": gnorm}
