"""Train-step factory: CE loss, microbatched gradient accumulation, remat.

Port of ``repro/training/train_loop.py``.  ``make_train_step(model, mesh,
rules, cfg, device)`` returns ``(train_step, Shardings)``:

    train_step(params, opt_state, ids, labels) -> (params, opt_state, metrics)

with the reference's step: the batch split into ``cfg.microbatches``, each
microbatch's gradient of CE + ``aux_loss_weight`` x the model's aux loss
summed in f32 and divided by the count, then one AdamW update.  ``remat``
wraps the loss in ``torch.utils.checkpoint`` as the reference wraps it in
``jax.checkpoint``.  The step updates the caller's ``params`` and
``opt_state`` in place and returns them, as the reference donates its
buffers.

With ``mesh=None`` the step runs on one device and ``Shardings`` is
``None``.  On a ``DeviceMesh`` the params follow ``rules`` (default
:data:`DEFAULT_RULES`), the AdamW moments follow ``rules`` with ``embed``
also over ``data`` (ZeRO-1, the reference's), the step counter is
replicated, and each microbatch's ids and labels are split by
``spec_for(("batch", "seq"[, "codebook"]))``; the step places what it is
given (a DTensor already in place is left alone) and DTensor inserts the
collectives: the gradient reductions where a gradient meets its buffer, and
the moments' gather where the update meets the params.  A parameter split
over a mesh dim that splits the batch (the expert stacks' ff dim over
``data``) is gathered in the compute dtype once a step, before the
microbatches and the remat (:func:`_batch_gathered`), and each
microbatch's gradient reduced back in f32.

Gradients accumulate straight into one f32 buffer a parameter: each stacked
``layers/...`` tensor is split into per-layer leaves whose ``.grad`` is that
layer's view of the buffer, so autograd adds every layer's gradient in
place (indexing the stacked tensor in the forward would give each layer's
backward a zero-filled copy of the whole stack).
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.device_cache import concrete_device
from repro_torch.models.model import Model, param_shapes
from repro_torch.models.sharding import (
    DEFAULT_RULES,
    LogicalRules,
    NamedSharding,
    PartitionSpec,
    gathered,
    implicit_replication,
    is_dtensor,
    logical_to_sharding,
    pinned,
    place,
    place_tree,
    spec_for,
    with_rules,
)
from repro_torch.training.optimizer import AdamWState, adamw_init, adamw_update, tree_leaves, tree_map


@dataclass
class TrainStepConfig:
    microbatches: int = 1
    lr: float = 3e-4
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    aux_loss_weight: float = 0.01
    remat: bool = True
    compute_dtype: str = "bfloat16"  # carried as the reference carries it; the model's cfg.dtype rules


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last dim.  Where a mesh splits that dim (the
    vocabulary), it is written out so that each reduction leaves a pending
    max or sum over the split, one all-reduce of (B, S) values each, as the
    reference's program reduces: DTensor has no split strategy for
    ``logsumexp`` and would all-gather the logits.  Elsewhere (one device,
    a one-rank mesh) it is ``torch.logsumexp``, bit for bit as before."""
    from torch.distributed.tensor import Shard

    if not (is_dtensor(logits) and any(
            isinstance(p, Shard) and p.dim == logits.ndim - 1 and logits.device_mesh.size(j) > 1
            for j, p in enumerate(logits.placements))):
        return torch.logsumexp(logits, dim=-1)
    m = pinned(torch.amax(logits.detach(), dim=-1, keepdim=True))
    return torch.log(pinned(torch.sum(torch.exp(logits - m), dim=-1))) + m[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all positions; labels == -100 are masked.

    Handles the musicgen (B,S,CB,V) case by folding codebooks into
    positions."""
    if logits.ndim == 4:  # (B,S,CB,V)
        B, S, CB, V = logits.shape
        logits = logits.reshape(B, S * CB, V)
        labels = labels.reshape(B, S * CB)
    logits = logits.float()
    logz = _logsumexp(logits)
    if is_dtensor(logits):
        # on a mesh the gold logit is a masked sum over the (vocab-split)
        # last dim, one term: the same value; DTensor's vocab-parallel
        # gather handles 2-D tables only
        V = logits.shape[-1]
        hit = torch.arange(V, device=labels.device) == labels.clamp(min=0)[..., None]
        gold = pinned(torch.sum(torch.where(hit, logits, 0.0), dim=-1))
    else:
        gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    nll = logz - gold
    mask = labels >= 0
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)


def _grad_leaves(params, grads, pairs: list):
    """The params as autograd leaves whose ``.grad`` are views of ``grads``,
    the stacked ``layers`` tree as a list of per-layer trees; each (leaf,
    view) is appended to ``pairs``."""
    def leaf(view, grad):
        t = view.detach().requires_grad_(True)
        t.grad = grad
        pairs.append((t, grad))
        return t

    out = {k: tree_map(leaf, v, grads[k]) for k, v in params.items() if k != "layers"}
    if "layers" in params:
        n = tree_leaves(params["layers"])[0].shape[0]
        out["layers"] = [tree_map(lambda p, g, i=i: leaf(p[i], g[i]), params["layers"], grads["layers"])
                         for i in range(n)]
    return out


def _data_ptr(t: torch.Tensor) -> int:
    return (t.to_local() if is_dtensor(t) else t).data_ptr()


def _shardings(model: Model, mesh, rules: LogicalRules):
    shapes = param_shapes(model)
    moments = logical_to_sharding(model.axes, with_rules(rules, embed=("data",)), mesh,
                                  shapes_tree=shapes)
    batch_logical = ("batch", "seq") + (("codebook",) if model.cfg.num_codebooks else ())

    class Shardings:
        params = logical_to_sharding(model.axes, rules, mesh, shapes_tree=shapes)
        opt = AdamWState(m=moments, v=moments, step=NamedSharding(mesh, PartitionSpec()))
        batch = NamedSharding(mesh, spec_for(batch_logical, rules, mesh, dim_sizes=None))

    Shardings.rules, Shardings.batch_logical = rules, batch_logical

    return Shardings


def _batch_gathered(params, dims, dtype):
    """``params`` with each DTensor split over one of the mesh dims ``dims``
    (the batch's) whole there, in ``dtype`` (``sharding.gathered``).  Called
    once a step, outside the microbatches' remat: the whole-loss checkpoint
    holds every layer's gathered block through each backward all the same,
    so gathering them again for the recomputed forward, or for the next
    microbatch, would buy no memory."""
    def one(p):
        if is_dtensor(p) and any(p.placements[j].is_shard() for j in dims):
            return gathered(p, dims, dtype)
        return p

    return tree_map(one, params)


def make_train_step(model: Model, mesh=None, rules: Optional[LogicalRules] = None,
                    cfg: TrainStepConfig = TrainStepConfig(), device="cuda"):
    """Returns ``(train_step, Shardings)`` for ``model`` on ``device`` (CUDA
    by default; raises without a card); ``Shardings`` (``params``, ``opt``,
    ``batch``) is ``None`` without a mesh.  ``ids`` / ``labels`` may be
    numpy arrays or tensors, the whole batch; they are moved to the
    device."""
    dev = concrete_device(device)
    if model.device != dev:
        raise ValueError(f"the model lives on {model.device}, the step on {dev}")
    sh = None if mesh is None else _shardings(model, mesh, rules or DEFAULT_RULES)
    batch_dims = () if sh is None else tuple(
        j for j, p in enumerate(sh.batch.placements) if p.is_shard() and mesh.size(j) > 1)

    def loss_fn(params, ids, labels):
        logits, aux = model.forward(params, ids)
        return cross_entropy(logits, labels) + cfg.aux_loss_weight * aux

    def loss_for_grad(params, ids, labels):
        if cfg.remat:
            return checkpoint(loss_fn, params, ids, labels, use_reentrant=False)
        return loss_fn(params, ids, labels)

    def train_step(params, opt_state: AdamWState, ids, labels):
        ids, labels = (x.full_tensor() if is_dtensor(x) else x for x in (ids, labels))
        ids = torch.as_tensor(ids).to(dev, torch.int64)
        labels = torch.as_tensor(labels).to(dev, torch.int64)
        n_micro = cfg.microbatches
        B = ids.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
        mb = B // n_micro
        if sh is not None:
            params, opt_state = place_tree(params, sh.params), place_tree(opt_state, sh.opt)
        with nullcontext() if sh is None else implicit_replication():
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            pairs: list = []
            leaves = _grad_leaves(params, grads, pairs)
            inputs = _batch_gathered(leaves, batch_dims, model.dtype) if batch_dims else leaves
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_micro):
                rows = slice(i * mb, (i + 1) * mb)
                mi, ml = ids[rows], labels[rows]
                if sh is not None:  # each microbatch split over the batch axes it divides
                    split = NamedSharding(mesh, spec_for(sh.batch_logical, sh.rules, mesh,
                                                         dim_sizes=tuple(mi.shape)))
                    mi, ml = place(mi, split), place(ml, split)
                loss = loss_for_grad(inputs, mi, ml)
                if is_dtensor(loss):
                    loss = loss.full_tensor()
                loss.backward()
                loss_sum = loss_sum + loss.detach()
            if any(_data_ptr(t.grad) != _data_ptr(g) for t, g in pairs):
                raise RuntimeError("autograd replaced a gradient buffer instead of adding into it")
            del leaves, inputs, pairs
            for g in tree_leaves(grads):
                g.div_(n_micro)
            params, opt_state, stats = adamw_update(
                params, grads, opt_state,
                lr=cfg.lr, weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm,
            )
        return params, opt_state, {"loss": loss_sum / n_micro, **stats}

    return train_step, sh


def init_train_state(model: Model, mesh=None, rules: Optional[LogicalRules] = None,
                     seed: int = 0, *, generator: Optional[torch.Generator] = None):
    """f32 master params drawn from ``generator`` (default: a generator on
    the model's device seeded with ``seed``), and their AdamW state.  On a
    mesh, each rank draws the whole tree from the same seed and keeps its
    blocks: params by ``rules``, moments by the ZeRO-1 rules, as
    ``make_train_step``'s ``Shardings`` place them."""
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(seed)
    params = model.init(generator, dtype=torch.float32)
    opt = adamw_init(params)
    if mesh is None:
        return params, opt
    sh = _shardings(model, mesh, rules or DEFAULT_RULES)
    return place_tree(params, sh.params), place_tree(opt, sh.opt)
