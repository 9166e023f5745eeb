"""Train-step factory: CE loss, microbatched gradient accumulation, remat.

Port of ``repro/training/train_loop.py`` on one device.
``make_train_step(model, cfg, device)`` returns ``(train_step, None)``:

    train_step(params, opt_state, ids, labels) -> (params, opt_state, metrics)

with the reference's step: the batch split into ``cfg.microbatches``, each
microbatch's gradient of CE + ``aux_loss_weight`` x the model's aux loss
summed in f32 and divided by the count, then one AdamW update.  ``remat``
wraps the loss in ``torch.utils.checkpoint`` as the reference wraps it in
``jax.checkpoint``.  The step updates the caller's ``params`` and
``opt_state`` in place and returns them, as the reference donates its
buffers.  The second element stands where the reference returns its
shardings; it comes back with the port of ``models/sharding.py``.

Gradients accumulate straight into one f32 buffer a parameter: each stacked
``layers/...`` tensor is split into per-layer leaves whose ``.grad`` is that
layer's view of the buffer, so autograd adds every layer's gradient in
place (indexing the stacked tensor in the forward would give each layer's
backward a zero-filled copy of the whole stack).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.device_cache import concrete_device
from repro_torch.models.model import Model
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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over all positions; labels == -100 are masked.

    Handles the musicgen (B,S,CB,V) case by folding codebooks into
    positions."""
    if logits.ndim == 4:  # (B,S,CB,V)
        B, S, CB, V = logits.shape
        logits = logits.reshape(B, S * CB, V)
        labels = labels.reshape(B, S * CB)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
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


def make_train_step(model: Model, cfg: TrainStepConfig = TrainStepConfig(), device="cuda"):
    """Returns ``(train_step, None)`` for ``model`` on ``device`` (CUDA by
    default; raises without a card).  ``ids`` / ``labels`` may be numpy
    arrays or tensors; they are moved to the device."""
    dev = concrete_device(device)
    if model.device != dev:
        raise ValueError(f"the model lives on {model.device}, the step on {dev}")

    def loss_fn(params, ids, labels):
        logits, aux = model.forward(params, ids)
        return cross_entropy(logits, labels) + cfg.aux_loss_weight * aux

    def loss_for_grad(params, ids, labels):
        if cfg.remat:
            return checkpoint(loss_fn, params, ids, labels, use_reentrant=False)
        return loss_fn(params, ids, labels)

    def train_step(params, opt_state: AdamWState, ids, labels):
        ids = torch.as_tensor(ids).to(dev, torch.int64)
        labels = torch.as_tensor(labels).to(dev, torch.int64)
        n_micro = cfg.microbatches
        B = ids.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
        mb = B // n_micro
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev), params)
        pairs: list = []
        leaves = _grad_leaves(params, grads, pairs)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(n_micro):
            rows = slice(i * mb, (i + 1) * mb)
            loss = loss_for_grad(leaves, ids[rows], labels[rows])
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        if any(t.grad.data_ptr() != g.data_ptr() for t, g in pairs):
            raise RuntimeError("autograd replaced a gradient buffer instead of adding into it")
        del leaves, pairs
        for g in tree_leaves(grads):
            g.div_(n_micro)
        params, opt_state, stats = adamw_update(
            params, grads, opt_state,
            lr=cfg.lr, weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm,
        )
        return params, opt_state, {"loss": loss_sum / n_micro, **stats}

    return train_step, None


def init_train_state(model: Model, generator: torch.Generator):
    """f32 master params drawn from ``generator`` on the model's device, and
    their AdamW state."""
    params = model.init(generator, dtype=torch.float32)
    return params, adamw_init(params)
