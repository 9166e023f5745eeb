"""Gradient compression with error feedback (the cross-pod all-reduce).

Port of ``repro/training/compression.py``.  int8 quantization with one f32
scale per tensor cuts an all-reduce's bytes 4x against f32; error feedback
adds each step's residual back before the next step is quantized, so the
compressed sum stays unbiased over time.  ``torch.round`` rounds half to
even, as ``jnp.round`` does, so the quantized values are the reference's
bit for bit.

:func:`compressed_psum` runs over a ``torch.distributed`` process group in
place of the reference's ``shard_map`` axis.  The train step does not call
it, as the reference's does not.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.training.optimizer import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor):
    """Returns (q, scale, new_error)."""
    corrected = grad.float() + error
    q, scale = quantize_int8(corrected)
    deq = dequantize_int8(q, scale)
    return q, scale, corrected - deq


def compressed_psum(grads: Any, errors: Any, group=None):
    """int8-quantized all-reduce over ``group`` (the default process group
    when None) with error feedback: each rank dequantizes its own int8
    tensor and the group sums those values.  Returns (mean_grads,
    new_errors), trees shaped as ``grads``."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    new_errors = []

    def one(g, e):
        q, scale, new_e = compress_with_feedback(g, e)
        new_errors.append(new_e)
        summed = dequantize_int8(q, scale)
        dist.all_reduce(summed, group=group)
        return summed / n

    means = tree_map(one, grads, errors)
    done = iter(new_errors)  # tree_map's traversal order, both times
    return means, tree_map(lambda _g: next(done), grads)
