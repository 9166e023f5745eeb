"""FLOP accounting of a traced step, at the global (unsharded) shapes.

Port of ``repro/analysis/flops.py``.  The reference walks the jaxpr and
multiplies each ``scan`` body by its trip count.  The port has no jaxpr: it
runs the step under a ``TorchDispatchMode`` (usually on ``meta`` tensors or
DTensors over them, so nothing is computed) and counts every aten op that
reaches the dispatcher.  Python loops unroll, so a loop over layers or
microbatches is counted once per trip, exactly; autograd's backward and a
checkpoint's recompute dispatch their own ops and are counted too.  An op
dispatched inside ``models.sharding.alike(n)`` counts ``n`` times: one
device's attention block standing for every device's (``on_blocks``), or a
dry-run's one traced trip of a loop standing for all of them (the beam's
data-dependent loop, where the reference reads a ``_trip_hint``; the
attention block loops, as the reference counts a ``scan`` body once times
its length: ``launch/specs.py`` and ``launch/probe_dryrun.py``).

Where the mode sits decides what it counts.  Entered around DTensor code,
the mode is called with the DTensors themselves, before DTensor splits an op
into its local blocks and collectives, and its handler runs with the mode
switched off, so the local ops are not seen: each op is counted once at its
global shape, as the reference counts the unpartitioned jaxpr.  The
roofline divides by the device count.

Counted (the reference's rules): every matmul-family op at 2·batch·M·N·K
(``mm``, ``bmm``, ``addmm``, ``baddbmm``: what ``einsum``, ``matmul`` and
``linear`` decompose to), a convolution at 2·out·(in/groups)·kernel, and one
FLOP per output element of each elementwise and reduction op in
``ELEMENTWISE`` / ``REDUCTIONS``.  The matmul part is reported apart
(:attr:`FlopCount.dot`), since it is the part that must equal the
reference's ``dot_general`` count; the rest follows aten's op boundaries,
which are not XLA's (``mean`` is one op here, ``reduce_sum`` + ``div``
there).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models.sharding import alike, alike_factor

ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp", "log", "tanh",
    "sigmoid", "rsqrt", "sqrt", "neg", "abs", "floor", "ceil", "round", "sign", "pow",
    "erf", "cumsum", "cumprod", "where", "clamp", "clamp_min", "clamp_max",
    "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "erfinv", "expm1", "log1p", "sin",
    "cos", "square", "reciprocal", "relu", "silu", "gelu", "softplus",
}
REDUCTIONS = {"sum", "amax", "amin", "max", "min", "prod", "argmax", "argmin", "mean",
              "logsumexp", "_softmax", "_log_softmax"}

MATMULS = {"mm", "bmm", "addmm", "baddbmm"}
CONVS = {"convolution"}
# per thread: the op a FlopCounter is dispatching (the collective counter
# files DTensor's collectives under its name) and the last op that raised
_STATE = threading.local()


def _numel(t) -> int:
    n = 1
    for s in t.shape:
        n *= int(s)
    return n


def _name(func) -> str:
    """``aten.add.Tensor`` / ``aten.add_.Tensor`` -> ``add``."""
    name = func._overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.startswith("_") else name


def _matmul_flops(name: str, args) -> float:
    if name in ("addmm", "baddbmm"):
        args = args[1:]
    a, b = args[0], args[1]
    if name in ("mm", "addmm"):
        m, k = a.shape
        n = b.shape[1]
        return 2.0 * m * n * k
    bsz, m, k = a.shape
    n = b.shape[2]
    return 2.0 * bsz * m * n * k


def _conv_flops(args, out) -> float:
    w = args[1]
    per_out = 1
    for s in w.shape[1:]:
        per_out *= int(s)
    return 2.0 * _numel(out) * per_out


@dataclass
class FlopCount:
    dot: float = 0.0  # matmul-family + convolution FLOPs
    other: float = 0.0  # elementwise + reduction FLOPs
    by_op: Dict[str, float] = field(default_factory=lambda: defaultdict(float))

    @property
    def total(self) -> float:
        return self.dot + self.other


class FlopCounter(TorchDispatchMode):
    """Counts the FLOPs of every aten op dispatched while it is entered
    (see the module docstring for where it sits relative to DTensor)."""

    def __init__(self):
        super().__init__()
        self.count = FlopCount()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        outer = getattr(_STATE, "op", None)
        _STATE.op = getattr(func, "__name__", str(func))
        try:
            out = func(*args, **(kwargs or {}))
        except Exception:
            # the innermost op that raised, for a dry-run's error row
            if getattr(_STATE, "raised", None) is None:
                _STATE.raised = _STATE.op
            raise
        finally:
            _STATE.op = outer
        if not isinstance(func, torch._ops.OpOverload):
            return out
        name = _name(func)
        if name in MATMULS:
            f = _matmul_flops(name, args) * alike_factor()
            self.count.dot += f
        elif name in CONVS:
            f = _conv_flops(args, out) * alike_factor()
            self.count.dot += f
        elif name in ELEMENTWISE or name in REDUCTIONS:
            first = out[0] if isinstance(out, (tuple, list)) else out
            f = float(_numel(first)) * alike_factor() if isinstance(first, torch.Tensor) else 0.0
            self.count.other += f
        else:
            return out
        self.count.by_op[name] += f
        return out


def count_flops(fn, *args, trips: Optional[float] = None, **kwargs) -> FlopCount:
    """FLOPs of ``fn(*args, **kwargs)`` at global shapes; with ``trips``,
    one traced trip of a data-dependent loop counted ``trips`` times (the
    reference's ``_trip_hint``), through ``models.sharding.alike``."""
    with FlopCounter() as counter, alike(1 if trips is None else trips):
        fn(*args, **kwargs)
    return counter.count


def raised_op():
    """The op whose dispatch raised last under a :class:`FlopCounter` (and
    forgets it), or ``None``."""
    op, _STATE.raised = getattr(_STATE, "raised", None), None
    return op


def current_op():
    """The aten op an entered :class:`FlopCounter` is dispatching, if any."""
    return getattr(_STATE, "op", None)
