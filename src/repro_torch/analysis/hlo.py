"""Collective bytes of a traced step.

Port of ``repro/analysis/hlo.py``.  The reference parses the post-SPMD HLO
text for its collectives and multiplies each ``while`` body by its trip
count.  The port has no HLO: DTensor inserts its collectives while the step
runs, as functional collectives (``torch.ops._c10d_functional``) on each
rank's local blocks.  :class:`CollectiveCounter` is a ``TorchDispatchMode``
built as ``CommDebugMode`` is: for an op on DTensors it returns
``NotImplemented``, so DTensor runs and splits the op into local ops and
collectives, and the mode then sees each collective on plain tensors.  A
collective the traced code issues itself (the mesh probe's ``all_gather``)
is seen the same way.

Each collective is summed into the reference's :class:`CollectiveStats`:
its result's bytes on one device (the shape the reference reads left of the
op name), and those bytes times its group's size (the global payload).
Python loops unroll, so every trip is its own op and ``corrected_bytes``
equals ``raw_bytes``; the field stays for the reference's row schema.
``by_axis`` splits the global bytes by the mesh axes of each group, which is
what the roofline charges to NVLink or InfiniBand; ``by_op`` by the aten op
an entered :class:`~repro_torch.analysis.flops.FlopCounter` was dispatching
when DTensor issued them (``direct`` for one the traced code issued, or a
re-layout it asked for: ``sharding.pinned``, ``sharding.vocab_rows``).

On a mesh of ``cpu`` devices DTensor makes a shard-to-shard redistribution
an all-gather plus a local chunk (no all-to-all on a CPU group), so such a
move shows as an all-gather there.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.flops import current_op
from repro_torch.models.sharding import alike_factor

_DTYPE_BYTES = {
    torch.bool: 1, torch.uint8: 1, torch.int8: 1, torch.int16: 2, torch.int32: 4,
    torch.int64: 8, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1, torch.bfloat16: 2,
    torch.float16: 2, torch.float32: 4, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}

_fc = torch.ops._c10d_functional
# op -> (the reference's kind, index of group_size in the args or None)
COLLECTIVE_OPS = {
    _fc.all_gather_into_tensor: ("all-gather", 1),
    _fc.all_gather_into_tensor_coalesced: ("all-gather", 1),
    _fc.all_reduce: ("all-reduce", None),
    _fc.all_reduce_coalesced: ("all-reduce", None),
    _fc.reduce_scatter_tensor: ("reduce-scatter", 2),
    _fc.reduce_scatter_tensor_coalesced: ("reduce-scatter", 2),
    _fc.all_to_all_single: ("all-to-all", None),
    _fc.broadcast: ("broadcast", None),
}


_COLLECTIVE_NAMES = {p.__name__ for p in COLLECTIVE_OPS}


def _shape_bytes(shape, dtype: torch.dtype) -> int:
    """Bytes of a tensor of ``shape`` and ``dtype``."""
    n = 1
    for d in shape:
        n *= int(d)
    return n * _DTYPE_BYTES[dtype]


@dataclass
class CollectiveStats:
    raw_bytes: int = 0  # every collective counted once (per-device results)
    corrected_bytes: int = 0  # equal to raw_bytes: loops unroll
    global_bytes: int = 0  # per-device bytes x group size (global payload)
    by_kind: Dict[str, int] = field(default_factory=dict)  # global, per kind
    ops: int = 0
    by_axis: Dict[str, int] = field(default_factory=dict)  # global, per mesh-axis group
    by_op: Dict[str, int] = field(default_factory=dict)  # global, per op that issued them


def _ranks(group) -> Tuple[int, ...]:
    import torch.distributed as dist

    return tuple(dist.get_process_group_ranks(group))


def _group_axes(mesh) -> Dict[Tuple[int, ...], str]:
    """The ranks of each of this rank's mesh-axis groups -> the axis.  By
    ranks, not by group name: DTensor may run a collective on the group of
    an earlier mesh of the same layout (its caches key meshes by layout)."""
    if mesh is None:
        return {}
    names = mesh.mesh_dim_names or tuple(str(i) for i in range(mesh.ndim))
    return {_ranks(mesh.get_group(i)): n for i, n in enumerate(names)}


class CollectiveCounter(TorchDispatchMode):
    """Sums the collectives dispatched while it is entered (each times the
    enclosing ``models.sharding.alike`` factor).  ``mesh`` names each
    group's axis in ``by_axis``."""

    def __init__(self, mesh=None):
        super().__init__()
        self.stats = CollectiveStats()
        self._axes = _group_axes(mesh)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        packet = getattr(func, "_overloadpacket", None)
        if packet in COLLECTIVE_OPS:
            self._record(packet, args, out)
        return out

    def _record(self, packet, args, out) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group

        kind, size_at = COLLECTIVE_OPS[packet]
        group_name = args[-1]
        pg = _resolve_process_group(group_name)
        group = int(args[size_at]) if size_at is not None else pg.size()
        outs = out if isinstance(out, (list, tuple)) else [out]
        n = alike_factor()
        b = int(sum(_shape_bytes(t.shape, t.dtype) for t in outs) * n)
        s = self.stats
        s.raw_bytes += b
        s.corrected_bytes += b
        s.global_bytes += b * group
        s.by_kind[kind] = s.by_kind.get(kind, 0) + b * group
        axis = self._axes.get(_ranks(pg), str(group_name))
        s.by_axis[axis] = s.by_axis.get(axis, 0) + b * group
        op = current_op()
        if op is None or op.split(".")[0] in _COLLECTIVE_NAMES:
            op = "direct"  # issued outside an aten op's dispatch (a re-layout of the model code's)
        s.by_op[op] = s.by_op.get(op, 0) + b * group
        s.ops += int(n)


def count_collectives(fn, *args, mesh=None, **kwargs) -> CollectiveStats:
    """Collectives of ``fn(*args, **kwargs)``."""
    with CollectiveCounter(mesh) as counter:
        fn(*args, **kwargs)
    return counter.stats
