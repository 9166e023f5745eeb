"""Logical-axis sharding rules (MaxText-style) on a torch ``DeviceMesh``.

Port of ``repro/models/sharding.py``.  Params and activations are
annotated with *logical* axis names; a rules table maps logical names to
mesh axes.  Hillclimb variants swap individual rules (e.g. re-shard the KV
cache sequence dim) without touching model code.

Conventions (the reference's):

- a rule value may be ``None`` (replicate), a mesh-axis name, or a tuple of
  mesh axes (e.g. batch over ``("pod", "data")``);
- axes named in a rule but absent from the mesh are dropped, so the same
  rules serve the single-pod (data, model) and multi-pod (pod, data, model)
  meshes;
- a mesh axis is used at most once in a spec;
- if a dim's size does not divide the product of its mapped mesh axes, the
  mapping falls back to a prefix of the tuple, else to replication (the
  ``strict`` flag raises instead);
- trailing ``None`` entries are trimmed.

The rules read only a mesh's axis names and sizes (:func:`mesh_shape`), so
they take a ``DeviceMesh`` or a device-less :class:`AbstractMesh`.  A spec
becomes DTensor placements through :func:`placements_for`: entry ``i`` of
the spec naming mesh axes ``("pod", "data")`` puts ``Shard(i)`` on both
mesh dims, pod major.  DTensor shards a tensor dim over several mesh dims
in the mesh's dim order, so a tuple in another order cannot be expressed
and raises.

The second half places tensors: :func:`place` / :func:`place_tree` (the
counterpart of ``jit``'s ``in_shardings``: each rank keeps its block of a
whole tensor, nothing sent), the re-layouts the model code needs where
DTensor cannot follow a view (:func:`splittable`, :func:`split_only`,
:func:`placed_like`), the layouts it pins where DTensor's own choice
would move more than the reference's program (:func:`pinned`, the
residual stream; :func:`vocab_rows`, the vocabulary-parallel lookup), and
:func:`on_blocks`, attention on each device's own block, which it marks as
standing for every device's block (:func:`alike`), so that the analysis
counters count global work; :func:`on_scan_blocks` does the same for the
recurrences, and :func:`expert_roles`, :func:`block`, :func:`weight_block`
and :func:`run_blocks` for the MoE block's experts.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

AxisRule = Union[None, str, Tuple[str, ...]]
LogicalRules = Dict[str, AxisRule]

# The baseline ruleset (paper-faithful megatron-style TP + DP):
DEFAULT_RULES: LogicalRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    # Expert stacks shard 2D to fit device memory; when the expert count
    # does not divide TP, expert d_model shards over 'model' (weights stay
    # put; the contraction inserts activation reduces) rather than
    # re-gathering expert weights over 'data' every microbatch.
    "expert_embed": "model",
    "expert_mlp": ("data",),
    "capacity": None,
    "layers": None,
    "ssm_state": None,
    "ssm_heads": "model",
    "conv": None,
    "codebook": None,
    # ANN-index logical axes (device-resident shard probe path)
    "ann_shard": "data",
    "ann_node": None,
    "ann_degree": None,
    "ann_pq_m": None,
    # serving-specific
    "cache_batch": "data",
    "cache_seq": None,
    "cache_heads": "model",
}


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes with no devices or process group: what
    the rules read, for specs and shard shapes without a mesh."""

    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in the mesh's dim order (a ``DeviceMesh``'s
    ``.shape`` is a tuple, the reference's ``mesh.shape`` a dict)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh_axis_names(mesh), tuple(mesh.shape)))


def mesh_size(mesh) -> int:
    n = 1
    for s in mesh_shape(mesh).values():
        n *= s
    return n


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, a mesh-axis name, or a tuple of
    mesh-axis names (the reference's ``jax.sharding.PartitionSpec``
    entries)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def resolve_rule(rule: AxisRule, mesh_axes: Sequence[str]) -> AxisRule:
    """Drop mesh axes not present in the current mesh."""
    if rule is None:
        return None
    if isinstance(rule, str):
        return rule if rule in mesh_axes else None
    kept = tuple(a for a in rule if a in mesh_axes)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def _axis_size(mesh, rule: AxisRule) -> int:
    if rule is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(rule, str):
        return shape[rule]
    size = 1
    for a in rule:
        size *= shape[a]
    return size


def spec_for(
    logical_axes: Sequence[Optional[str]],
    rules: LogicalRules,
    mesh,
    *,
    dim_sizes: Optional[Sequence[int]] = None,
    strict: bool = False,
) -> PartitionSpec:
    """The spec of one tensor from its logical axis names."""
    mesh_axes = list(mesh_axis_names(mesh))
    used: set = set()
    entries = []
    for i, name in enumerate(logical_axes):
        rule = resolve_rule(rules.get(name) if name else None, mesh_axes)
        # each mesh axis may appear at most once in a spec; drop the
        # already-used axes from a tuple rule rather than the whole rule
        if rule is not None:
            flat = (rule,) if isinstance(rule, str) else rule
            kept = tuple(a for a in flat if a not in used)
            rule = None if not kept else (kept[0] if len(kept) == 1 else kept)
        # divisibility check BEFORE marking axes used: a dropped rule must
        # not block later dims from taking the axis (e.g. mixtral's 8
        # experts can't take 'model'; the per-expert ff dim then can)
        if rule is not None and dim_sizes is not None:
            if dim_sizes[i] % _axis_size(mesh, rule) != 0:
                if strict:
                    raise ValueError(
                        f"dim {i} (logical {name!r}, size {dim_sizes[i]}) not divisible "
                        f"by mesh extent {_axis_size(mesh, rule)} of rule {rule!r}"
                    )
                # retry with a prefix of the tuple rule (partial sharding)
                if not isinstance(rule, str):
                    rule = next(
                        (
                            r
                            for r in (rule[:k] for k in range(len(rule) - 1, 0, -1))
                            if dim_sizes[i] % _axis_size(mesh, r if len(r) > 1 else r[0]) == 0
                        ),
                        None,
                    )
                    if rule is not None and len(rule) == 1:
                        rule = rule[0]
                else:
                    rule = None
        if rule is not None:
            flat = (rule,) if isinstance(rule, str) else rule
            used.update(flat)
        entries.append(rule)
    # trim trailing Nones for tidier specs
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def placements_for(spec: Sequence[AxisRule], mesh) -> tuple:
    """DTensor placements, one per mesh dim, of ``spec``: ``Shard(i)`` on
    every mesh dim of more than one device that entry ``i`` names,
    ``Replicate()`` elsewhere (a split one way is the whole: on a one-rank
    mesh every placement is ``Replicate()``).  Raises when a tuple entry
    lists mesh axes out of the mesh's dim order, which DTensor cannot
    express."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    sizes = mesh_shape(mesh)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(
                f"spec entry {entry!r} shards dim {i} over mesh axes out of the mesh's "
                f"order {names}; DTensor shards a dim over mesh dims major to minor"
            )
        for j in dims:
            if sizes[names[j]] > 1:
                out[j] = Shard(i)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's counterpart of ``jax.sharding.
    NamedSharding``, with its DTensor placements."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's block of ``global_shape`` (each sharded dim divided
        by its mesh extent; ceil, as DTensor chunks an uneven dim)."""
        out = list(global_shape)
        for i, entry in enumerate(self.spec):
            n = _axis_size(self.mesh, entry)
            out[i] = -(-out[i] // n)
        return tuple(out)


def _map_axes(fn, axes_tree, shapes_tree=None):
    """``fn(axes, shaped)`` over an axes tree whose leaves are tuples (or
    ``None``), with an optional parallel tree of shaped leaves."""
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, None if shapes_tree is None else shapes_tree[k])
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [_map_axes(fn, v, None if shapes_tree is None else shapes_tree[i])
                for i, v in enumerate(axes_tree)]
    return fn(axes_tree, shapes_tree)


def logical_to_sharding(axes_tree, rules: LogicalRules, mesh, *, shapes_tree=None):
    """Map a tree of logical-axes tuples to a tree of :class:`NamedSharding`.

    ``axes_tree`` leaves are tuples like ``("vocab", "embed")``; if
    ``shapes_tree`` is given (same structure, leaves with ``.shape``),
    divisibility is checked and non-dividing rules fall back to replication.
    """

    def one(axes, shaped):
        sizes = None if shaped is None else tuple(shaped.shape)
        return NamedSharding(mesh, spec_for(axes or (), rules, mesh, dim_sizes=sizes))

    return _map_axes(one, axes_tree, shapes_tree)


def with_rules(base: LogicalRules, **overrides: AxisRule) -> LogicalRules:
    out = dict(base)
    out.update(overrides)
    return out


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


@contextmanager
def implicit_replication():
    """Plain tensors meeting DTensors in an op count as replicated (the
    masks, positions and constants a model makes inside its step)."""
    from torch.distributed.tensor.experimental import implicit_replication as _ir

    with _ir():
        yield


def splittable(x: torch.Tensor, dim: int, lead: int) -> torch.Tensor:
    """``x`` ready for a view that splits ``dim`` into ``(lead, rest)``: a
    DTensor split on ``dim`` over more devices than divide ``lead`` is first
    replicated on that dim (DTensor refuses an uneven split; the reference's
    partitioner re-lays it out the same way).  Plain tensors pass through."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x):
        return x
    dim = dim % x.ndim
    n = 1
    for j, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            n *= x.device_mesh.size(j)
    if lead % n == 0:
        return x
    placements = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in x.placements]
    return x.redistribute(x.device_mesh, placements)


def split_only(x: torch.Tensor, dims) -> torch.Tensor:
    """A DTensor split on ``dims`` at most: a split of any other dim, or a
    pending sum, is gathered first.  Plain tensors pass through."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    keep = {d % x.ndim for d in dims}
    want = tuple(p if isinstance(p, Shard) and p.dim in keep else Replicate() for p in x.placements)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def _split_only_placements(x, keep) -> tuple:
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim in keep else Replicate() for p in x.placements)


class _Pinned(torch.autograd.Function):
    """``x`` in ``want`` on the way forward and its gradient in ``want`` on
    the way back."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x) if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        if g is not None and tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def pinned(x: torch.Tensor, dims=(0,)) -> torch.Tensor:
    """``x`` split on ``dims`` at most, and so is its gradient: the layout of
    the residual stream at a block's edges (batch over the data axes, whole
    on ``model``), as the reference's partitioner keeps it.  A pending sum
    (a row-split projection's output) is reduced here, both ways, by one
    all-reduce; left to DTensor, a residual add reduce-scatters it over the
    features and every op after it moves the activations again.  Plain
    tensors, tensors on a one-rank mesh (every placement ``Replicate()``)
    and DTensors already so laid out that need no gradient pass through
    unchanged."""
    if not is_dtensor(x) or x.device_mesh.size() == 1:
        return x
    want = _split_only_placements(x, {d % x.ndim for d in dims})
    if tuple(x.placements) == want and not x.requires_grad:
        return x
    return _Pinned.apply(x, want)


def _block_start(size: int, mesh, placements, dim: int) -> Tuple[int, int]:
    """(first index, length) of this rank's block of a dim of ``size``
    split by ``placements`` (major to minor, as :func:`local_block` cuts
    it)."""
    from torch.distributed.tensor import Shard

    coords = mesh.get_coordinate() or [0] * len(placements)
    start, length = 0, size
    for j, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim and mesh.size(j) > 1:
            c = -(-length // mesh.size(j))
            start += coords[j] * c
            length = max(0, min(c, length - coords[j] * c))
    return start, length


class _VocabRows(torch.autograd.Function):
    """Rows of a vocabulary-split table: each rank gathers the ids its block
    holds, zeroes the others, and one all-reduce over the vocabulary's mesh
    dims sums the partial rows; the gradient goes back to each rank's own
    block (no collective: the output's gradient is made whole first)."""

    @staticmethod
    def forward(ctx, table, ids, vocab_dims, dtype):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh, vdim = table.device_mesh, table.ndim - 2
        if is_dtensor(ids):
            ids = ids.redistribute(mesh, tuple(
                Replicate() if j in vocab_dims else p for j, p in enumerate(ids.placements)))
            lead = tuple(p if isinstance(p, Shard) else Replicate() for p in ids.placements)
            ids_local = ids.to_local()
        else:
            lead, ids_local = (Replicate(),) * mesh.ndim, ids
        local = table.to_local()
        start, n = _block_start(table.shape[vdim], mesh, table.placements, vdim)
        lid = ids_local - start
        miss = (lid < 0) | (lid >= n)
        lid = torch.where(miss, 0, lid)
        if table.ndim == 2:
            rows = torch.where(miss[..., None], 0, local[lid].to(dtype))
        else:  # codebooks (CB, V, D), ids (..., CB): the streams' rows summed
            rows = None
            for cb in range(table.shape[0]):
                r = torch.where(miss[..., cb, None], 0, local[cb][lid[..., cb]].to(dtype))
                rows = r if rows is None else rows + r
        ctx.save_for_backward(lid, miss)
        ctx.table_meta = (mesh, table.placements, table.shape, table.stride(), local.shape, local.dtype)
        gshape = (ids.shape[:-1] if table.ndim == 3 else ids.shape) + (table.shape[-1],)
        partial = tuple(Partial() if j in vocab_dims else p for j, p in enumerate(lead))
        out = DTensor.from_local(rows, mesh, partial,
                                 run_check=False, shape=torch.Size(gshape),
                                 stride=torch.empty(gshape, device="meta").stride())
        ctx.out_placements = lead
        return out.redistribute(mesh, lead)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        lid, miss = ctx.saved_tensors
        mesh, placements, shape, stride, local_shape, dtype = ctx.table_meta
        if tuple(g.placements) != ctx.out_placements:
            g = g.redistribute(mesh, ctx.out_placements)
        gl = g.to_local().to(dtype)
        grad = torch.zeros(local_shape, dtype=dtype, device=gl.device)
        if len(shape) == 2:
            grad.index_put_((lid,), torch.where(miss[..., None], 0, gl), accumulate=True)
        else:
            for cb in range(shape[0]):
                grad[cb].index_put_((lid[..., cb],), torch.where(miss[..., cb, None], 0, gl),
                                    accumulate=True)
        # the table's blocks as they were; a mesh dim that split the ids
        # (the batch) and not the table leaves each rank a pending sum
        gp = tuple(
            p if isinstance(p, Shard) else Partial() if isinstance(q, Shard) else Replicate()
            for p, q in zip(placements, ctx.out_placements))
        return DTensor.from_local(grad, mesh, gp, run_check=False, shape=shape, stride=stride), \
            None, None, None


def vocab_split(table: torch.Tensor) -> tuple:
    """The mesh dims (of more than one device) that split ``table``'s
    vocabulary dim (its second to last), or ``()`` (a plain tensor, or a
    table whole on every rank)."""
    if not is_dtensor(table):
        return ()
    from torch.distributed.tensor import Shard

    vdim = table.ndim - 2
    return tuple(j for j, p in enumerate(table.placements)
                 if isinstance(p, Shard) and p.dim == vdim and table.device_mesh.size(j) > 1)


def vocab_rows(table: torch.Tensor, ids: torch.Tensor, dtype=None) -> torch.Tensor:
    """``table[ids]`` (in ``dtype``) for a DTensor table (V, D), or (CB, V,
    D) with ids (..., CB) summed over the codebooks, whose vocabulary dim
    is split (:func:`vocab_split`): the vocabulary-parallel lookup, one
    all-reduce of the rows where indexing the DTensor would all-gather the
    whole table to every rank.  Other splits of the table are gathered
    first."""
    dims = vocab_split(table)
    if not dims:
        raise ValueError("vocab_rows wants a table split over its vocabulary dim")
    table = split_only(table, (table.ndim - 2,))
    return _VocabRows.apply(table, ids, dims, dtype or table.dtype)


def placed_like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` in ``x``'s placements when both are DTensors (the layout an
    input had before a re-layout; the backward takes the gradient back to
    ``y``'s), else ``y``."""
    if not (is_dtensor(y) and is_dtensor(x)):
        return y
    from torch.distributed.tensor import Replicate

    # a pending sum is not a layout to return to: it was reduced on the way
    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return y if tuple(y.placements) == want else y.redistribute(x.device_mesh, want)


def block_layout(q, k, v) -> tuple:
    """The placements under which attention over DTensors ``q`` (B, Sq, H,
    hd) and ``k``, ``v`` (B, S, KV, hd) runs on each device's own block: on
    each mesh dim, the split all three share if it is of the batch dim (0)
    or, evenly for H and KV, of the head dim (2) (each device's query heads
    then sit with their KV heads: H / n = G · KV / n), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    out, split = [], {0: 1, 2: 1}
    for j, ps in enumerate(zip(q.placements, k.placements, v.placements)):
        d = ps[0].dim if isinstance(ps[0], Shard) else None
        if d in split and all(isinstance(p, Shard) and p.dim == d for p in ps):
            m = split[d] * mesh.size(j)
            if all(t.shape[d] % m == 0 for t in (q, k, v)):
                split[d] = m
                out.append(Shard(d))
                continue
        out.append(Replicate())
    return tuple(out)


# per thread: the factors of the enclosing ``alike`` contexts
_ALIKE = threading.local()


@contextmanager
def alike(n: float):
    """Inside, every op dispatched stands for ``n`` alike ops: one device's
    attention block for the ``n`` devices' blocks (:func:`on_blocks`), or a
    dry-run's one traced trip for a loop's ``n`` trips.  Nests
    multiplicatively.  Nothing runs ``n`` times: only the analysis counters
    read the factor (:func:`alike_factor`)."""
    stack = _ALIKE.__dict__.setdefault("stack", [1.0])
    stack.append(stack[-1] * n)
    try:
        yield
    finally:
        stack.pop()


def alike_factor() -> float:
    """The product of the enclosing :func:`alike` factors (1 outside)."""
    stack = getattr(_ALIKE, "stack", None)
    return stack[-1] if stack else 1.0


def _keep(t):
    return t


class _Blocks(torch.autograd.Function):
    """``fn`` on one device's local blocks (one output or a tuple), its
    forward and its backward each standing for ``n`` alike blocks
    (:func:`alike`)."""

    @staticmethod
    def forward(ctx, fn, n, *xs):
        # the blocks' own graph keeps what it saves: an enclosing
        # checkpoint's hooks would recompute the whole region inside this
        # backward (and count it n times)
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            ctx.inputs = [x.detach().requires_grad_(x.requires_grad) for x in xs]
            with alike(n):
                out = fn(*ctx.inputs)
        ctx.single = torch.is_tensor(out)
        ctx.out = (out,) if ctx.single else tuple(out)
        ctx.n = n
        # an output nothing reads (a scan's last carry) gets no backward
        ctx.set_materialize_grads(False)
        outs = tuple(o.detach() for o in ctx.out)
        return outs[0] if ctx.single else outs

    @staticmethod
    def backward(ctx, *grads):
        want = [x for x in ctx.inputs if x.requires_grad]
        pairs = [(o, g) for o, g in zip(ctx.out, grads) if g is not None and o.requires_grad]
        got = iter([None] * len(want))
        if pairs:
            with alike(ctx.n):
                got = iter(torch.autograd.grad([o for o, _ in pairs], want, [g for _, g in pairs],
                                               allow_unused=True))
        return (None, None) + tuple(next(got) if x.requires_grad else None for x in ctx.inputs)


def on_blocks(fn, q, k, v, *extra):
    """The attention ``fn(q, k, v, *extra)`` of DTensors run as the
    reference's partitioner runs it: each device attends its own (batch,
    head) block of local tensors, no collective inside (``shard_map``'s
    counterpart; it also spares DTensor a view that merges two split dims,
    which torch 2.11 refuses).  q, k and v are first laid out by
    :func:`block_layout` and ``extra`` replicated; the output comes back in
    ``q``'s placements.  The blocks' ops stand for every distinct block's
    (:func:`alike`)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh, layout = q.device_mesh, block_layout(q, k, v)
    n = math.prod(mesh.size(j) for j, p in enumerate(layout) if not p.is_replicate())
    whole = (Replicate(),) * mesh.ndim
    ql, kl, vl = (t.redistribute(mesh, layout).to_local() for t in (q, k, v))
    ex = [e.redistribute(mesh, whole).to_local() if is_dtensor(e) else e for e in extra]
    out = run_blocks(lambda a, b, c: fn(a, b, c, *ex), n, ql, kl, vl)
    out = DTensor.from_local(out, mesh, layout, run_check=False, shape=q.shape,
                             stride=torch.empty(q.shape, device="meta").stride())
    return placed_like(out, q)


def _scan_layout(lead, dims) -> tuple:
    """On each mesh dim: ``"batch"`` where DTensor ``lead`` is split on its
    batch dim, ``"heads"`` where on its head dim, else ``None``, each kept
    only while every tensor of ``dims`` ((shape, batch dim, head dim)
    triples) still splits evenly."""
    from torch.distributed.tensor import Shard

    mesh, ways = lead.device_mesh, {"batch": 1, "heads": 1}
    lb, lh = dims[0][1], dims[0][2]
    roles = []
    for j, p in enumerate(lead.placements):
        role = None
        if isinstance(p, Shard) and mesh.size(j) > 1 and p.dim in (lb, lh):
            role = "batch" if p.dim == lb else "heads"
            m = ways[role] * mesh.size(j)
            pick = 1 if role == "batch" else 2
            if all(d[pick] is None or d[0][d[pick]] % m == 0 for d in dims):
                ways[role] = m
            else:
                role = None
        roles.append(role)
    return tuple(roles)


def _role_placements(roles, batch_dim, head_dim, grad: bool = False) -> tuple:
    """A tensor's placements under ``roles``; with ``grad``, its gradient's
    from one block: a pending sum on a mesh dim whose role the tensor lacks
    (each device's batch rows add to a parameter's gradient; each device's
    heads to that of a tensor all heads read)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    dim = {"batch": batch_dim, "heads": head_dim}
    return tuple(Replicate() if r is None else Shard(dim[r]) if dim[r] is not None
                 else Partial() if grad else Replicate() for r in roles)


def on_scan_blocks(fn, args, dims, out_dims):
    """``fn(*args)``, a recurrence independent per (batch, head), run as the
    reference's partitioner runs it: each device scans its own (batch, head)
    block of local tensors, no collective inside and none of DTensor's
    dispatch on each step.  ``dims[i]`` is ``(batch dim, head dim)`` of
    ``args[i]`` (``None`` where it has none), ``out_dims`` the same for each
    output of ``fn`` (a tuple).  The blocks follow ``args[0]``: a mesh dim
    that splits its batch splits every tensor's batch, one that splits its
    heads evenly for every tensor splits every tensor's heads, and the rest
    are replicated (a head count that does not divide the mesh dim, as the
    reference's rules replicate it).  Plain tensors are the whole, cut to
    each rank's block with no collective.  The blocks' ops stand for every
    distinct block's (:func:`alike`).  Without a DTensor in ``args[0]``, or
    on a one-rank mesh, ``fn`` runs on ``args`` as they are."""
    lead = args[0]
    if not is_dtensor(lead) or lead.device_mesh.size() == 1:
        return fn(*args)
    mesh = lead.device_mesh
    roles = _scan_layout(lead, [(a.shape,) + tuple(d) for a, d in zip(args, dims)])
    n = math.prod(mesh.size(j) for j, r in enumerate(roles) if r is not None)
    local = []
    for a, (bd, hd) in zip(args, dims):
        want = _role_placements(roles, bd, hd)
        local.append(a.redistribute(mesh, want).to_local(
            grad_placements=_role_placements(roles, bd, hd, grad=True)) if is_dtensor(a)
            else local_block(a, mesh, want))
    outs = run_blocks(fn, n, *local)
    return tuple(_from_block(o, mesh, _role_placements(roles, bd, hd)) for o, (bd, hd) in zip(outs, out_dims))


SUM = "sum"  # a role's entry in :func:`role_placements`: a pending sum on that mesh dim


def role_placements(roles, dims: dict) -> tuple:
    """Placements under ``roles`` (one role name or ``None`` per mesh dim):
    ``Shard(dims[role])``, ``Partial()`` where ``dims[role]`` is
    :data:`SUM`, ``Replicate()`` where the role is absent from ``dims``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    out = []
    for r in roles:
        d = dims.get(r) if r is not None else None
        out.append(Replicate() if d is None else Partial() if d == SUM else Shard(d))
    return tuple(out)


def expert_roles(xg: torch.Tensor, wo: torch.Tensor) -> tuple:
    """On each mesh dim of the dispatched tokens ``xg`` (G, S, D) and an
    expert stack ``wo`` (E, F, D): ``"batch"`` where the dim splits the
    token groups (evenly, major to minor), else where it splits ``wo``,
    ``"expert"`` (E), ``"ff"`` (F) or ``"embed"`` (D), else ``None``: the
    layout in which ``moe._experts_on_blocks`` runs each device's block."""
    from torch.distributed.tensor import Shard

    mesh, ways, roles = xg.device_mesh, 1, []
    for j, (p, q) in enumerate(zip(xg.placements, wo.placements)):
        if mesh.size(j) == 1:
            roles.append(None)
        elif type(p) is Shard and p.dim == 0 and xg.shape[0] % (ways * mesh.size(j)) == 0:
            ways *= mesh.size(j)
            roles.append("batch")
        elif type(q) is Shard:
            roles.append(("expert", "ff", "embed")[q.dim])
        else:
            roles.append(None)
    return tuple(roles)


class _Gathered(torch.autograd.Function):
    """DTensor ``w`` in ``dtype`` and placements ``want``; the gradient goes
    back in ``w``'s dtype and placements (a pending sum reduced there, in
    that dtype)."""

    @staticmethod
    def forward(ctx, w, want, dtype):
        ctx.have, ctx.dtype = tuple(w.placements), w.dtype
        x = w.to(dtype)
        return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.dtype)
        return (g if tuple(g.placements) == ctx.have else g.redistribute(g.device_mesh, ctx.have)), \
            None, None


def gathered(w: torch.Tensor, dims, dtype) -> torch.Tensor:
    """DTensor ``w`` cast to ``dtype`` and whole on the mesh dims ``dims``
    (gathered there; its other splits kept); the gradient is cast back
    before its pending sums are reduced into ``w``'s blocks, so that they
    add in ``w``'s dtype.  ``w`` itself where nothing changes."""
    from torch.distributed.tensor import Replicate

    want = tuple(Replicate() if j in dims else p for j, p in enumerate(w.placements))
    if w.dtype == dtype and tuple(w.placements) == want:
        return w
    return _Gathered.apply(w, want, dtype)


def _all_to_all(x: torch.Tensor, src: int, dst: int, mesh, j: int) -> torch.Tensor:
    """``x``, a block split on dim ``src`` over mesh dim ``j``, re-split on
    dim ``dst`` instead: each rank sends the i-th slice of ``dst`` to rank i
    (one all-to-all) and joins what it receives along ``src``."""
    from torch.distributed import _functional_collectives as funcol

    n = mesh.size(j)
    send = torch.stack(x.chunk(n, dim=dst))
    got = funcol.all_to_all_single(send, None, None, (mesh, j))
    got = funcol.wait_tensor(got) if isinstance(got, funcol.AsyncCollectiveTensor) else got
    return torch.cat(got.unbind(0), dim=src)


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all` of a local block, its gradient the reverse move."""

    @staticmethod
    def forward(ctx, x, src, dst, mesh, j):
        ctx.args = (src, dst, mesh, j)
        return _all_to_all(x, src, dst, mesh, j)

    @staticmethod
    def backward(ctx, g):
        src, dst, mesh, j = ctx.args
        return _all_to_all(g, dst, src, mesh, j), None, None, None, None


def weight_block(w: torch.Tensor, roles, dims: dict, dtype) -> torch.Tensor:
    """This rank's block of the DTensor weight ``w`` in ``dtype``, split as
    ``dims`` maps ``roles`` and whole on every other mesh dim (gathered by
    :func:`gathered`; a split that moves to another tensor dim on one mesh
    dim by one all-to-all, which DTensor would issue as a gather on a CPU
    group), as a plain tensor.  Its gradient is a pending sum on the mesh
    dims that split the tokens (``"batch"``), reduced into ``w``'s blocks
    by whichever gathered it."""
    want = role_placements(roles, dims)
    have = tuple(w.placements)
    moves = [j for j, (a, b) in enumerate(zip(have, want)) if a.is_shard() and b.is_shard() and a.dim != b.dim]
    keep = tuple(have[j] if j in moves else want[j] for j in range(len(want)))
    w = gathered(w, [j for j in range(len(want)) if keep[j].is_replicate() and have[j].is_shard()], dtype)
    grad = role_placements(roles, {**dims, "batch": SUM})
    local = w.to_local(grad_placements=tuple(have[j] if j in moves else grad[j] for j in range(len(want))))
    for j in moves:
        local = _AllToAll.apply(local, have[j].dim, want[j].dim, w.device_mesh, j)
    return local


def block(x: torch.Tensor, roles, dims: dict, grad: Optional[dict] = None) -> torch.Tensor:
    """This rank's block of DTensor ``x`` laid out by ``dims`` under
    ``roles`` (:func:`role_placements`), as a plain tensor whose gradient
    is read in the placements of ``dims`` updated by ``grad`` (a pending
    sum where each block adds to the whole's gradient)."""
    want = role_placements(roles, dims)
    x = x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)
    return x.to_local(grad_placements=role_placements(roles, {**dims, **(grad or {})}))


def _from_block(local: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The DTensor in ``placements`` whose block on this rank is ``local``
    (every block of a split dim as long)."""
    from torch.distributed.tensor import DTensor

    shape = list(local.shape)
    for j, p in enumerate(placements):
        if p.is_shard():
            shape[p.dim] *= mesh.size(j)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def unblock(local: torch.Tensor, mesh, roles, dims: dict) -> torch.Tensor:
    """The DTensor whose block on this rank is ``local``, laid out by
    ``dims`` under ``roles``."""
    return _from_block(local, mesh, role_placements(roles, dims))


def run_blocks(fn, n: int, *xs):
    """``fn(*xs)`` on local blocks, its ops (forward and backward) standing
    for ``n`` alike blocks (:func:`alike`)."""
    if n > 1 and torch.is_grad_enabled() and any(t.requires_grad for t in xs):
        return _Blocks.apply(fn, n, *xs)
    with alike(n):
        return fn(*xs)


def place(tensor: torch.Tensor, sharding: NamedSharding):
    """``tensor`` as a DTensor in ``sharding``: a DTensor already there is
    returned as is, another is redistributed; a plain tensor (the whole, the
    same on every rank) becomes each rank's block of it, nothing sent."""
    from torch.distributed.tensor import DTensor

    placements = sharding.placements
    if isinstance(tensor, DTensor):
        if tensor.device_mesh == sharding.mesh and tuple(tensor.placements) == placements:
            return tensor
        return tensor.redistribute(sharding.mesh, placements)
    local = local_block(tensor, sharding.mesh, placements)
    return DTensor.from_local(local, sharding.mesh, placements, run_check=False,
                              shape=tensor.shape, stride=tensor.stride())


def local_block(tensor: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the whole ``tensor`` under ``placements`` (the
    tensor itself where nothing splits it)."""
    from torch.distributed.tensor import Shard

    local = tensor
    coords = mesh.get_coordinate() or [0] * len(placements)
    # a dim split over several mesh dims is split major to minor
    for j, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(j)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(tensor.shape)} does not split "
                                 f"{n} ways ({tuple(placements)})")
            if n > 1:
                local = local.chunk(n, dim=p.dim)[coords[j]].contiguous()
    return local


def place_tree(tree, shardings):
    """Every tensor of ``tree`` placed by the parallel tree of shardings."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a NamedTuple (AdamWState)
        return type(tree)(*(place_tree(v, s) for v, s in zip(tree, shardings)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, s) for v, s in zip(tree, shardings))
    return place(tree, shardings)


def local_tree(tree):
    """Each DTensor of ``tree`` replaced by its local block."""
    if isinstance(tree, dict):
        return {k: local_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(local_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_tree(v) for v in tree)
    return tree.to_local() if is_dtensor(tree) else tree
