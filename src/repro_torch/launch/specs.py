"""Per-cell dry-run specs: step functions + shape-only inputs on a mesh.

Port of ``repro/launch/specs.py``.  ``build_cell(arch, shape, mesh, rules)``
returns a :class:`CellSpec` whose ``lower()`` traces the cell's step:

- train_4k     → ``train_step``   (CE + AdamW, microbatched, remat)
- prefill_32k  → ``prefill_step``
- decode_32k / long_500k → ``serve_step`` (one token, full KV/state cache)

plus the analytic MODEL_FLOPS / traffic model used by the roofline (the
reference's arithmetic).  Every input is a ``meta`` tensor, placed on the
mesh as a DTensor by the step itself, so nothing is allocated; the mesh is
usually a fake group's (``launch.mesh.init_fake_world``).

``lower()`` is the port's counterpart of ``jit(...).lower()``: it runs the
step under the FLOP counter and the collective counter.  The step's Python
loop over layers unrolls, so the trace grows with depth; every layer of a
family is the same code on the same shapes, so ``lower()`` traces the
model at two depths a group of layers apart and extends the difference to
the full depth (for zamba2, a group is ``shared_attn_every`` mamba layers
and the shared block after them, with the leftover layers in both traces),
as the reference's jaxpr holds the layer scan's body once times its
length.  Inside a layer, attention's block loop unrolls too (2,048 block
pairs a layer at 32k); :func:`folded_attention` traces it as two one-block
calls with the same counts, and :func:`folded_scans` the recurrent
families' chunk loops (up to 1,024 chunks a layer) as runs of two and
three chunks.  A train step's microbatch loop is traced over one and two
microbatches (:func:`_run_counted`).
"""

from __future__ import annotations

import dataclasses
import inspect
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.flops import FlopCount, FlopCounter
from repro_torch.analysis.hlo import CollectiveCounter, CollectiveStats
from repro_torch.configs.base import ModelConfig, ShapeConfig, SHAPES, get_config
from repro_torch.models import layers
from repro_torch.models.model import Model, build_model, cache_shapes, param_shapes
from repro_torch.models.sharding import (
    DEFAULT_RULES, LogicalRules, alike, is_dtensor, mesh_shape, with_rules,
)
from repro_torch.serving.serve_loop import ServeConfig, make_serve_fns
from repro_torch.training.optimizer import AdamWState, tree_leaves, tree_map
from repro_torch.training.train_loop import TrainStepConfig, make_train_step

SERVE_RULES = with_rules(
    DEFAULT_RULES,
    batch=("pod", "data"),
    cache_batch=("pod", "data"),
)

META = torch.device("meta")


def _abstract(tree, dtype=None):
    """``meta`` tensors of ``tree``'s shapes (and dtypes, or ``dtype``)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=dtype or t.dtype, device=META), tree)


def _bytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


def _local_bytes(tree) -> float:
    """Bytes one device holds of ``tree`` (a DTensor's local block)."""
    total = 0.0
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        loc = t.to_local() if hasattr(t, "to_local") else t
        total += loc.numel() * loc.element_size()
    return total


@dataclass
class Lowered:
    """What ``CellSpec.lower()`` traced, extended to the full depth."""

    flops: FlopCount
    collectives: CollectiveStats
    depths: Tuple[int, ...]
    argument_bytes: float
    output_bytes: float
    alias_bytes: float


@dataclass
class CellSpec:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    model: Model
    kind: str
    fn: Optional[Callable]  # the step at the full depth
    args: Tuple  # its shape-only inputs
    model_flops: float
    model_bytes: float
    skip_reason: Optional[str] = None
    mesh: object = None
    rules: Optional[LogicalRules] = None
    # depth -> (step, args): the same cell at another layer count (a
    # train cell's also takes a microbatch count: the step over that many
    # of its microbatches)
    at_depth: Optional[Callable] = field(default=None, repr=False)
    microbatches: int = 1

    def lower(self) -> Lowered:
        return _trace(self)


def _active_params(cfg: ModelConfig, model: Model) -> Tuple[float, float]:
    """(total_params, active_non_embedding_params)."""
    total = 0.0
    active = 0.0

    def walk(tree, path):
        nonlocal total, active
        for k, v in tree.items():
            keys = f"{path}/{k}"
            if isinstance(v, dict):
                walk(v, keys)
                continue
            n = float(np.prod(v.shape))
            total += n
            if "embed" in keys or "lm_head" in keys:
                continue
            if "moe" in keys and "router" not in keys:
                n = n * cfg.top_k / max(cfg.num_experts, 1)
            active += n

    walk(param_shapes(model), "")
    return total, active


def _attn_flops_train(cfg: ModelConfig, B: int, S: int, kv_eff: int) -> float:
    if cfg.attention == "none":
        return 0.0
    # qk^T and a·v, causal → /2; fwd+bwd ≈ 3×fwd
    window = cfg.window if cfg.attention == "swa" else S
    eff = min(window, S)
    per_layer = 2.0 * B * S * eff * cfg.num_heads * cfg.head_dim * 2 / 2
    n_attn_layers = cfg.num_layers if not cfg.shared_attn_every else cfg.num_layers // cfg.shared_attn_every
    return 3.0 * per_layer * n_attn_layers


def _attn_flops_decode(cfg: ModelConfig, B: int, S_ctx: int) -> float:
    if cfg.attention == "none":
        return 0.0
    window = cfg.window if cfg.attention == "swa" else S_ctx
    eff = min(window, S_ctx)
    n_attn_layers = cfg.num_layers if not cfg.shared_attn_every else cfg.num_layers // cfg.shared_attn_every
    return 2.0 * B * eff * cfg.num_heads * cfg.head_dim * 2 * n_attn_layers


def _cache_bytes(model: Model, B: int, max_len: int) -> float:
    return _bytes(cache_shapes(model, B, max_len))


def trace_depths(cfg: ModelConfig) -> Tuple[int, ...]:
    """The layer counts ``lower()`` traces: a group of layers apart (one
    layer; zamba2's ``shared_attn_every`` mamba layers and the shared block),
    each holding the leftover layers, or the full depth when it is as
    small."""
    k = cfg.shared_attn_every or 1
    r = cfg.num_layers % k
    lo, hi = k + r, 2 * k + r
    return (cfg.num_layers,) if cfg.num_layers <= hi else (lo, hi)


def build_cell(
    arch: str,
    shape_name: str,
    mesh,
    rules: Optional[LogicalRules] = None,
    *,
    microbatches: int = 8,
    remat: bool = True,
    cfg_overrides: Optional[dict] = None,
    train_param_dtype=torch.float32,
) -> CellSpec:
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    tp = mesh_shape(mesh).get("model", 1)
    model = build_model(cfg, tp=tp, device=META)
    total_p, active_p = _active_params(cfg, model)

    if shape.name == "long_500k" and not cfg.subquadratic:
        return CellSpec(
            arch=arch, shape=shape, cfg=cfg, model=model, kind="skip",
            fn=None, args=(), model_flops=0.0, model_bytes=0.0,
            skip_reason="pure full-attention arch: 500k KV cache is quadratic-cost; "
                        "skipped per assignment (DESIGN.md §4)",
        )

    B, S = shape.global_batch, shape.seq_len
    ids_extra = (cfg.num_codebooks,) if cfg.num_codebooks else ()

    if shape.kind == "train":
        rules = rules or DEFAULT_RULES
        tcfg = TrainStepConfig(microbatches=microbatches, remat=remat)

        def at_depth(n: int, micro: int = microbatches):
            m = build_model(dataclasses.replace(cfg, num_layers=n), tp=tp, device=META)
            step, _ = make_train_step(m, mesh, rules, dataclasses.replace(tcfg, microbatches=micro),
                                      device=META)
            pshapes = _abstract(param_shapes(m), train_param_dtype)
            opt = AdamWState(
                m=_abstract(pshapes, torch.float32),
                v=_abstract(pshapes, torch.float32),
                step=torch.empty((), dtype=torch.int32, device=META),
            )
            ids = torch.empty((B // microbatches * micro, S) + ids_extra, dtype=torch.int64,
                              device=META)
            return step, (pshapes, opt, ids, ids)

        # musicgen codebook streams share one backbone position: tokens = B·S
        tokens = B * S
        mf = 6.0 * active_p * tokens + _attn_flops_train(cfg, B, S, model.kv_eff)
        # traffic: params ×3 passes per microbatch (fwd, remat-fwd, bwd)
        # + optimizer m/v read+write + grads
        p_bytes = torch.empty((), dtype=train_param_dtype).element_size()
        mb = (
            microbatches * 3.0 * total_p * p_bytes
            + total_p * (4 * 2 + 4 * 2 + 4 * 2)  # m,v rw + grads rw
            + tokens * cfg.d_model * cfg.num_layers * 4 * 2.0  # layer boundaries
        )
        fn, args = at_depth(cfg.num_layers)
        return CellSpec(arch, shape, cfg, model, "train", fn, args, mf, mb, mesh=mesh,
                        rules=rules, at_depth=at_depth, microbatches=microbatches)

    # serving cells: bf16 params.  Experts stay 1D (model) sharded when the
    # bf16 stack fits device memory that way (mixtral: 5.8 GB/device) — the
    # train-time 2D rule exists for f32 masters + moments and would add
    # FSDP-style gathers to the serve path; dbrx (16.5 GB/device at 1D)
    # keeps 2D out of necessity.
    if rules is None:
        rules = SERVE_RULES
        if cfg.num_experts and total_p * 2.0 / tp < 12e9:
            rules = with_rules(SERVE_RULES, expert_mlp="model")
    kind = "prefill" if shape.kind == "prefill" else "decode"

    def at_depth(n: int):
        m = build_model(dataclasses.replace(cfg, num_layers=n), tp=tp, device=META)
        prefill_fn, decode_fn, _sample, _sh = make_serve_fns(
            m, mesh, rules, ServeConfig(), batch_hint=B, max_len_hint=S, device=META)
        pshapes = _abstract(param_shapes(m), torch.bfloat16)
        cache = cache_shapes(m, B, S)
        if kind == "prefill":
            ids = torch.empty((B, S) + ids_extra, dtype=torch.int64, device=META)
            return prefill_fn, (pshapes, ids, cache)
        ids = torch.empty((B, 1) + ids_extra, dtype=torch.int64, device=META)
        return decode_fn, (pshapes, ids, cache, S - 1)

    if kind == "prefill":
        tokens = B * S
        mf = 2.0 * active_p * tokens + _attn_flops_train(cfg, B, S, model.kv_eff) / 3.0
        mb = total_p * 2.0 + tokens * cfg.d_model * cfg.num_layers * 2 * 2.0 + _cache_bytes(model, B, S)
    else:
        mf = 2.0 * active_p * B + _attn_flops_decode(cfg, B, S)
        # decode traffic: all params once (bf16) + cache read + small writes.
        # MoE dense-dispatch decode really does read every expert — honest.
        mb = total_p * 2.0 + _cache_bytes(model, B, S)
    fn, args = at_depth(cfg.num_layers)
    return CellSpec(arch, shape, cfg, model, kind, fn, args, mf, mb, mesh=mesh, rules=rules,
                    at_depth=at_depth)


def _folded(real, sparse: bool):
    """``real`` (``layers.flash_attention`` or ``flash_attention_sparse``)
    with its block pairs folded on a shape-only ``q`` that records no
    backward (autograd would replay a folded pair's backward once).  Every
    pair runs the same ops on the same shapes, and so does every q block's
    own part (the state and the final divide): a call of ``nq`` q blocks
    and ``P`` pairs counts ``nq·A + P·B``.  ``real`` on one q block against
    one kv block counts ``A + B``, against two ``A + 2B``, so the call
    counts ``(2nq - P)`` of the first plus ``(P - nq)`` of the second.  The
    two calls see their kv blocks in the causal past and inside the window,
    which changes no op: the mask is built the same way whatever it
    holds."""

    defaults = {n: p.default for n, p in inspect.signature(real).parameters.items()
                if p.default is not inspect.Parameter.empty}

    def attention(q, k, v, **kw):
        kw = {**defaults, **kw}
        if is_dtensor(q) or q.device.type != "meta" or (torch.is_grad_enabled() and q.requires_grad):
            return real(q, k, v, **kw)
        q_offset, causal, window = kw["q_offset"], kw["causal"], kw["window"]
        q_chunk, kv_chunk = kw["q_chunk"], kw["kv_chunk"]
        B, Sq, H, hd = q.shape
        _, Skv, KV, _ = k.shape
        qc, kc = min(q_chunk, Sq), min(kv_chunk, Skv)
        assert Sq % qc == 0 and Skv % kc == 0
        nq, nk = Sq // qc, Skv // kc
        pairs = (len(layers.visible_pairs(nq, nk, qc, kc, q_offset, causal, window)) if sparse
                 else nq * nk)
        q1 = q.new_empty((B, qc, H, hd))
        for blocks, n in ((1, 2 * nq - pairs), (2, pairs - nq)):
            if n:
                kv = k.new_empty((B, blocks * kc, KV, hd))
                with alike(n):
                    real(q1, kv, kv.new_empty(kv.shape), q_offset=blocks * kc, causal=causal,
                         window=window and 4 * (qc + kc), q_chunk=qc, kv_chunk=kc)
        return q.new_empty(q.shape)

    return attention


@contextmanager
def folded_attention():
    """Within, ``layers.flash_attention`` and ``flash_attention_sparse``
    fold their block pairs on shape-only inputs (:func:`_folded`): the same
    FLOP and collective counts from two calls of one q block in place of
    thousands of pairs (``tools/dryrun_fold_time.py`` times a cell both
    ways)."""
    real = layers.flash_attention, layers.flash_attention_sparse
    layers.flash_attention = _folded(real[0], sparse=False)
    layers.flash_attention_sparse = _folded(real[1], sparse=True)
    try:
        yield
    finally:
        layers.flash_attention, layers.flash_attention_sparse = real


def _keep(t):
    return t


class _FoldedScan(torch.autograd.Function):
    """A chunked scan of ``nc`` chunks traced as its first two chunks
    (standing for ``3 - nc`` scans) and its first three (standing for ``nc -
    2``), its backward the same two runs' backwards (:func:`_folded_scan`)."""

    @staticmethod
    def forward(ctx, real, n_seq, chunk, nc, *xs):
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(_keep, _keep):
            ctx.inputs = [x.detach().requires_grad_(x.requires_grad) for x in xs]
            ctx.runs = _scan_runs(real, n_seq, chunk, nc, ctx.inputs)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return _scan_outputs(ctx.runs, xs[0].shape[1])

    @staticmethod
    def backward(ctx, g_seq, g_last):
        want = [x for x in ctx.inputs if x.requires_grad]
        got = [None] * len(want)
        for k, w, (o_seq, o_last) in ctx.runs:
            pairs = [(o, g) for o, g in ((o_seq, None if g_seq is None else g_seq[:, :k * ctx.chunk]),
                                         (o_last, g_last)) if g is not None and o.requires_grad]
            if pairs:
                with alike(w):
                    got = torch.autograd.grad([o for o, _ in pairs], want, [g for _, g in pairs],
                                              allow_unused=True)
        got = iter(got)  # the values are shape-only: the last run's stand for the sum
        return (None,) * 4 + tuple(next(got) if x.requires_grad else None for x in ctx.inputs)


def _scan_runs(real, n_seq, chunk, nc, xs):
    """(chunks, factor, outputs) of the two runs: the first ``n_seq`` of
    ``xs`` cut to 2 and 3 chunks along dim 1, the rest whole."""
    runs = []
    for k, w in ((2, 3 - nc), (3, nc - 2)):
        part = [x[:, :k * chunk] if i < n_seq else x for i, x in enumerate(xs)]
        with alike(w):
            runs.append((k, w, real(*part, chunk=chunk)))
    return runs


def _scan_outputs(runs, S):
    o_seq, o_last = runs[-1][2]
    return o_seq.new_empty(o_seq.shape[:1] + (S,) + o_seq.shape[2:]), o_last.detach()


def _folded_scan(real, n_seq: int):
    """``real`` (``rwkv6._wkv_scan`` or ``mamba2._ssd_scan``: ``n_seq``
    sequence inputs (B, S, ...) first, a chunk loop whose every trip runs
    the same ops on the same shapes, and (sequence output, last state)
    out) folded on shape-only inputs.  From two chunks on, a scan of ``k``
    chunks counts ``P + k·T``: P what runs once, the first chunk's and the
    last's own parts included (no gradient into an initial state that
    needs none, none out of a last state nothing reads), T a middle trip,
    forward and backward.  So one of ``nc`` chunks counts ``(3 - nc)``
    scans of two chunks plus ``(nc - 2)`` of three (the first factor is
    negative past three chunks: only the counters read it)."""

    def scan(*xs, chunk):
        S = xs[0].shape[1]
        nc = S // chunk
        if nc <= 3 or any(x.device.type != "meta" or is_dtensor(x) for x in xs):
            return real(*xs, chunk=chunk)
        if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
            return _FoldedScan.apply(real, n_seq, chunk, nc, *xs)
        return _scan_outputs(_scan_runs(real, n_seq, chunk, nc, xs), S)

    return scan


@contextmanager
def folded_scans():
    """Within, the recurrent families' chunked scans (``rwkv6._wkv_scan``,
    ``mamba2._ssd_scan``) fold their chunk loops on shape-only inputs
    (:func:`_folded_scan`): the same FLOP counts from five chunks' trips
    in place of up to 1,024 (rwkv6's prefill_32k, a layer)."""
    from repro_torch.models import mamba2, rwkv6

    real = rwkv6._wkv_scan, mamba2._ssd_scan
    rwkv6._wkv_scan = _folded_scan(real[0], 4)
    mamba2._ssd_scan = _folded_scan(real[1], 4)
    try:
        yield
    finally:
        rwkv6._wkv_scan, mamba2._ssd_scan = real


def _run_counted(cell: CellSpec, depth: int):
    """The cell's step at ``depth`` layers under both counters.  A train
    step of M > 2 microbatches runs every microbatch's ops on the same
    shapes, so it counts ``P + M·T`` (P: the update and what else runs once,
    T: a microbatch); it is traced over one microbatch (standing for ``2 -
    M`` steps) and two (``M - 1``)."""
    M = cell.microbatches
    plan = ((None, 1),) if cell.kind != "train" or M <= 2 else ((1, 2 - M), (2, M - 1))
    with folded_attention(), folded_scans(), CollectiveCounter(cell.mesh) as cc, FlopCounter() as fc:
        for micro, w in plan:
            fn, args = cell.at_depth(depth) if micro is None else cell.at_depth(depth, micro)
            with alike(w):
                out = fn(*args)
    return fc.count, cc.stats, args, out


def _extend(lo, hi, trips: int):
    """``lo + trips * (hi - lo)`` of two counts (numbers or dicts of them)."""
    if isinstance(lo, dict):
        keys = set(lo) | set(hi)
        return {k: _extend(lo.get(k, 0), hi.get(k, 0), trips) for k in keys}
    return lo + trips * (hi - lo)


def _trace(cell: CellSpec) -> Lowered:
    cfg = cell.cfg
    depths = trace_depths(cfg)
    runs = [_run_counted(cell, d) for d in depths]
    if len(runs) == 1:
        flops, coll = runs[0][0], runs[0][1]
    else:
        k = cfg.shared_attn_every or 1
        trips = (cfg.num_layers - depths[0]) // k
        (f_lo, c_lo, _, _), (f_hi, c_hi, _, _) = runs
        flops = FlopCount(_extend(f_lo.dot, f_hi.dot, trips), _extend(f_lo.other, f_hi.other, trips))
        for name, v in _extend(dict(f_lo.by_op), dict(f_hi.by_op), trips).items():
            flops.by_op[name] = v
        coll = CollectiveStats(**{
            f.name: _extend(getattr(c_lo, f.name), getattr(c_hi, f.name), trips)
            for f in dataclasses.fields(CollectiveStats)
        })
    # memory: the full-depth inputs as placed, the outputs' local blocks
    _, _, _, out = runs[-1]
    args = cell.args
    if cell.kind == "train":
        placed = _placed_train_args(cell)
        arg_b = _local_bytes(placed) + _local_bytes(args[2:])
        out_b = _local_bytes(placed)  # params and opt state, updated in place
        alias_b = out_b
    else:
        placed = _placed_serve_args(cell)
        arg_b = _local_bytes(placed)
        logits_b = _local_bytes(out[0])
        out_b = logits_b + _local_bytes(placed[2])
        alias_b = _local_bytes(placed[2]) if cell.kind == "decode" else 0.0
    return Lowered(flops, coll, depths, arg_b, out_b, alias_b)


def _placed_train_args(cell: CellSpec):
    from repro_torch.models.sharding import place_tree

    _, sh = make_train_step(cell.model, cell.mesh, cell.rules, device=META)
    params, opt = cell.args[0], cell.args[1]
    return place_tree(params, sh.params), place_tree(opt, sh.opt)


def _placed_serve_args(cell: CellSpec):
    from repro_torch.models.sharding import place, place_tree

    B, S = cell.shape.global_batch, cell.shape.seq_len
    _, _, _, sh = make_serve_fns(cell.model, cell.mesh, cell.rules, ServeConfig(),
                                 batch_hint=B, max_len_hint=S, device=META)
    params, ids, cache = cell.args[0], cell.args[1], cell.args[2]
    return place_tree(params, sh.params), place(ids, sh.ids), place_tree(cache, sh.cache)
