"""Probe-plan IR: the single module that chooses probe plan ops.

Planning for the tiered probe path used to be smeared across three layers:
the coordinator picked prefilter/mask/postfilter bands from zone-map
selectivity (``MASK_MAX_FRAC`` and friends lived in coordinator.py), the
executor re-derived per-query kernel flavors from measured match counts
(``_plan_flavor`` / ``_pq_pool``), and the kernels imposed their own
dispatch granularity.  Any drift between those layers silently broke the
bit-for-bit parity the multi-mask tests and the ``table2.filtered_hetero``
bench gate assert.  This module turns the control flow into data:

- **Plan ops** — :class:`ExactScan`, :class:`PQScan`, :class:`Beam`,
  :class:`PostfilterBeam`, :class:`MaskedBeam`, :class:`Skip` — are frozen,
  hashable,
  JSON-serializable dataclasses annotated with the selectivity evidence
  (``est_frac``) that justified them.
- **Coordinator planning** (:func:`plan_filtered`, :func:`plan_unfiltered`)
  maps zone-map selectivity estimates (histogram-backed for int ranges) to
  per-(query, shard) ops before dispatch.
- **Executor resolution** (:func:`resolve`) refines a coordinator op once
  the exact predicate match count is known — tiny passing sets collapse to
  an exact scan, PQ scans get their pool pinned — so the executor is a pure
  plan *interpreter* with no thresholds of its own.
- **ProbePlan** bundles the per-(query, shard) op grid into a loggable,
  replayable artifact that rides :class:`~repro_torch.runtime.coordinator.ProbeReport`.

Every selectivity threshold and flavor-classification rule in the probe
path lives HERE and nowhere else; both the mask-plane interpreter and the
retained ``force_group_loop`` baseline call the same :func:`resolve`, so
the two paths cannot drift apart.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# thresholds (the ONLY copies in the repo)
# ---------------------------------------------------------------------------

# Selectivity bands for filtered-probe planning: estimated passing fraction
# at or below PREFILTER_MAX_FRAC gets the pre-filter exact scan, up to
# MASK_MAX_FRAC the mask-aware kernel scan (masked rows lose inside the
# tile), above it the over-fetched post-filter beam.  The mask plan used to
# widen a beam pool by 1/selectivity — worth it only below ~0.5; as a
# single masked kernel call it stays cheaper than post-filter over-fetch up
# to much higher fractions, so the band is wide.
PREFILTER_MAX_FRAC = 0.10
MASK_MAX_FRAC = 0.75

# A query whose predicate passes at most max(SMALL_MATCH_FACTOR * k_eff,
# SMALL_MATCH_FLOOR) rows is cheaper to exact-scan than to search, whatever
# band the coordinator planned — executor-side resolution applies this once
# the true match count is known.
SMALL_MATCH_FACTOR = 4
SMALL_MATCH_FLOOR = 64

# Masked-ADC pool for the PQ mask plan: every passing code row is scored,
# the top pool survivors get the full-precision rerank.
PQ_POOL_FACTOR = 4
PQ_POOL_FLOOR = 32

# An unfiltered query riding a MIXED fragment (some queries filtered, some
# not) may share the fragment's masked-kernel dispatch as an all-ones row —
# but an all-ones row is an O(N·D) exact scan, so only below this shard
# size; larger shards route those queries to a shared beam pass instead.
EXACT_SCAN_MAX_ROWS = 4096

# Masked-beam traversal (big shards): the admitted-candidate target is
# k_eff widened by ~1/est_frac so the traversal converges instead of
# starving at low selectivity, clamped — beam width drives max_iters
# (~1.3*L), so beyond ~4x the widened traversal costs more than the
# exact-masked fallback it is trying to avoid.
MASKED_BEAM_MAX_WIDEN = 4.0

# Post-filter over-fetch: the beam pool is k_eff * clamp(1/est_frac,
# MIN_OVERFETCH, MAX_OVERFETCH).  Band-planned shards only reach the
# postfilter op above MASK_MAX_FRAC, where 1/frac < 1.34 — for them the
# MIN clamp (the historical 2x over-fetch) is the operative size, and the
# histograms' contribution to sizing is the accuracy of est_frac itself
# (band placement; a skew-corrected estimate below the band boundary means
# the shard takes the masked-kernel plan instead).  The MAX headroom
# applies to PostfilterBeam ops built OUTSIDE the band logic —
# hand-authored or replayed plans, future band shifts — and the
# exact-masked fallback bounds recall loss in every case.
POSTFILTER_MIN_OVERFETCH = 2.0
POSTFILTER_MAX_OVERFETCH = 4.0

# Quantized exact scans (ExactScan.dtype of "bf16"/"int8") score with value
# error, so they never emit results directly: the scan's top pool — k_eff
# widened by QUANT_GUARD_FACTOR, floored — feeds the full-precision
# gather-rerank guard, which re-scores the pool at f32 and emits the final
# k_eff.  The widening is what restores recall: a true top-k row demoted a
# few places by quantization noise still lands inside the pool.
QUANT_GUARD_FACTOR = 4
QUANT_GUARD_FLOOR = 32

# Scoring dtypes a plan may annotate on ExactScan (mirrors
# kernels/ref.SCORE_DTYPES; "f32" means no guard stage).
SCAN_DTYPES = ("f32", "bf16", "int8")


def quant_guard_pool(k_eff: int) -> int:
    """Oversampled pool a quantized scan hands the full-precision
    gather-rerank guard."""
    return max(QUANT_GUARD_FLOOR, QUANT_GUARD_FACTOR * max(1, int(k_eff)))


# ---------------------------------------------------------------------------
# plan ops
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanOp:
    """Base class: a per-(query, shard) probe instruction."""

    def to_json(self) -> dict:
        out = {"op": type(self).__name__}
        out.update(asdict(self))
        return out


@dataclass(frozen=True)
class Skip(PlanOp):
    """No work for this (query, shard): zone-pruned before dispatch, or the
    measured match count was zero."""

    reason: str = "zone-pruned"


@dataclass(frozen=True)
class Beam(PlanOp):
    """Ordinary (unfiltered) graph beam search; ``width`` is the requested
    candidate count (k * oversample — the executor's ``_shard_search``
    honors it, capped by live rows; 0 falls back to the task's own
    k * oversample)."""

    width: int = 0


@dataclass(frozen=True)
class ExactScan(PlanOp):
    """Masked exact scan: one masked top-k kernel call ranks exactly the
    rows passing the (predicate AND tombstone) bitmask.  ``k`` is the
    output column count; ``est_frac`` the selectivity evidence (1.0 for the
    all-ones scan of an unfiltered query riding a mixed fragment).

    ``dtype`` annotates the scan's scoring precision (``f32``/``bf16``/
    ``int8``).  Quantized scans are a two-stage plan: the reduced-precision
    kernel ranks a :func:`quant_guard_pool`-sized pool, and the
    full-precision gather-rerank guard re-scores that pool before anything
    leaves the executor — so quantization costs bandwidth, not recall."""

    k: int = 0
    est_frac: float = 1.0
    dtype: str = "f32"


@dataclass(frozen=True)
class PQScan(PlanOp):
    """Masked PQ-ADC scan: one masked ADC kernel call scores every passing
    code row, the top ``pool`` survivors get a full-precision rerank down
    to ``k``."""

    pool: int = 0
    k: int = 0
    est_frac: float = 1.0


@dataclass(frozen=True)
class PostfilterBeam(PlanOp):
    """Most rows pass: over-fetch an ordinary beam to ``pool`` candidates,
    drop the ones failing the predicate, fall back to the masked exact scan
    for queries the beam under-delivered."""

    pool: int = 0
    k: int = 0
    est_frac: float = 1.0


@dataclass(frozen=True)
class MaskedBeam(PlanOp):
    """Predicate-aware graph traversal for a shard too large for even a
    masked linear scan: the beam expands *through* masked nodes — they keep
    their connectivity role in the frontier — but only mask-passing nodes
    are admitted to the result set.  ``width`` is the admitted-candidate
    target (k_eff widened by ~1/est_frac, clamped to
    MASKED_BEAM_MAX_WIDEN·k_eff, so the traversal converges instead of
    starving at low selectivity); the executor falls back to the fused
    exact-masked scan for queries the widened beam still under-delivers."""

    width: int = 0
    k: int = 0
    est_frac: float = 1.0


_OP_TYPES = {
    cls.__name__: cls
    for cls in (Skip, Beam, ExactScan, PQScan, PostfilterBeam, MaskedBeam)
}


def op_from_json(obj: dict) -> PlanOp:
    kind = obj.get("op")
    cls = _OP_TYPES.get(kind)
    if cls is None:
        raise ValueError(f"unknown plan op {kind!r}")
    kwargs = {k: v for k, v in obj.items() if k != "op"}
    return cls(**kwargs)


def op_token(op: PlanOp) -> str:
    """Human summary token for ``ProbeReport.filter_plan`` — kept aligned
    with the historical prefilter/mask/postfilter vocabulary so plan
    strings stay greppable across PRs."""
    if isinstance(op, Skip):
        return "pruned"
    if isinstance(op, Beam):
        return "beam"
    if isinstance(op, PQScan):
        return "mask"
    if isinstance(op, PostfilterBeam):
        return "postfilter"
    if isinstance(op, MaskedBeam):
        return "mbeam"
    # ExactScan: the band it came from is legible from the evidence
    if op.est_frac >= 1.0:
        return "exact"  # all-ones scan (unfiltered row in a mixed fragment)
    if op.est_frac <= PREFILTER_MAX_FRAC:
        return "prefilter"
    return "mask"


# ---------------------------------------------------------------------------
# coordinator-side planning
# ---------------------------------------------------------------------------


def postfilter_pool(k: int, oversample: int, frac: float) -> int:
    """Histogram-fed over-fetch sizing for the postfilter beam (see the
    POSTFILTER_* constants)."""
    k_eff = max(1, k * oversample)
    over = 1.0 / max(frac, 1e-6)
    over = min(max(over, POSTFILTER_MIN_OVERFETCH), POSTFILTER_MAX_OVERFETCH)
    return int(round(k_eff * over))


def masked_beam_width(k: int, oversample: int, frac: float) -> int:
    """Admitted-candidate target for a MaskedBeam: k_eff widened by
    1/est_frac so a low-selectivity traversal still surfaces k_eff passing
    nodes, clamped at MASKED_BEAM_MAX_WIDEN (see the constant's note)."""
    k_eff = max(1, k * oversample)
    widen = min(max(1.0 / max(frac, 1e-6), 1.0), MASKED_BEAM_MAX_WIDEN)
    return int(round(k_eff * widen))


def band_op(
    frac: float,
    *,
    k: int,
    oversample: int,
    use_pq: bool,
    shard_rows: Optional[int] = None,
    scan_dtype: str = "f32",
) -> PlanOp:
    """Map a shard's estimated passing fraction to its plan op.

    ``shard_rows`` is the shard-size evidence (``ShardInfo.vector_count``
    via the routing table): on a shard above EXACT_SCAN_MAX_ROWS every
    masked linear scan — prefilter or mask band — is the O(N·D) row the
    size cap exists to forbid, so selective predicates take the
    predicate-aware :class:`MaskedBeam` traversal instead.  Callers without
    size evidence (hand-built tasks, :func:`default_filtered_op`) omit it
    and keep the scan bands."""
    assert scan_dtype in SCAN_DTYPES, scan_dtype
    k_eff = max(1, k * oversample)
    big = shard_rows is not None and shard_rows > EXACT_SCAN_MAX_ROWS
    if big and frac <= MASK_MAX_FRAC:
        return MaskedBeam(
            width=masked_beam_width(k, oversample, frac), k=k_eff, est_frac=frac
        )
    if frac <= PREFILTER_MAX_FRAC:
        return ExactScan(k=k_eff, est_frac=frac, dtype=scan_dtype)
    if frac <= MASK_MAX_FRAC:
        if use_pq:
            pool = max(PQ_POOL_FACTOR * k_eff, PQ_POOL_FLOOR)
            return PQScan(pool=pool, k=k_eff, est_frac=frac)
        return ExactScan(k=k_eff, est_frac=frac, dtype=scan_dtype)
    return PostfilterBeam(
        pool=postfilter_pool(k, oversample, frac), k=k_eff, est_frac=frac
    )


def plan_filtered(
    pred, zonemap, routing, *, k: int, oversample: int, use_pq: bool,
    scan_dtype: str = "f32",
) -> Tuple[Dict[int, PlanOp], List[int], float]:
    """Per-shard plan ops for one predicate: zone-prune a shard outright or
    choose its band op from the estimated passing fraction of its member
    row groups (histogram-backed for int ranges).  Without a zone map
    (index built before the table had attributes) every shard gets the
    conservative over-fetched post-filter plan.

    Returns (shard_id -> op, pruned shard ids, global passing fraction)."""
    if zonemap is None:
        op = PostfilterBeam(
            pool=postfilter_pool(k, oversample, 1.0),
            k=max(1, k * oversample),
            est_frac=1.0,
        )
        return {s.shard_id: op for s in routing.shards}, [], 1.0

    def _frac(zones) -> float:
        rows, est = 0, 0.0
        for z in zones:
            c = next(iter(z.values())).count if z else 0
            rows += c
            est += pred.estimate_fraction(z) * c
        return est / max(rows, 1)

    all_zones = [z for per_file in zonemap.zones.values() for z in per_file]
    global_frac = _frac(all_zones)
    ops: Dict[int, PlanOp] = {}
    pruned: List[int] = []
    for s in routing.shards:
        shard_zones = zonemap.shard_zones(s.shard_id)
        if shard_zones is not None and not any(
            pred.zone_may_match(z) for z in shard_zones
        ):
            pruned.append(s.shard_id)
            continue
        frac = _frac(shard_zones) if shard_zones else global_frac
        ops[s.shard_id] = band_op(
            frac,
            k=k,
            oversample=oversample,
            use_pq=use_pq,
            shard_rows=s.vector_count,
            scan_dtype=scan_dtype,
        )
    return ops, pruned, global_frac


def plan_unfiltered(
    shard_rows: int, *, mixed: bool, k: int, oversample: int
) -> PlanOp:
    """Op for an unfiltered query: a plain beam, except when it rides a
    MIXED fragment on a small shard, where an all-ones exact-scan row is
    cheaper than splitting the fragment's kernel dispatch — the scan is
    size-capped (EXACT_SCAN_MAX_ROWS), never an unbounded O(N·D) row."""
    k_eff = max(1, k * oversample)
    if mixed and shard_rows <= EXACT_SCAN_MAX_ROWS:
        return ExactScan(k=k_eff, est_frac=1.0)
    return Beam(width=k_eff)


def plan_tail(
    row_counts: List[int], *, k: int, oversample: int, est_frac: float = 1.0
) -> Dict[int, PlanOp]:
    """Plan ops for the fresh-tail tier: one op per appended-but-unindexed
    row group, keyed by its synthetic plan-grid id (-1, -2, ... in tail
    order — negative so tail rows never collide with shard ids).

    Tail row groups have no graph and no PQ codes, so every op is an
    :class:`ExactScan` over the row group's rows (the masked kernel path —
    predicates ride the same bitmask input as shard scans).  ``est_frac``
    carries the predicate's estimated passing fraction as evidence; the
    executor still resolves against the measured match count, so a
    zero-match tail row group collapses to :class:`Skip`."""
    k_eff = max(1, k * oversample)
    return {
        -(i + 1): ExactScan(k=min(k_eff, max(1, int(n))), est_frac=est_frac)
        for i, n in enumerate(row_counts)
    }


def default_filtered_op(k: int, oversample: int, use_pq: bool) -> PlanOp:
    """Fallback for tasks carrying a predicate but no coordinator op (e.g.
    hand-built tasks in tests): the mid-band mask plan, matching the old
    ``filter_mode="mask"`` default."""
    return band_op(0.5, k=k, oversample=oversample, use_pq=use_pq)


# ---------------------------------------------------------------------------
# executor-side resolution
# ---------------------------------------------------------------------------


def resolve(
    op: PlanOp, *, match_count: int, k: int, oversample: int, has_pq: bool
) -> PlanOp:
    """Refine a coordinator op with the measured predicate match count.

    This is the per-query flavor classification both executor paths (the
    mask-plane interpreter AND the ``force_group_loop`` baseline) share, so
    they can never drift apart:

    - zero matches  -> :class:`Skip`;
    - a small passing set (<= max(SMALL_MATCH_FACTOR·k_eff,
      SMALL_MATCH_FLOOR)) -> :class:`ExactScan`, whatever the band —
      scanning a handful of rows exactly beats searching;
    - :class:`PQScan` keeps its ADC pool (pinned: the not-small condition
      guarantees k_eff == k·oversample, so the pool is one shared constant
      for every PQ-flavor query of a fragment), degrading to
      :class:`ExactScan` when the shard carries no codes;
    - :class:`PostfilterBeam` keeps its coordinator-sized pool;
    - :class:`Beam` / :class:`Skip` pass through untouched.
    """
    if isinstance(op, (Skip, Beam)):
        return op
    if match_count <= 0:
        return Skip(reason="no-match")
    # the scoring-dtype annotation survives every ExactScan refinement —
    # collapses FROM other op kinds score f32 (tiny sets gain nothing from
    # quantization, and non-scan ops carry no annotation to preserve)
    dtype = op.dtype if isinstance(op, ExactScan) else "f32"
    k_eff = min(max(1, k * oversample), match_count)
    small = match_count <= max(SMALL_MATCH_FACTOR * k_eff, SMALL_MATCH_FLOOR)
    if small:
        return ExactScan(k=k_eff, est_frac=op.est_frac, dtype=dtype)
    if isinstance(op, PQScan):
        if not has_pq:
            return ExactScan(k=k_eff, est_frac=op.est_frac)
        pool = min(match_count, max(PQ_POOL_FACTOR * k_eff, PQ_POOL_FLOOR))
        return PQScan(pool=int(pool), k=k_eff, est_frac=op.est_frac)
    if isinstance(op, PostfilterBeam):
        return PostfilterBeam(pool=op.pool, k=k_eff, est_frac=op.est_frac)
    if isinstance(op, MaskedBeam):
        width = max(k_eff, min(op.width, match_count))
        return MaskedBeam(width=int(width), k=k_eff, est_frac=op.est_frac)
    return ExactScan(k=k_eff, est_frac=op.est_frac, dtype=dtype)


# ---------------------------------------------------------------------------
# the plan artifact
# ---------------------------------------------------------------------------


@dataclass
class ProbePlan:
    """The serializable per-(query, shard) op grid of one probe.

    ``ops[qi][shard_id]`` is the coordinator op for query ``qi`` on that
    shard (zone-pruned fragments appear as :class:`Skip` entries, so the
    plan records every routing decision, not just the dispatched ones).  A
    single-predicate :meth:`Coordinator.probe` plans one pseudo-query row.
    The plan rides ``ProbeReport.plan`` — loggable, diffable in tests, and
    replayable through :meth:`from_json`."""

    k: int
    oversample: int
    use_pq: bool
    ops: List[Dict[int, PlanOp]] = field(default_factory=list)
    est_selectivity: float = 1.0
    pruned_shards: Tuple[int, ...] = ()

    def op_for(self, qi: int, shard_id: int) -> Optional[PlanOp]:
        if qi >= len(self.ops):
            return None
        return self.ops[qi].get(shard_id)

    def summary(self) -> str:
        """Token:count plan string, one segment per distinct per-query op
        row — e.g. ``"mask:2,prefilter:1,pruned:1"`` — matching the legacy
        ``filter_plan`` vocabulary."""
        segments: List[str] = []
        for row in self.ops:
            counts: Dict[str, int] = {}
            for op in row.values():
                tok = op_token(op)
                counts[tok] = counts.get(tok, 0) + 1
            seg = ",".join(f"{t}:{c}" for t, c in sorted(counts.items()))
            if seg and seg not in segments:
                segments.append(seg)
        return ";".join(segments)

    def kernel_eligible(self, qi: int, shard_id: int) -> bool:
        """Whether this (query, shard) is planned onto a masked-kernel
        dispatch (vs a beam/postfilter pass)."""
        op = self.op_for(qi, shard_id)
        return isinstance(op, (ExactScan, PQScan))

    def to_json(self) -> dict:
        return {
            "k": self.k,
            "oversample": self.oversample,
            "use_pq": self.use_pq,
            "est_selectivity": self.est_selectivity,
            "pruned_shards": list(self.pruned_shards),
            "ops": [
                {str(sid): op.to_json() for sid, op in sorted(row.items())}
                for row in self.ops
            ],
        }

    @staticmethod
    def from_json(obj: dict) -> "ProbePlan":
        return ProbePlan(
            k=int(obj["k"]),
            oversample=int(obj["oversample"]),
            use_pq=bool(obj["use_pq"]),
            est_selectivity=float(obj.get("est_selectivity", 1.0)),
            pruned_shards=tuple(obj.get("pruned_shards", ())),
            ops=[
                {int(sid): op_from_json(op) for sid, op in row.items()}
                for row in obj.get("ops", [])
            ],
        )
