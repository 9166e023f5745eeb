"""The reference's ``tests/test_planner.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU.

Probe-plan IR (runtime/planner.py): its acceptance contract.

- plan ops are golden-serializable and round-trip through ``ProbeReport``;
- planner.resolve is the ONLY flavor classifier (executor.py is grep-clean
  of selectivity thresholds);
- a coalesced fragment mixing exact and PQ flavors with heterogeneous
  predicates completes in exactly ONE kernel dispatch per shard, with hits
  bit-identical to the ``force_group_loop`` path AND the two-dispatch
  ``force_split_flavors`` path;
- an unfiltered query riding a MIXED fragment gets a shared Beam op (or a
  size-capped ExactScan below EXACT_SCAN_MAX_ROWS) — never an uncapped
  O(N·D) all-ones row.
"""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from repro_torch.runtime import planner  # noqa: E402
from _torch_cpu import make_local_cluster  # noqa: E402
from repro_torch.runtime.coordinator import IndexConfig  # noqa: E402
from repro_torch.runtime.planner import Beam, ExactScan, MaskedBeam, PlanOp, PostfilterBeam, ProbePlan, PQScan, Skip, op_from_json  # noqa: E402

DIM = 16


def _locs(hits):
    return [(h.file_path, h.row_group, h.row_offset) for h in hits]


def _locs_d(hits):
    return [(h.file_path, h.row_group, h.row_offset, h.distance) for h in hits]


# ---------------------------------------------------------------------------
# op selection + resolution (pure unit tests)
# ---------------------------------------------------------------------------


def test_band_op_golden():
    """The three selectivity bands map to their ops, with evidence and
    pool sizes attached."""
    assert planner.band_op(0.05, k=10, oversample=4, use_pq=True) == ExactScan(
        k=40, est_frac=0.05
    )
    assert planner.band_op(0.5, k=10, oversample=4, use_pq=True) == PQScan(
        pool=160, k=40, est_frac=0.5
    )
    # mask band without PQ codes: the exact kernel scan
    assert planner.band_op(0.5, k=10, oversample=4, use_pq=False) == ExactScan(
        k=40, est_frac=0.5
    )
    op = planner.band_op(0.9, k=10, oversample=4, use_pq=True)
    assert isinstance(op, PostfilterBeam)
    # postfilter band: 1/0.9 < MIN_OVERFETCH, so the 2x floor applies
    assert op.pool == 80 and op.k == 40 and op.est_frac == pytest.approx(0.9)


def test_band_op_big_shard_routes_to_masked_beam():
    """Above EXACT_SCAN_MAX_ROWS every masked linear scan is an O(N·D) hole:
    both the prefilter and mask bands route to MaskedBeam, widened by
    ~1/est_frac and clamped at MASKED_BEAM_MAX_WIDEN."""
    big = planner.EXACT_SCAN_MAX_ROWS + 1
    assert planner.band_op(0.5, k=10, oversample=4, use_pq=True, shard_rows=big) == (
        MaskedBeam(width=80, k=40, est_frac=0.5)
    )
    # prefilter-band fraction on a big shard: still the traversal, width
    # clamped at 4x even though 1/0.05 = 20x
    assert planner.band_op(0.05, k=10, oversample=4, use_pq=True, shard_rows=big) == (
        MaskedBeam(width=160, k=40, est_frac=0.05)
    )
    # above MASK_MAX_FRAC the over-fetched postfilter beam stays cheaper
    assert isinstance(
        planner.band_op(0.9, k=10, oversample=4, use_pq=True, shard_rows=big),
        PostfilterBeam,
    )
    # AT the cap (not above) the scan bands still apply
    assert planner.band_op(
        0.5, k=10, oversample=4, use_pq=True,
        shard_rows=planner.EXACT_SCAN_MAX_ROWS,
    ) == PQScan(pool=160, k=40, est_frac=0.5)
    # no shard-size evidence (default_filtered_op path): never MaskedBeam
    assert planner.band_op(0.5, k=10, oversample=4, use_pq=True) == PQScan(
        pool=160, k=40, est_frac=0.5
    )


def test_masked_beam_width_clamps():
    k_eff = 40
    assert planner.masked_beam_width(10, 4, 1.0) == k_eff  # no widening
    assert planner.masked_beam_width(10, 4, 0.5) == 2 * k_eff
    assert planner.masked_beam_width(10, 4, 0.25) == 4 * k_eff
    assert planner.masked_beam_width(10, 4, 0.01) == 4 * k_eff  # ceiling
    assert planner.masked_beam_width(10, 4, 0.0) == 4 * k_eff  # no div-zero


def test_postfilter_pool_clamps():
    k_eff = 40
    # band-planned shards only reach PostfilterBeam above MASK_MAX_FRAC,
    # so the 2x floor is their operative size; the sub-floor fractions
    # below exercise the sizing for hand-authored/replayed plans
    assert planner.postfilter_pool(10, 4, 1.0) == 2 * k_eff  # floor
    assert planner.postfilter_pool(10, 4, 0.8) == 2 * k_eff  # still floor
    assert planner.postfilter_pool(10, 4, 0.3) == int(round(k_eff / 0.3))
    assert planner.postfilter_pool(10, 4, 0.01) == 4 * k_eff  # ceiling


def test_resolve_zero_and_small_matches():
    op = planner.band_op(0.5, k=10, oversample=4, use_pq=True)
    assert planner.resolve(
        op, match_count=0, k=10, oversample=4, has_pq=True
    ) == Skip(reason="no-match")
    # small passing set: exact scan whatever the band, k_eff = match
    small = planner.resolve(op, match_count=30, k=10, oversample=4, has_pq=True)
    assert small == ExactScan(k=30, est_frac=0.5)
    post = planner.band_op(0.9, k=10, oversample=4, use_pq=True)
    assert isinstance(
        planner.resolve(post, match_count=100, k=10, oversample=4, has_pq=True),
        ExactScan,
    )  # 100 <= max(4*40, 64)


def test_resolve_pins_pq_pool_and_degrades_without_codes():
    op = planner.band_op(0.5, k=10, oversample=4, use_pq=True)
    big = planner.resolve(op, match_count=500, k=10, oversample=4, has_pq=True)
    assert big == PQScan(pool=160, k=40, est_frac=0.5)
    # every not-small match count resolves to the SAME pool (the parity pin)
    bigger = planner.resolve(op, match_count=5000, k=10, oversample=4, has_pq=True)
    assert bigger.pool == big.pool == 160
    no_pq = planner.resolve(op, match_count=500, k=10, oversample=4, has_pq=False)
    assert no_pq == ExactScan(k=40, est_frac=0.5)


def test_resolve_masked_beam():
    big = planner.EXACT_SCAN_MAX_ROWS + 1
    op = planner.band_op(0.1, k=10, oversample=4, use_pq=False, shard_rows=big)
    assert op == MaskedBeam(width=160, k=40, est_frac=0.1)
    # zero and small passing sets collapse before the traversal branch
    assert planner.resolve(
        op, match_count=0, k=10, oversample=4, has_pq=False
    ) == Skip(reason="no-match")
    assert planner.resolve(
        op, match_count=100, k=10, oversample=4, has_pq=False
    ) == ExactScan(k=40, est_frac=0.1)
    # a not-small passing set keeps the traversal with its planned width —
    # and k pinned at k_eff, the fused-fallback parity requirement
    kept = planner.resolve(op, match_count=500, k=10, oversample=4, has_pq=False)
    assert kept == MaskedBeam(width=160, k=40, est_frac=0.1)
    # hand-authored/replayed widths cap at the actual match count (never
    # below k_eff): admitting more than the passing set is meaningless
    hand = MaskedBeam(width=1000, k=40, est_frac=0.1)
    assert planner.resolve(
        hand, match_count=300, k=10, oversample=4, has_pq=False
    ) == MaskedBeam(width=300, k=40, est_frac=0.1)
    assert planner.resolve(
        MaskedBeam(width=10, k=40, est_frac=0.1),
        match_count=500, k=10, oversample=4, has_pq=False,
    ).width == 40  # floor: at least k_eff


def test_resolve_passes_beam_and_skip_through():
    assert planner.resolve(
        Beam(width=40), match_count=0, k=10, oversample=4, has_pq=True
    ) == Beam(width=40)
    assert planner.resolve(
        Skip(), match_count=7, k=10, oversample=4, has_pq=True
    ) == Skip()


def test_plan_unfiltered_caps_the_all_ones_scan():
    """A regression fix: an unfiltered query on a MIXED fragment is
    an all-ones kernel row only below EXACT_SCAN_MAX_ROWS; past the cap it
    routes to a shared beam, and unmixed fragments always beam."""
    small = planner.plan_unfiltered(1000, mixed=True, k=10, oversample=4)
    assert small == ExactScan(k=40, est_frac=1.0)
    big = planner.plan_unfiltered(
        planner.EXACT_SCAN_MAX_ROWS + 1, mixed=True, k=10, oversample=4
    )
    assert big == Beam(width=40)
    assert planner.plan_unfiltered(100, mixed=False, k=10, oversample=4) == Beam(
        width=40
    )


# ---------------------------------------------------------------------------
# serialization: golden op JSON + ProbePlan round-trip
# ---------------------------------------------------------------------------

GOLDEN_OPS = [
    (Skip(reason="zone-pruned"), {"op": "Skip", "reason": "zone-pruned"}),
    (Beam(width=40), {"op": "Beam", "width": 40}),
    (
        ExactScan(k=40, est_frac=0.05),
        {"op": "ExactScan", "k": 40, "est_frac": 0.05, "dtype": "f32"},
    ),
    (
        ExactScan(k=40, est_frac=0.05, dtype="int8"),
        {"op": "ExactScan", "k": 40, "est_frac": 0.05, "dtype": "int8"},
    ),
    (
        PQScan(pool=160, k=40, est_frac=0.5),
        {"op": "PQScan", "pool": 160, "k": 40, "est_frac": 0.5},
    ),
    (
        PostfilterBeam(pool=80, k=40, est_frac=0.9),
        {"op": "PostfilterBeam", "pool": 80, "k": 40, "est_frac": 0.9},
    ),
    (
        MaskedBeam(width=160, k=40, est_frac=0.1),
        {"op": "MaskedBeam", "width": 160, "k": 40, "est_frac": 0.1},
    ),
]


@pytest.mark.parametrize("op,golden", GOLDEN_OPS, ids=lambda x: type(x).__name__)
def test_golden_op_serialization(op, golden):
    if not isinstance(op, PlanOp):
        pytest.skip("golden literal side of the pair")
    assert op.to_json() == golden
    assert op_from_json(golden) == op
    # through an actual JSON string, as a log line would carry it
    assert op_from_json(json.loads(json.dumps(op.to_json()))) == op


def test_exact_scan_json_back_compat():
    """Plans serialized before the ``dtype`` field existed deserialize to
    the f32 default — replay of old captured plans keeps working."""
    old = {"op": "ExactScan", "k": 40, "est_frac": 0.05}
    assert op_from_json(old) == ExactScan(k=40, est_frac=0.05, dtype="f32")


def test_probe_plan_round_trip():
    plan = ProbePlan(
        k=10,
        oversample=4,
        use_pq=True,
        ops=[
            {0: ExactScan(k=40, est_frac=0.05), 1: Skip()},
            {0: PQScan(pool=160, k=40, est_frac=0.5), 1: Beam(width=40)},
        ],
        est_selectivity=0.275,
        pruned_shards=(1,),
    )
    back = ProbePlan.from_json(json.loads(json.dumps(plan.to_json())))
    assert back == plan
    assert back.op_for(1, 0) == PQScan(pool=160, k=40, est_frac=0.5)
    assert back.kernel_eligible(1, 0) and not back.kernel_eligible(1, 1)
    assert "prefilter" in plan.summary() and "pruned" in plan.summary()


def test_executor_is_grep_clean_of_thresholds():
    """Acceptance: runtime/planner.py is the only module that chooses plan
    ops — executor.py must carry no selectivity thresholds or flavor
    classification of its own."""
    src = (
        pathlib.Path(__file__).resolve().parents[1]
        / "src" / "repro" / "runtime" / "executor.py"
    ).read_text()
    for needle in ("MAX_FRAC", "_plan_flavor", "def _pq_pool", "max(4 *", "max(4*"):
        assert needle not in src, f"threshold logic leaked into executor.py: {needle}"


# ---------------------------------------------------------------------------
# plans as report artifacts (integration, PQ index for mixed flavors)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixed_cluster(tmp_path_factory):
    """PQ index whose shards are large enough that a mid-selectivity mask
    plan takes the ADC flavor while a tight predicate stays exact — the
    mixed-flavor fragment the unified kernel collapses to one dispatch."""
    rng = np.random.default_rng(2)
    c = make_local_cluster(str(tmp_path_factory.mktemp("planner")), num_executors=2)
    t = LakehouseTable(c.catalog, "emb")
    t.create(dim=DIM)
    centers = rng.normal(size=(6, DIM))
    X = np.concatenate(
        [ctr + rng.normal(size=(220, DIM)) for ctr in centers]
    ).astype(np.float32)
    price = rng.integers(0, 100, size=len(X)).astype(np.int64)
    t.append_vectors(
        X, num_files=4, rows_per_group=110, attributes={"price": price}
    )
    rep = c.coordinator.create_index(
        "emb",
        IndexConfig(
            name="idx", R=16, L=48, pq_m=8, pq_nbits=8,
            partitions_per_shard=2, build_passes=1,
        ),
    )
    return c, t, X, price, rep


# alternating tight (exact flavor) and wide (ADC flavor) predicates — all
# distinct: est selectivities ~0.02-0.05 and ~0.55-0.70
MIXED_FILTERS = [
    f"price < {2 + i // 2}" if i % 2 == 0 else f"price < {55 + 5 * (i // 2)}"
    for i in range(8)
]


def _set_flag(c, name, flag):
    for ex in c.executors:
        setattr(ex, name, flag)


def _reset_dispatches(c):
    for ex in c.executors:
        ex.masked_kernel_dispatches = 0


def test_mixed_flavor_fragment_is_one_dispatch_per_shard(mixed_cluster):
    """THE tentpole acceptance: exact-flavor and PQ-flavor queries with
    heterogeneous predicates in one coalesced fragment cost exactly ONE
    kernel dispatch per shard (the unified kernel), with hits bit-identical
    to the force_group_loop path and to the two-dispatch split-flavor
    path."""
    c, t, X, price, rep = mixed_cluster
    rng = np.random.default_rng(4)
    Q = X[rng.choice(len(X), 8)] + 0.05 * rng.normal(size=(8, DIM)).astype(np.float32)
    assert len(set(MIXED_FILTERS)) == 8
    # warm masks
    c.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=MIXED_FILTERS)

    _reset_dispatches(c)
    br = c.coordinator.probe_batch(
        "emb", Q, 10, strategy="diskann", filter=MIXED_FILTERS
    )
    # the plan grid must genuinely mix flavors on at least one shard
    flavors = {
        type(br.plan.op_for(qi, sid)).__name__
        for qi in range(8)
        for sid in br.plan.ops[qi]
    }
    assert {"ExactScan", "PQScan"} <= flavors, br.plan.to_json()
    assert br.probe_fragments >= 1
    assert br.kernel_dispatches == br.probe_fragments  # ONE dispatch per shard
    assert sum(ex.masked_kernel_dispatches for ex in c.executors) == br.kernel_dispatches

    # two-dispatch split-flavor path: same hits, one dispatch per flavor
    _set_flag(c, "force_split_flavors", True)
    try:
        _reset_dispatches(c)
        bs = c.coordinator.probe_batch(
            "emb", Q, 10, strategy="diskann", filter=MIXED_FILTERS
        )
    finally:
        _set_flag(c, "force_split_flavors", False)
    assert bs.kernel_dispatches == 2 * bs.probe_fragments
    for a, b in zip(br.hits, bs.hits):
        assert _locs_d(a) == _locs_d(b)

    # legacy per-predicate-group loop: one dispatch per distinct predicate
    _set_flag(c, "force_group_loop", True)
    try:
        _reset_dispatches(c)
        bg = c.coordinator.probe_batch(
            "emb", Q, 10, strategy="diskann", filter=MIXED_FILTERS
        )
    finally:
        _set_flag(c, "force_group_loop", False)
    assert bg.kernel_dispatches == len(MIXED_FILTERS) * bg.probe_fragments
    for a, b in zip(br.hits, bg.hits):
        assert _locs_d(a) == _locs_d(b)  # bit-identical, distances included

    # and exact parity vs the brute-force oracle (every plan is exact or
    # ADC + full-precision rerank over >= 4*k_eff pools at this scale)
    oracle = c.coordinator.probe_batch(
        "emb", Q, 10, strategy="scan", filter=MIXED_FILTERS
    )
    recall = np.mean([
        len(set(_locs(a)) & set(_locs(b))) / max(len(_locs(a)), 1)
        for a, b in zip(oracle.hits, br.hits)
    ])
    assert recall >= 0.95


def test_report_plan_round_trips_and_matches_summary(mixed_cluster):
    """The plan artifact on ProbeReport: serializable, replayable, and its
    summary is exactly the report's filter_plan string."""
    c, t, X, price, rep = mixed_cluster
    br = c.coordinator.probe_batch(
        "emb", X[:4], 10, strategy="diskann", filter=MIXED_FILTERS[:4]
    )
    assert br.plan is not None
    assert br.plan.k == 10 and br.plan.use_pq
    assert len(br.plan.ops) == 4  # one op row per query
    back = ProbePlan.from_json(json.loads(json.dumps(br.plan.to_json())))
    assert back == br.plan
    # single-probe plans round-trip too (one pseudo-query row)
    pr = c.coordinator.probe("emb", X[0], 10, strategy="diskann", filter="price < 60")
    assert pr.plan is not None and len(pr.plan.ops) == 1
    assert ProbePlan.from_json(pr.plan.to_json()) == pr.plan
    assert pr.plan.summary() == pr.filter_plan


def test_golden_plan_scenarios(mixed_cluster):
    """Representative (selectivity, flavor) scenarios produce the expected
    op types in the report plan."""
    c, t, X, price, rep = mixed_cluster
    cases = [
        ("price < 2", ExactScan),       # ~2%: prefilter band
        ("price < 60", PQScan),         # ~60% on a PQ index: ADC band
        ("price < 95", PostfilterBeam), # ~95%: over-fetched postfilter
    ]
    for where, op_type in cases:
        pr = c.coordinator.probe("emb", X[0], 10, strategy="diskann", filter=where)
        ops_row = pr.plan.ops[0]
        assert ops_row, where
        assert all(isinstance(op, op_type) for op in ops_row.values()), (
            where, pr.plan.to_json(),
        )


def test_unfiltered_rows_in_mixed_batch_get_planned_ops(mixed_cluster):
    """A batch mixing filtered and unfiltered queries: the unfiltered rows
    appear in the plan grid with a planner op — the size-capped ExactScan
    on these small shards — and with EXACT_SCAN_MAX_ROWS forced to 0 they
    route to a shared Beam instead, still matching sequential probes."""
    c, t, X, price, rep = mixed_cluster
    rng = np.random.default_rng(6)
    Q = X[rng.choice(len(X), 4)] + 0.05 * rng.normal(size=(4, DIM)).astype(np.float32)
    filters = [None, "price < 60", None, "price < 3"]
    br = c.coordinator.probe_batch("emb", Q, 5, strategy="diskann", filter=filters)
    for qi in (0, 2):
        row_ops = list(br.plan.ops[qi].values())
        assert row_ops and all(
            op == ExactScan(k=20, est_frac=1.0) for op in row_ops
        ), br.plan.to_json()
    seq = [
        c.coordinator.probe(
            "emb", Q[i], 5, strategy="diskann", filter=filters[i]
        ).hits[0]
        for i in range(4)
    ]
    for a, b in zip(seq, br.hits):
        assert _locs(a) == _locs(b)

    # shards "too big" for the all-ones scan: unfiltered rows become Beam
    import repro_torch.runtime.planner as planner_mod

    old = planner_mod.EXACT_SCAN_MAX_ROWS
    planner_mod.EXACT_SCAN_MAX_ROWS = 0
    try:
        bb = c.coordinator.probe_batch("emb", Q, 5, strategy="diskann", filter=filters)
    finally:
        planner_mod.EXACT_SCAN_MAX_ROWS = old
    for qi in (0, 2):
        assert all(
            isinstance(op, Beam) for op in bb.plan.ops[qi].values()
        ), bb.plan.to_json()
    for a, b in zip(seq, bb.hits):
        assert _locs(a) == _locs(b)  # beam == the sequential unfiltered probe


def test_postfilter_rows_share_pooled_beam_with_fused_fallback(mixed_cluster):
    """Heterogeneous postfilter-planned predicates no longer loop per
    predicate group: rows group by planner pool (one beam pass here), and
    results still match both the group loop and sequential probes."""
    c, t, X, price, rep = mixed_cluster
    rng = np.random.default_rng(8)
    Q = X[rng.choice(len(X), 4)] + 0.05 * rng.normal(size=(4, DIM)).astype(np.float32)
    filters = [f"price < {90 + i}" for i in range(4)]  # all postfilter band
    br = c.coordinator.probe_batch(
        "emb", Q, 5, strategy="diskann", filter=filters, L=256
    )
    assert "postfilter" in br.filter_plan
    _set_flag(c, "force_group_loop", True)
    try:
        bg = c.coordinator.probe_batch(
            "emb", Q, 5, strategy="diskann", filter=filters, L=256
        )
    finally:
        _set_flag(c, "force_group_loop", False)
    for a, b in zip(br.hits, bg.hits):
        assert _locs_d(a) == _locs_d(b)
    seq = [
        c.coordinator.probe(
            "emb", Q[i], 5, strategy="diskann", filter=filters[i], L=256
        ).hits[0]
        for i in range(4)
    ]
    for a, b in zip(seq, br.hits):
        assert _locs(a) == _locs(b)


def test_histogram_feeds_range_selectivity(mixed_cluster):
    """The attr-zonemap blob carries per-file int histograms and the range
    estimator uses them: on this uniform column the estimate lands within
    a few percent of the true fraction (the span guess would too — the
    histogram's value shows on skew, unit-tested below)."""
    c, t, X, price, rep = mixed_cluster
    true_frac = float((price < 30).mean())
    pr = c.coordinator.probe("emb", X[0], 10, strategy="diskann", filter="price < 30")
    assert pr.est_selectivity == pytest.approx(true_frac, abs=0.05)


def test_histogram_estimate_conditions_on_row_group_range():
    """The file-level histogram must be conditioned on each row group's own
    [min, max]: on a sorted column, a row group whose whole value range
    passes the predicate estimates ~1.0 (like the old span estimator did),
    not the file-wide fraction."""
    from repro_torch.runtime.predicates import ColumnHistogram, Range, ZoneStats

    sorted_col = np.arange(1000, dtype=np.int64) // 10  # 0..99, sorted
    hist = ColumnHistogram.build(sorted_col)
    pred = Range("c", hi=9)  # first ~10% of the file
    rg_first = {"c": ZoneStats(count=100, min=0, max=9, hist=hist)}
    rg_last = {"c": ZoneStats(count=100, min=90, max=99, hist=hist)}
    assert pred.estimate_fraction(rg_first) == pytest.approx(1.0, abs=0.05)
    assert pred.estimate_fraction(rg_last) == 0.0  # zone_may_match says no
    whole = {"c": ZoneStats(count=1000, min=0, max=99, hist=hist)}
    assert pred.estimate_fraction(whole) == pytest.approx(0.10, abs=0.03)


def test_histogram_estimate_respects_strict_int_bounds():
    """'price < 1' passes only value 0: a column concentrated AT the
    excluded boundary must not count that mass (int columns, so a strict
    bound shifts by exactly one)."""
    from repro_torch.runtime.predicates import ColumnHistogram, Range, ZoneStats

    # values 0..15 with the default 16 bins: one value per bin, so the
    # boundary mass is fully separable (wider value ranges only blur this
    # by within-bin interpolation, they cannot re-count the excluded bin)
    col = np.concatenate([
        np.zeros(50, np.int64), np.ones(900, np.int64),
        np.full(50, 15, np.int64),
    ])
    hist = ColumnHistogram.build(col)
    z = {"c": ZoneStats(count=1000, min=0, max=15, hist=hist)}
    true_frac = 0.05  # only the zeros pass price < 1
    est = Range("c", hi=1, hi_inclusive=False).estimate_fraction(z)
    assert est == pytest.approx(true_frac, abs=0.02)
    # inclusive keeps the boundary mass
    est_inc = Range("c", hi=1).estimate_fraction(z)
    assert est_inc == pytest.approx(0.95, abs=0.02)
    # strict lower bound mirrors: price > 1 excludes the concentrated mass
    est_gt = Range("c", lo=1, lo_inclusive=False).estimate_fraction(z)
    assert est_gt == pytest.approx(0.05, abs=0.02)


def test_histogram_estimate_beats_span_on_skew():
    from repro_torch.runtime.predicates import ColumnHistogram, Range, ZoneStats

    rng = np.random.default_rng(0)
    skewed = np.minimum((rng.exponential(3.0, size=4000)).astype(np.int64), 99)
    hist = ColumnHistogram.build(skewed)
    z_hist = {"c": ZoneStats(count=4000, min=0, max=99, hist=hist)}
    z_span = {"c": ZoneStats(count=4000, min=0, max=99)}
    pred = Range("c", hi=10)
    true_frac = float((skewed <= 10).mean())  # ~0.95 on this skew
    est_hist = pred.estimate_fraction(z_hist)
    est_span = pred.estimate_fraction(z_span)  # ~0.10: wildly off
    assert abs(est_hist - true_frac) < 0.1
    assert abs(est_hist - true_frac) < abs(est_span - true_frac)
    # histogram round-trips through the zone-map blob codec
    from repro_torch.core import blobs as B
    from repro_torch.core.blobs import AttrZoneMap

    zm = AttrZoneMap(columns={"c": "int"}, zones={"f1": [z_hist]})
    back = B.decode_zonemap_blob(B.encode_zonemap_blob(zm))
    assert back.zones["f1"][0]["c"].hist == hist
    assert pred.estimate_fraction(back.zones["f1"][0]) == pytest.approx(est_hist)


# ---------------------------------------------------------------------------
# replayable plans: probe_batch(replay_plan=...) skips planning entirely
# ---------------------------------------------------------------------------


def test_probe_batch_replay_plan_skips_planner_at_parity(mixed_cluster, monkeypatch):
    """A captured ``ProbePlan`` round-trips through JSON and replays through
    ``probe_batch(replay_plan=...)`` with the planner booby-trapped: no
    re-planning, no zone-map consultation — and the hits are identical to
    the freshly planned probe (the plan IS the planning)."""
    c, t, X, price, rep = mixed_cluster
    Q = np.stack([X[i] for i in range(8)])
    fresh = c.coordinator.probe_batch(
        "emb", Q, 5, strategy="diskann", filter=MIXED_FILTERS
    )
    assert fresh.plan is not None

    wire = json.dumps(fresh.plan.to_json())  # e.g. persisted next to a report
    plan = ProbePlan.from_json(json.loads(wire))

    def _no_planning(*a, **k):
        raise AssertionError("plan_filtered must not run under replay")

    monkeypatch.setattr(planner, "plan_filtered", _no_planning)
    replay = c.coordinator.probe_batch(
        "emb", Q, 5, strategy="diskann", filter=MIXED_FILTERS, replay_plan=plan
    )
    assert replay.filter_plan == "replay"
    assert replay.est_selectivity == pytest.approx(fresh.est_selectivity)
    assert replay.shards_pruned == fresh.shards_pruned
    for a, b in zip(fresh.hits, replay.hits):
        assert _locs(a) == _locs(b)
        np.testing.assert_allclose(
            [h.distance for h in a],
            [h.distance for h in b],
            rtol=1e-5,
            atol=1e-3,
        )


def test_replay_plan_validates_shape_and_strategy(mixed_cluster):
    c, t, X, price, rep = mixed_cluster
    Q = np.stack([X[i] for i in range(4)])
    fresh = c.coordinator.probe_batch(
        "emb", Q, 5, strategy="diskann", filter=MIXED_FILTERS[:4]
    )
    plan = ProbePlan.from_json(fresh.plan.to_json())
    with pytest.raises(ValueError):  # k mismatch
        c.coordinator.probe_batch(
            "emb", Q, 7, strategy="diskann", filter=MIXED_FILTERS[:4], replay_plan=plan
        )
    with pytest.raises(ValueError):  # row-count mismatch
        c.coordinator.probe_batch(
            "emb", Q[:2], 5, strategy="diskann",
            filter=MIXED_FILTERS[:2], replay_plan=plan,
        )
    with pytest.raises(ValueError):  # plans only exist for the index path
        c.coordinator.probe_batch(
            "emb", Q, 5, strategy="scan", filter=MIXED_FILTERS[:4], replay_plan=plan
        )


# ---------------------------------------------------------------------------
# per-shard histogram merge: shard-level selectivity evidence
# ---------------------------------------------------------------------------


def test_column_histogram_merge_unions_files():
    from repro_torch.runtime.predicates import ColumnHistogram

    lo_half = ColumnHistogram.build(np.arange(0, 50, dtype=np.int64))
    hi_half = ColumnHistogram.build(np.arange(50, 100, dtype=np.int64))
    merged = ColumnHistogram.merge([lo_half, hi_half])
    assert merged.lo == 0.0 and merged.hi == 99.0
    assert sum(merged.counts) == pytest.approx(100.0, rel=1e-6)
    # mass sits in both halves, roughly evenly on this uniform data
    assert merged.fraction_between(None, 49) == pytest.approx(0.5, abs=0.05)
    assert merged.fraction_between(50, None) == pytest.approx(0.5, abs=0.05)
    # degenerate cases: single histogram passes through bit-for-bit
    assert ColumnHistogram.merge([lo_half]) is lo_half
    assert ColumnHistogram.merge([]) is None


def test_shard_zones_merge_file_histograms():
    """A shard spanning two files with disjoint value ranges must expose a
    merged histogram: estimating against either file's own histogram would
    attribute ALL of the shard's mass to that file's range."""
    from repro_torch.core.blobs import AttrZoneMap
    from repro_torch.runtime.predicates import ColumnHistogram, Range, ZoneStats

    cheap = np.arange(0, 50, dtype=np.int64).repeat(20)  # 1000 rows, 0..49
    dear = np.arange(50, 100, dtype=np.int64).repeat(20)  # 1000 rows, 50..99
    h_cheap = ColumnHistogram.build(cheap)
    h_dear = ColumnHistogram.build(dear)
    zm = AttrZoneMap(
        columns={"price": "int"},
        zones={
            "fa": [{"price": ZoneStats(count=1000, min=0, max=49, hist=h_cheap)}],
            "fb": [{"price": ZoneStats(count=1000, min=50, max=99, hist=h_dear)}],
        },
        shard_membership={0: [("fa", 0), ("fb", 0)], 1: [("fa", 0)]},
    )

    pred = Range("price", hi=49)  # passes exactly file fa's rows
    both = zm.shard_zones(0)
    merged_hist = both[0]["price"].hist
    assert merged_hist is both[1]["price"].hist  # one shard-level histogram
    assert merged_hist.lo == 0.0 and merged_hist.hi == 99.0
    # per-zone estimates stay conditioned on each row group's own range
    assert pred.estimate_fraction(both[0]) == pytest.approx(1.0, abs=0.05)
    assert pred.estimate_fraction(both[1]) == 0.0
    # shard-level fraction over the merged evidence: half the shard's rows
    assert merged_hist.fraction_between(None, 49) == pytest.approx(0.5, abs=0.05)

    # single-file shard keeps its file histogram bit-for-bit (no re-binning)
    solo = zm.shard_zones(1)
    assert solo[0]["price"].hist is h_cheap
