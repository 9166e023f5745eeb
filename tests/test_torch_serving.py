"""The port's serving tier: admission, deadlines, degradation, leases,
metrics, the probe micro-batcher and the device-resident shard probe.

- The first part is ``tests/test_serving_tier.py`` run against
  ``repro_torch.serving``: unit tests on injected clocks, and the batcher's
  serving envelope (admission -> queue -> deadline-aware drain ->
  degradation -> delivery) against a stub coordinator.
- Then the same decisions from both packages: ``TokenBucket``,
  ``AdmissionController`` and ``DegradationPolicy`` under one injected
  clock and one random schedule.
- The device probe (``make_probe_fn``) on graphs ``repro`` built gives the
  reference probe's ids (on a one-device mesh), distances within 1e-5
  relative; with no payload both return each hit's first neighbour; where
  L exceeds the live rows both return the same (+inf, -1) slots.
- The batcher serves an append made outside the coordinator at once (the
  reference's semantic cache serves the pre-append answer until a probe
  drains), and the port's serving modules leave ``jax`` and ``repro``
  unloaded.
"""

import os
import queue as queue_mod
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving.admission import (  # noqa: E402
    AdmissionController,
    AdmissionRejected,
    DeadlineExceeded,
    DegradationPolicy,
    DropOversample,
    ProbeParams,
    ShrinkK,
    SkipTail,
    TenantPolicy,
    TokenBucket,
)
from repro_torch.serving.leases import LeaseTable  # noqa: E402
from repro_torch.serving.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serving.serve_loop import ProbeMicroBatcher  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")




class _FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# -- token bucket / admission ---------------------------------------------

def test_token_bucket_burst_and_refill():
    clock = _FakeClock()
    bucket = TokenBucket(rate=10.0, burst=2.0, clock=clock)
    assert bucket.try_acquire()
    assert bucket.try_acquire()
    assert not bucket.try_acquire()  # burst exhausted, no time passed
    clock.advance(0.1)  # one token refills at 10/s
    assert bucket.try_acquire()
    assert not bucket.try_acquire()
    clock.advance(10.0)  # refill caps at burst, not rate*dt
    assert bucket.try_acquire()
    assert bucket.try_acquire()
    assert not bucket.try_acquire()


def test_admission_controller_per_tenant_budgets():
    clock = _FakeClock()
    metrics = MetricsRegistry()
    ctl = AdmissionController(
        {"abuser": TenantPolicy(rate_qps=1.0, burst=2.0)},
        clock=clock,
        metrics=metrics,
    )
    # unknown tenants fall back to the default policy (unlimited)
    assert all(ctl.admit("trusted") for _ in range(50))
    # the configured tenant burns its own bucket
    decisions = [ctl.admit("abuser") for _ in range(5)]
    assert decisions == [True, True, False, False, False]
    assert metrics.counter_value("admissions", "abuser") == 2
    assert metrics.counter_value("admission_rejected", "abuser") == 3
    assert metrics.counter_value("admission_rejected", "trusted") == 0
    clock.advance(1.0)
    assert ctl.admit("abuser")  # budget recovers at rate_qps


# -- degradation ladder ----------------------------------------------------

def test_degradation_ladder_arms_by_pressure():
    policy = DegradationPolicy()
    assert policy.plan(0.0) == ()
    assert [type(s) for s in policy.plan(0.6)] == [ShrinkK]
    assert [type(s) for s in policy.plan(0.8)] == [ShrinkK, DropOversample]
    assert [type(s) for s in policy.plan(1.0)] == [ShrinkK, DropOversample, SkipTail]


def test_degradation_apply_transforms_params_and_labels():
    policy = DegradationPolicy()
    params = ProbeParams(k=10)

    out, labels = policy.apply(params, 0.0)
    assert out == params and labels == ()

    out, labels = policy.apply(params, 1.0)
    assert out.k == 5
    assert out.oversample == 1
    assert out.include_tail is False
    assert labels == ("shrink_k(x0.5)", "drop_oversample(to=1)", "skip_tail")


def test_degradation_noop_steps_leave_no_label():
    # k already at the floor: ShrinkK changes nothing and must not claim to
    policy = DegradationPolicy(steps=(ShrinkK(min_k=1),))
    out, labels = policy.apply(ProbeParams(k=1), 1.0)
    assert out.k == 1 and labels == ()


# -- lease table -----------------------------------------------------------

def test_lease_table_grants_replicas_and_expires():
    clock = _FakeClock()
    lt = LeaseTable(ttl=1.0, replicas=2, clock=clock)
    lease = lt.ensure("s1", ["a", "b", "c"])
    assert len(lease.holders) == 2
    primary = lease.holders[0]
    assert lt.valid_holders("s1") == lease.holders

    # renewal extends only the renewed holder
    clock.advance(0.6)
    lt.renew(primary)
    clock.advance(0.6)  # the other holder's lease (t=0 + 1.0) has lapsed
    valid = lt.valid_holders("s1")
    assert valid == [primary]

    # ensure tops back up to replicas, aging out the lapsed holder
    lease = lt.ensure("s1", ["a", "b", "c"])
    assert len(lease.holders) == 2
    assert primary in lease.holders
    assert lt.metrics.counter_value("lease_expiries") >= 1


def test_lease_table_expire_holder_is_immediate():
    clock = _FakeClock()
    lt = LeaseTable(ttl=100.0, replicas=2, clock=clock)
    lease = lt.ensure("s1", ["a", "b"])
    dead = lease.holders[0]
    assert lt.expire_holder(dead) == 1
    assert dead not in lt.valid_holders("s1")
    assert lt.holder_load(dead) == 0
    # re-ensure replaces the dead holder without advancing the clock
    lease = lt.ensure("s1", ["a", "b"])
    assert len(lease.holders) == 2 and dead in lease.holders


def test_lease_table_hot_shard_gains_extra_holder():
    clock = _FakeClock()
    lt = LeaseTable(ttl=100.0, replicas=2, hot_dispatches=10, clock=clock)
    for _ in range(10):
        lease = lt.ensure("hot", ["a", "b", "c", "d"])
    assert len(lease.holders) == 2  # not hot yet (dispatches == threshold)
    lease = lt.ensure("hot", ["a", "b", "c", "d"])
    assert len(lease.holders) == 3  # crossed hot_dispatches: +1 replica
    snap = lt.snapshot()["hot"]
    assert snap["dispatches"] == 11 and len(snap["valid"]) == 3


def test_lease_table_spreads_load_least_leased_first():
    clock = _FakeClock()
    lt = LeaseTable(ttl=100.0, replicas=1, clock=clock)
    holders = [lt.ensure(f"s{i}", ["a", "b", "c"]).holders[0] for i in range(6)]
    # 6 single-replica shards over 3 candidates: perfectly balanced
    assert sorted(holders.count(e) for e in "abc") == [2, 2, 2]


# -- metrics ---------------------------------------------------------------

def test_metrics_histogram_percentiles_and_snapshot():
    reg = MetricsRegistry()
    h = reg.histogram("latency_ms", "tenant-a", window=100)
    for v in range(1, 101):  # 1..100
        h.observe(float(v))
    assert h.percentile(50) == pytest.approx(50.0, abs=1.0)
    assert h.percentile(99) == pytest.approx(99.0, abs=1.0)
    assert h.count == 100
    reg.counter("served", "tenant-a").inc(7)
    snap = reg.snapshot()
    assert snap["served[tenant-a]"] == 7.0
    assert snap["latency_ms[tenant-a].count"] == 100.0
    assert snap["latency_ms[tenant-a].p99"] >= snap["latency_ms[tenant-a].p50"]


def test_metrics_histogram_window_slides():
    h = MetricsRegistry().histogram("x", window=10)
    for v in range(1000):
        h.observe(float(v))
    # percentiles reflect the recent window, lifetime count keeps the total
    assert h.percentile(50) >= 990.0
    assert h.count == 1000


# -- micro-batcher behavior (stub coordinator) -----------------------------

class _StubReport:
    def __init__(self, n):
        self.hits = [[("hit", i)] for i in range(n)]
        self.kernel_dispatches = 1
        self.tail_rows = 0
        self.degraded = ()


class _StubCoordinator:
    """Records probe_batch calls; optionally blocks on a gate or sleeps."""

    def __init__(self, *, service_s=0.0, gate=None, tail_rows=0, compact_exc=None):
        self.calls = []
        self.reports = []
        self.compact_calls = []
        self.service_s = service_s
        self.gate = gate
        self.tail_rows = tail_rows
        self.compact_exc = compact_exc
        self.entered = threading.Event()

    def probe_batch(self, table, queries, k, **kw):
        self.entered.set()
        if self.gate is not None:
            self.gate.wait(timeout=30.0)
        if self.service_s:
            time.sleep(self.service_s)
        self.calls.append((table, np.asarray(queries).shape, k, dict(kw)))
        rep = _StubReport(len(queries))
        rep.tail_rows = self.tail_rows
        self.reports.append(rep)
        return rep

    def compact_tail(self, table, index_name, threshold_rows):
        self.compact_calls.append((table, index_name, threshold_rows))
        if self.compact_exc is not None:
            raise self.compact_exc


def test_submit_admission_rejected_creates_no_future():
    coord = _StubCoordinator()
    with ProbeMicroBatcher(
        coord,
        "t",
        max_batch=8,
        max_wait_s=0.001,
        tenant_policies={"abuser": TenantPolicy(rate_qps=0.001, burst=2.0)},
    ) as mb:
        q = np.zeros(4, np.float32)
        f1 = mb.submit(q, k=3, tenant="abuser")
        f2 = mb.submit(q, k=3, tenant="abuser")
        with pytest.raises(AdmissionRejected):
            mb.submit(q, k=3, tenant="abuser")
        # trusted traffic is untouched by the abuser's empty bucket
        f3 = mb.submit(q, k=3, tenant="trusted")
        assert f1.result(timeout=5) and f2.result(timeout=5) and f3.result(timeout=5)
    assert mb.stats.admission_rejected == 1
    assert mb.metrics.counter_value("admission_rejected", "abuser") == 1
    assert mb.metrics.counter_value("served", "trusted") == 1


def test_deadline_expired_in_queue_never_dispatched():
    gate = threading.Event()
    coord = _StubCoordinator(gate=gate)
    with ProbeMicroBatcher(coord, "t", max_batch=1, max_wait_s=0.0) as mb:
        q = np.zeros(4, np.float32)
        f_slow = mb.submit(q, k=3)  # drained; blocks inside probe_batch
        assert coord.entered.wait(timeout=5)
        f_doomed = mb.submit(q, k=3, deadline_ms=20)
        time.sleep(0.08)  # deadline passes while still queued
        gate.set()
        assert f_slow.result(timeout=5)
        with pytest.raises(DeadlineExceeded):
            f_doomed.result(timeout=5)
    assert mb.stats.deadline_misses == 1
    assert len(coord.calls) == 1  # the expired query was never dispatched
    assert mb.metrics.counter_value("deadline_misses", "default") == 1


def test_late_completion_refused_not_served_late():
    coord = _StubCoordinator(service_s=0.08)
    with ProbeMicroBatcher(coord, "t", max_batch=4, max_wait_s=0.0) as mb:
        fut = mb.submit(np.zeros(4, np.float32), k=3, deadline_ms=20)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=5)
    # it WAS dispatched (alive at drain time) but the result came back late
    assert len(coord.calls) == 1
    assert mb.stats.deadline_misses == 1
    assert mb.metrics.counter_value("served", "default") == 0


def test_deadline_ordering_earliest_first():
    gate = threading.Event()
    coord = _StubCoordinator(gate=gate)
    with ProbeMicroBatcher(coord, "t", max_batch=8, max_wait_s=0.05) as mb:
        q = np.zeros(4, np.float32)
        blocker = mb.submit(q, k=3)  # occupies the drainer
        assert coord.entered.wait(timeout=5)
        loose = mb.submit(q, k=3, deadline_ms=10_000)
        tight = mb.submit(q, k=3, deadline_ms=1_000)
        free = mb.submit(q, k=3)
        gate.set()
        for f in (blocker, loose, tight, free):
            f.result(timeout=5)
    # second batch flushed earliest-deadline-first, deadline-free last
    assert coord.calls[1][1][0] == 3  # the three queued queries batched
    assert len(coord.calls) == 2


def test_degradation_force_on_shrinks_and_labels():
    coord = _StubCoordinator()
    with ProbeMicroBatcher(
        coord, "t", max_batch=4, max_wait_s=0.0, force_degrade="on"
    ) as mb:
        fut = mb.submit(np.zeros(4, np.float32), k=10)
        assert fut.result(timeout=5)
    (table, shape, k, kwargs) = coord.calls[0]
    assert k == 5  # ShrinkK halved the requested k
    assert kwargs["oversample"] == 1  # DropOversample
    assert kwargs["include_tail"] is False  # SkipTail
    assert coord.reports[0].degraded == (
        "shrink_k(x0.5)",
        "drop_oversample(to=1)",
        "skip_tail",
    )
    assert mb.stats.degraded_batches == 1
    assert mb.stats.degraded_queries == 1
    assert mb.metrics.counter_value("degraded:skip_tail") == 1


def test_force_degrade_off_is_bit_for_bit_legacy():
    """With force_degrade='off' an attached policy changes NOTHING about the
    coordinator call — same k, same kwargs as a policy-free batcher."""
    q = np.arange(4, dtype=np.float32)
    legacy = _StubCoordinator()
    with ProbeMicroBatcher(legacy, "t", max_batch=4, max_wait_s=0.0) as mb:
        for _ in range(3):
            mb.submit(q, k=7).result(timeout=5)

    armed = _StubCoordinator()
    with ProbeMicroBatcher(
        armed,
        "t",
        max_batch=4,
        max_wait_s=0.0,
        degradation=DegradationPolicy(),
        force_degrade="off",
        max_queue=2,  # pressure exists; "off" must still ignore it
    ) as mb2:
        for _ in range(3):
            mb2.submit(q, k=7).result(timeout=5)

    assert armed.calls == legacy.calls
    assert mb2.stats.degraded_batches == 0


def test_force_degrade_validation():
    with pytest.raises(ValueError):
        ProbeMicroBatcher(_StubCoordinator(), "t", force_degrade="sometimes")


# -- satellite: exact rejection accounting under concurrent submit ---------

def test_concurrent_submit_full_queue_exact_accounting():
    """≥8 threads hammer a max_queue=4 batcher while the drainer is wedged:
    exactly 4 submissions fit, every other attempt raises queue.Full, and
    stats.rejected equals the refusals exactly — no lost or double counts."""
    gate = threading.Event()
    coord = _StubCoordinator(gate=gate)
    mb = ProbeMicroBatcher(
        coord, "t", max_batch=1, max_wait_s=0.0, max_queue=4
    ).start()
    try:
        q = np.zeros(4, np.float32)
        wedge = mb.submit(q, k=3)  # drained immediately; blocks in probe_batch
        assert coord.entered.wait(timeout=5)

        n_threads, per_thread = 8, 6
        start = threading.Barrier(n_threads)
        futures, fulls = [], []
        lock = threading.Lock()

        def hammer():
            start.wait()
            for _ in range(per_thread):
                try:
                    f = mb.submit(q, k=3)
                    with lock:
                        futures.append(f)
                except queue_mod.Full:
                    with lock:
                        fulls.append(1)

        threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)

        attempts = n_threads * per_thread
        assert len(futures) == 4  # exactly the queue capacity
        assert len(fulls) == attempts - 4
        assert mb.stats.rejected == len(fulls)

        gate.set()  # unwedge: every accepted submission must still be served
        assert wedge.result(timeout=5)
        for f in futures:
            assert f.result(timeout=5)
        assert mb.stats.queries == 1 + len(futures)
    finally:
        gate.set()
        mb.stop()


# -- satellite: background compaction failures are recorded ----------------

def test_background_compaction_error_recorded_not_swallowed():
    coord = _StubCoordinator(
        tail_rows=64, compact_exc=RuntimeError("disk full (injected)")
    )
    with ProbeMicroBatcher(
        coord, "t", max_batch=4, max_wait_s=0.0, compact_tail_over=32, index_name="idx"
    ) as mb:
        assert mb.submit(np.zeros(4, np.float32), k=3).result(timeout=5)
        # wait out the doomed background compaction, then prove serving is fine
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            t = mb._compact_thread
            if t is not None and t.is_alive():
                t.join(timeout=10)
            if mb.stats.compaction_errors:
                break
            time.sleep(0.005)
        coord.tail_rows = 0  # disarm the trigger for the follow-up probe
        assert mb.submit(np.zeros(4, np.float32), k=3).result(timeout=5)
    assert coord.compact_calls == [("t", "idx", 32)]
    assert mb.stats.compactions == 1
    assert mb.stats.compaction_errors == 1
    assert mb.stats.last_compaction_error == "RuntimeError: disk full (injected)"
    assert mb.metrics.counter_value("compaction_errors") == 1


# -- overload: a well-behaved tenant survives an abusive one ---------------

def test_overload_two_tenants_well_behaved_protected():
    """Offered load ≫ capacity from an abusive tenant: admission control
    makes the abuser absorb the rejections while the well-behaved tenant's
    deadline hit-rate stays ≥ 0.9 and the queue stays bounded."""
    coord = _StubCoordinator(service_s=0.01)
    with ProbeMicroBatcher(
        coord,
        "t",
        max_batch=8,
        max_wait_s=0.002,
        max_queue=32,
        tenant_policies={"abuser": TenantPolicy(rate_qps=50.0, burst=4.0)},
    ) as mb:
        q = np.zeros(4, np.float32)
        abusive_outcomes = {"admitted": 0, "rejected": 0}

        def flood():
            for _ in range(200):
                try:
                    mb.submit(q, k=5, tenant="abuser", deadline_ms=2000)
                    abusive_outcomes["admitted"] += 1
                except (AdmissionRejected, queue_mod.Full):
                    abusive_outcomes["rejected"] += 1

        flooder = threading.Thread(target=flood)
        flooder.start()
        well_futs = []
        for _ in range(30):
            well_futs.append(mb.submit(q, k=5, tenant="well", deadline_ms=2000))
            time.sleep(0.005)
        flooder.join(timeout=10)

        well_ok = 0
        for f in well_futs:
            try:
                f.result(timeout=10)
                well_ok += 1
            except Exception:
                pass

    hit_rate = well_ok / len(well_futs)
    assert hit_rate >= 0.9, f"well-behaved hit rate {hit_rate:.2f}"
    # the abuser absorbed the rejections, not the well-behaved tenant
    assert abusive_outcomes["rejected"] > 100
    assert mb.stats.admission_rejected == abusive_outcomes["rejected"] or (
        mb.stats.admission_rejected > 100  # queue.Full counted separately
    )
    assert mb.metrics.counter_value("admission_rejected", "well") == 0
    # bounded queue: nothing ever sat beyond max_queue
    assert mb._queue.qsize() <= 32


# -- the same decisions from both packages ----------------------------------


def test_token_bucket_decisions_match_reference():
    from repro.serving.admission import TokenBucket as RefBucket

    clocks = (_FakeClock(), _FakeClock())
    port = TokenBucket(rate=7.0, burst=3.0, clock=clocks[0])
    ref = RefBucket(rate=7.0, burst=3.0, clock=clocks[1])
    rng = np.random.default_rng(3)
    got, want = [], []
    for _ in range(400):
        dt, n = float(rng.exponential(0.1)), float(rng.choice([0.5, 1.0, 2.0]))
        for c in clocks:
            c.advance(dt)
        got.append(port.try_acquire(n))
        want.append(ref.try_acquire(n))
    assert got == want
    assert any(got) and not all(got)


@pytest.mark.parametrize("default_rate", [None, 20.0])
def test_admission_controller_decisions_match_reference(default_rate):
    from repro.serving.admission import AdmissionController as RefController
    from repro.serving.admission import TenantPolicy as RefPolicy
    from repro.serving.metrics import MetricsRegistry as RefMetrics

    spec = {"a": (5.0, 2.0), "b": (50.0, 1.0)}
    clocks = (_FakeClock(), _FakeClock())
    port = AdmissionController(
        {t: TenantPolicy(r, b) for t, (r, b) in spec.items()},
        default=TenantPolicy(default_rate, 4.0), clock=clocks[0], metrics=MetricsRegistry(),
    )
    ref = RefController(
        {t: RefPolicy(r, b) for t, (r, b) in spec.items()},
        default=RefPolicy(default_rate, 4.0), clock=clocks[1], metrics=RefMetrics(),
    )
    rng = np.random.default_rng(5)
    got, want = [], []
    for _ in range(500):
        dt, tenant = float(rng.exponential(0.02)), str(rng.choice(["a", "b", "c"]))
        for c in clocks:
            c.advance(dt)
        got.append(port.admit(tenant))
        want.append(ref.admit(tenant))
    assert got == want
    assert port.metrics.snapshot() == ref.metrics.snapshot()


def test_degradation_decisions_match_reference():
    import dataclasses

    from repro.serving import admission as ra

    def policies(mod):
        return [
            mod.DegradationPolicy(),
            mod.DegradationPolicy(steps=(mod.ShrinkK(at_pressure=0.3, factor=0.25, min_k=2),
                                         mod.SkipTail(at_pressure=0.1),
                                         mod.DropOversample(at_pressure=0.6, to=3))),
        ]

    for port, ref in zip(policies(sys.modules[DegradationPolicy.__module__]), policies(ra)):
        for pressure in np.linspace(0.0, 1.0, 21):
            for k in (1, 2, 3, 10, 17):
                for over in (None, 4):
                    for tail in (True, False):
                        p, pl = port.apply(ProbeParams(k, over, tail), float(pressure))
                        r, rl = ref.apply(ra.ProbeParams(k, over, tail), float(pressure))
                        assert dataclasses.astuple(p) == dataclasses.astuple(r)
                        assert pl == rl
                assert [type(s).__name__ for s in port.plan(float(pressure))] == [
                    type(s).__name__ for s in ref.plan(float(pressure))]


# -- device-resident probe ---------------------------------------------------


@pytest.fixture(scope="module")
def ref_graphs():
    """Two shards built by ``repro`` (the fixture of tests/test_serving.py)."""
    from conftest import clustered_vectors
    from repro.core.vamana import VamanaParams, build_vamana

    rng = np.random.default_rng(0)
    X, _ = clustered_vectors(rng, n_clusters=8, per_cluster=125, dim=16)
    half = len(X) // 2
    g1 = build_vamana(X[:half], VamanaParams(R=12, L=24), passes=1, batch=128)
    g2 = build_vamana(X[half:], VamanaParams(R=12, L=24), passes=1, batch=128)
    payloads = [np.arange(half), np.arange(half, len(X))]
    Q = X[rng.choice(len(X), 8)] + 0.05 * rng.normal(size=(8, 16)).astype(np.float32)
    return X, [g1, g2], payloads, Q.astype(np.float32)


def _ref_probe(graphs, Q, payloads=None, dtype="float32", **kw):
    import jax
    import jax.numpy as jnp

    from repro.launch.mesh import make_debug_mesh
    from repro.serving.device_index import DeviceAnnIndex as RefIndex
    from repro.serving.device_index import make_probe_fn as ref_make

    mesh = make_debug_mesh(1, 1)
    idx = RefIndex.from_graphs(graphs, payloads=payloads, dtype=getattr(jnp, dtype))
    with mesh:
        d, p = jax.jit(ref_make(mesh, **kw))(idx, jnp.asarray(Q))
    return np.asarray(d), np.asarray(p)


def _port_probe(graphs, Q, payloads=None, dtype="float32", **kw):
    from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn

    idx = DeviceAnnIndex.from_graphs(graphs, payloads=payloads, dtype=getattr(torch, dtype),
                                     device="cpu")
    d, p = make_probe_fn(device="cpu", **kw)(idx, Q)
    return d.numpy(), p.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kw", [dict(k=10, L=24), dict(k=5, L=32, oversample=3),
                                dict(k=8, L=16, metric="ip")])
def test_device_probe_matches_reference_ids(ref_graphs, dtype, kw):
    X, graphs, payloads, Q = ref_graphs
    wd, wp = _ref_probe(graphs, Q, payloads, dtype, **kw)
    gd, gp = _port_probe(graphs, Q, payloads, dtype, **kw)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)


def test_device_probe_matches_host_search(ref_graphs):
    """The port of tests/test_serving.py:32: recall against brute force,
    ascending distances."""
    from repro_torch.core.vamana import brute_force_topk, recall_at_k

    X, graphs, payloads, _ = ref_graphs
    rng = np.random.default_rng(1)
    Q = X[rng.choice(len(X), 8)] + 0.05 * rng.normal(size=(8, 16)).astype(np.float32)
    d, ids = _port_probe(graphs, Q, payloads, k=10, L=24)
    _, truth = brute_force_topk(X, Q, 10, device="cpu")
    assert recall_at_k(ids, truth) >= 0.85
    assert (np.diff(d, axis=1) >= -1e-4).all()


def test_device_probe_without_payload_returns_first_neighbour(ref_graphs):
    """The reference's quirk, mirrored: with no payload each hit comes back
    as ``adjacency[shard, id, 0]``, its first neighbour, not its id."""
    X, graphs, _, Q = ref_graphs
    cap = max(g.vectors.shape[0] for g in graphs)
    # a payload that names (shard, id) tells which node each hit is
    where = [s * cap + np.arange(g.vectors.shape[0]) for s, g in enumerate(graphs)]
    _, hit = _port_probe(graphs, Q, where, k=10, L=24)
    _, got = _port_probe(graphs, Q, None, k=10, L=24)
    _, want = _ref_probe(graphs, Q, None, k=10, L=24)
    np.testing.assert_array_equal(got, want)
    first = np.array([[graphs[h // cap].adjacency[h % cap, 0] for h in row] for row in hit])
    np.testing.assert_array_equal(got, first)
    assert not np.array_equal(got, hit % cap)


def test_device_probe_sentinels_when_L_exceeds_live_rows():
    """Shards of 5 and 6 live rows, padded to one capacity, with L = 24 and
    k past the live rows: both packages return the same slots.  A pool slot
    never filled (id == cap, +inf) comes back as payload -1 at +inf; a slot
    the beam deduplicated keeps its id at +inf, so its payload comes back
    at +inf too, in the reference as in the port."""
    from repro.core.vamana import VamanaParams, build_vamana

    rng = np.random.default_rng(2)
    X = rng.normal(size=(11, 8)).astype(np.float32)
    graphs = [build_vamana(X[:5], VamanaParams(R=4, L=8), passes=1, batch=8),
              build_vamana(X[5:], VamanaParams(R=4, L=8), passes=1, batch=8)]
    payloads = [np.arange(5), np.arange(5, 11)]
    Q = rng.normal(size=(3, 8)).astype(np.float32)
    kw = dict(k=40, L=24, oversample=1)
    wd, wp = _ref_probe(graphs, Q, payloads, **kw)
    gd, gp = _port_probe(graphs, Q, payloads, **kw)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    np.testing.assert_allclose(gd[np.isfinite(gd)], wd[np.isfinite(wd)], rtol=1e-5, atol=1e-5)
    assert (gp == -1).any() and np.isinf(gd[gp == -1]).all()
    for d, p in zip(gd, gp):
        live = p[np.isfinite(d)]
        assert len(set(live.tolist())) == len(live) and set(live.tolist()) <= set(range(11))


def test_device_probe_keeps_beam_runners(ref_graphs):
    """One runner per (shard, query shape, L) across probes, rebuilt when the
    index's tensors are replaced (on a card each holds a CUDA graph)."""
    from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn

    _, graphs, payloads, Q = ref_graphs
    idx = DeviceAnnIndex.from_graphs(graphs, payloads=payloads, device="cpu")
    probe = make_probe_fn(k=10, L=24, device="cpu")
    first = probe(idx, Q)
    runners = {key: beam for key, (_, beam) in idx._beams.items()}
    assert len(runners) == 2
    again = probe(idx, Q)
    assert all(idx._beams[key][1] is beam for key, beam in runners.items())
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    idx.vectors = idx.vectors.clone()
    probe(idx, Q)
    assert all(idx._beams[key][1] is not beam for key, beam in runners.items())


def test_device_probe_refuses_missing_cuda(ref_graphs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from repro_torch.serving.device_index import DeviceAnnIndex, make_probe_fn

    _, graphs, _, _ = ref_graphs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_probe_fn(k=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceAnnIndex.from_graphs(graphs)


# -- an append made outside the coordinator ----------------------------------


def test_semantic_cache_serves_an_append_at_once(tmp_path):
    """A cached query whose exact copy is then appended (no refresh, no
    coordinator commit): the port's batcher returns the new row first at
    distance ~0 through the fresh tail.  The reference's batcher, on the
    same catalog, still serves the pre-append answer from its semantic
    cache (its watermark moves only on coordinator commits and drained
    reports), a caveat ROADMAP records."""
    from conftest import clustered_vectors
    from repro.lakehouse.table import LakehouseTable as RefTable
    from repro.runtime.cluster import make_local_cluster as ref_cluster
    from repro.runtime.coordinator import IndexConfig as RefConfig
    from repro.serving.cache import SemanticResultCache as RefSemantic
    from repro.serving.serve_loop import ProbeMicroBatcher as RefBatcher
    from repro_torch.runtime.cluster import make_local_cluster as port_cluster
    from repro_torch.serving.cache import SemanticResultCache

    rng = np.random.default_rng(4)
    X, _ = clustered_vectors(rng, n_clusters=6, per_cluster=100, dim=16)
    ref = ref_cluster(str(tmp_path), num_executors=2)
    table = RefTable(ref.catalog, "emb")
    table.create(dim=16)
    table.append_vectors(X, num_files=3, rows_per_group=100)
    ref.coordinator.create_index(
        "emb", RefConfig(name="idx", R=12, L=24, build_passes=1, build_batch=128))
    port = port_cluster(str(tmp_path), num_executors=2, device="cpu")
    q = (X[7] + 0.5).astype(np.float32)
    with RefBatcher(ref.coordinator, "emb", strategy="diskann", max_wait_s=0.001,
                    semantic_cache=RefSemantic()) as rmb, \
            ProbeMicroBatcher(port.coordinator, "emb", strategy="diskann", max_wait_s=0.001,
                              semantic_cache=SemanticResultCache()) as pmb:
        before = pmb.submit(q, 5).result(timeout=60)
        ref_before = rmb.submit(q, 5).result(timeout=60)
        assert [h.file_path for h in before] == [h.file_path for h in ref_before]
        rows = np.concatenate([q[None, :], rng.normal(size=(63, 16)).astype(np.float32)])
        table.append_vectors(rows, num_files=1, rows_per_group=64, file_prefix="late")
        new_file = table.current_files()[-1].path
        after = pmb.submit(q, 5).result(timeout=60)
        ref_after = rmb.submit(q, 5).result(timeout=60)
    assert (after[0].file_path, after[0].row_group, after[0].row_offset) == (new_file, 0, 0)
    assert after[0].distance < 1e-4
    assert pmb.stats.semantic_hits == 0
    # the reference's stale answer: the pre-append hits, from its cache
    assert rmb.stats.semantic_hits == 1
    assert [(h.file_path, h.row_offset) for h in ref_after] == [
        (h.file_path, h.row_offset) for h in ref_before]


# -- the port's serving modules never load jax or repro -----------------------


def test_serving_leaves_jax_and_repro_unloaded(tmp_path):
    code = f"""
import sys, numpy as np
import repro_torch.serving
from repro_torch.runtime.frontend import SqlFrontend
from repro_torch.lakehouse.table import LakehouseTable
from repro_torch.runtime.cluster import make_local_cluster
from repro_torch.core.vamana import VamanaParams, build_vamana
from repro_torch.serving import (DeviceAnnIndex, ProbeMicroBatcher, SemanticResultCache,
                                 ShardProbeCache, TenantPolicy, make_probe_fn)
rng = np.random.default_rng(0)
X = rng.normal(size=(600, 8)).astype(np.float32)
price = rng.integers(0, 100, size=600).astype(np.int64)
c = make_local_cluster({str(tmp_path)!r}, num_executors=2, device="cpu")
t = LakehouseTable(c.catalog, "emb"); t.create(dim=8)
t.append_vectors(X, num_files=2, attributes={{"price": price}})
fe = SqlFrontend(c.coordinator)
fe.execute("CREATE VECTOR INDEX i ON emb (vec) WITH (R=8, L=16, PQ_M=2, passes=1)")
c.coordinator.probe_cache = ShardProbeCache()
with ProbeMicroBatcher(c.coordinator, "emb", max_wait_s=0.001, semantic_cache=SemanticResultCache(),
                       tenant_policies={{"a": TenantPolicy(rate_qps=1e6)}}) as mb:
    fe.batcher = mb
    vec = ",".join(str(float(v)) for v in X[0])
    hits = fe.execute(f"SELECT * FROM emb WHERE price < 50 ORDER BY L2_DISTANCE(vec, [{{vec}}]) LIMIT 4")
    assert len(hits) == 4, hits
    for rep in range(2):
        futs = [mb.submit(X[i], 4, tenant="a", deadline_ms=60000) for i in range(3)]
        assert [len(f.result()) for f in futs] == [4] * 3
    assert mb.stats.semantic_hits == 3, mb.stats
g = build_vamana(X[:300], VamanaParams(R=8, L=16), passes=1, device="cpu")
idx = DeviceAnnIndex.from_graphs([g, g], payloads=[np.arange(300), np.arange(300, 600)], device="cpu")
d, p = make_probe_fn(k=4, L=16, device="cpu")(idx, X[:3])
assert tuple(p.shape) == (3, 4)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", bad)
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": SRC},
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
