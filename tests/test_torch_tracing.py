"""The port's span log (``repro_torch.serving.metrics``) on the probe path.

A small table and its DiskANN index (PQ codes, two executors) are built
once on the CPU; each test opens its own cluster on them, so every test
starts with the executors' in-memory caches and beam runners empty, and
serves batches through a ``ProbeMicroBatcher`` as the serving tier does.

- Off (the default), a batch records nothing and every site gets the one
  shared no-op span.
- On, one batch records every span of the probe path; each child lies
  inside its parent, and the executors' spans reach their batch's Stage A
  or Stage B through ``scheduler.task``.
- ``ProbeReport.stage_*_seconds`` are the stage spans' own durations.
- A second batch at the same shapes builds no beam runner.
- A full collection is a ``gc.collect`` span, and ``disable()`` takes the
  collector's callback away.
"""

import gc
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import device_cache  # noqa: E402
from repro_torch.runtime.cluster import make_local_cluster  # noqa: E402
from repro_torch.serving import metrics as spans  # noqa: E402
from repro_torch.serving.serve_loop import ProbeMicroBatcher  # noqa: E402

DIM = 16
PROBE_PATH = {
    "batcher.flush", "probe.batch", "probe.plan", "probe.stage_a", "probe.stage_b",
    "probe.stage_c", "scheduler.wave", "scheduler.task", "shard.load", "shard.search",
    "shard.candidates", "device.lock_wait", "beam.build", "beam.run", "rerank.read",
    "rerank.score", "rerank.select",
}
STAGE_A_SPANS = {"shard.load", "shard.search", "shard.candidates", "beam.build", "beam.run"}
STAGE_B_SPANS = {"rerank.read", "rerank.score", "rerank.select"}


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    """A 1,200-row table of 16-d clustered vectors in 4 files, indexed as
    two PQ shards; returns (root, queries)."""
    from conftest import clustered_vectors
    from repro_torch.lakehouse.table import LakehouseTable
    from repro_torch.runtime.coordinator import IndexConfig

    root = str(tmp_path_factory.mktemp("tracing"))
    rng = np.random.default_rng(31)
    X, _ = clustered_vectors(rng, n_clusters=12, per_cluster=100, dim=DIM)
    c = make_local_cluster(root, num_executors=2, device="cpu")
    t = LakehouseTable(c.catalog, "emb")
    t.create(dim=DIM)
    t.append_vectors(X, num_files=4, rows_per_group=100)
    c.coordinator.create_index(
        "emb", IndexConfig(name="idx", R=12, L=24, pq_m=4, build_passes=1, build_batch=128))
    queries = (X[rng.choice(len(X), 12, replace=False)]
               + rng.normal(0, 0.05, (12, DIM))).astype(np.float32)
    return root, queries


@pytest.fixture()
def cluster(warehouse):
    root, _ = warehouse
    spans.disable()
    spans.drain()
    yield make_local_cluster(root, num_executors=2, device="cpu")
    spans.disable()
    spans.drain()


def _serve(coordinator, queries, k=5):
    """Every query submitted at once to a fresh batcher (one drain takes
    them all); the answers."""
    with ProbeMicroBatcher(coordinator, "emb", strategy="diskann", max_batch=len(queries),
                           max_wait_s=0.2) as mb:
        futs = [mb.submit(q, k) for q in queries]
        return [f.result(timeout=120) for f in futs]


def _traced(coordinator, queries, k=5):
    spans.enable()
    try:
        answers = _serve(coordinator, queries, k)
    finally:
        spans.disable()
    return answers, spans.drain()


def _ancestors(s):
    out = []
    while s.parent is not None:
        s = s.parent
        out.append(s)
    return out


def test_off_records_nothing_and_hands_out_the_shared_no_op(cluster, warehouse):
    _, queries = warehouse
    assert not spans.tracing
    answers = _serve(cluster.coordinator, queries)
    assert len(answers) == len(queries) and all(len(a) == 5 for a in answers)
    got = spans.drain()
    assert got.spans == [] and got.counters == {}
    assert spans.span("probe.plan") is spans.NO_SPAN
    assert spans.batch("probe.batch") is spans.NO_SPAN
    assert spans.current() is None
    assert device_cache.locked("cpu", "beam.run") is device_cache.device_lock("cpu")
    with spans.span("x") as s:
        s.set("rows", 3)
    gc.collect()  # the collector's callback is not installed while off
    assert spans.drain() == spans.Drained() and spans.NO_SPAN.seconds == 0.0


def test_on_records_every_probe_path_span_nested_in_its_parent(cluster, warehouse):
    _, queries = warehouse
    answers, got = _traced(cluster.coordinator, queries)
    assert answers == _serve(cluster.coordinator, queries)  # tracing changes no answer
    names = {s.name for s in got.spans}
    assert PROBE_PATH <= names, PROBE_PATH - names
    for s in got.spans:
        assert s.t0 <= s.t1
        if s.parent is not None:
            assert s.parent.t0 <= s.t0 and s.t1 <= s.parent.t1, (s, s.parent)
    flushes = [s for s in got.spans if s.name == "batcher.flush"]
    assert sum(f.attrs["queries"] for f in flushes) == len(queries)
    assert all(f.attrs["wait_s"] >= 0 for f in flushes)
    batches = {s.batch: s for s in got.spans if s.name == "probe.batch"}
    assert batches and all(b.parent in flushes for b in batches.values())
    for s in got.spans:
        if s.name not in STAGE_A_SPANS | STAGE_B_SPANS:
            continue
        up = [a.name for a in _ancestors(s)]
        assert "scheduler.task" in up and "scheduler.wave" in up, (s, up)
        stage = "probe.stage_a" if s.name in STAGE_A_SPANS else "probe.stage_b"
        assert up.index("scheduler.task") < up.index(stage), (s, up)
        assert s.batch in batches
        assert s.thread != batches[s.batch].thread  # an executor's worker thread
    for s in got.spans:
        if s.name in ("device.lock_wait", "beam.run"):
            assert s.parent.name == "shard.search", (s, s.parent)
        if s.name == "beam.build":
            assert s.parent.name == "beam.run"


def test_stage_seconds_are_the_stage_spans_durations(cluster, warehouse):
    _, queries = warehouse
    spans.enable()
    try:
        reports = [cluster.coordinator.probe_batch("emb", queries[i:i + 4], 5,
                                                   strategy="diskann") for i in (0, 4, 8)]
    finally:
        spans.disable()
    got = spans.drain()
    by_batch = {}
    for s in got.spans:
        if s.name.startswith("probe.stage_"):
            by_batch.setdefault(s.batch, {})[s.name] = s
    assert len(by_batch) == len(reports)
    for rep, stages in zip(reports, [by_batch[b] for b in sorted(by_batch)]):
        assert rep.stage_a_seconds == stages["probe.stage_a"].seconds > 0
        assert rep.stage_b_seconds == stages["probe.stage_b"].seconds > 0
        assert rep.stage_c_seconds == stages["probe.stage_c"].seconds > 0
        a, b, c = (stages[f"probe.stage_{x}"] for x in "abc")
        assert a.t1 <= b.t0 and b.t1 <= c.t0  # one after another, none inside another


def test_stage_timers_run_with_the_log_off(cluster, warehouse):
    _, queries = warehouse
    rep = cluster.coordinator.probe_batch("emb", queries[:4], 5, strategy="diskann")
    assert rep.stage_a_seconds > 0 and rep.stage_b_seconds > 0 and rep.stage_c_seconds > 0
    assert spans.drain().spans == []
    t = spans.timed("probe.stage_a")
    with t:
        pass
    assert t.seconds >= 0 and spans.drain().spans == []


def test_a_second_batch_at_the_same_shapes_builds_no_beam_runner(cluster, warehouse):
    _, queries = warehouse
    _, first = _traced(cluster.coordinator, queries)
    assert any(s.name == "beam.build" for s in first.spans)
    _, second = _traced(cluster.coordinator, queries[::-1].copy())
    names = [s.name for s in second.spans]
    assert "beam.run" in names and "beam.build" not in names


def test_full_collection_is_a_span_and_disable_removes_the_callback():
    spans.disable()
    spans.drain()
    spans.enable()
    try:
        assert spans._on_gc in gc.callbacks
        with spans.batch("probe.batch") as b:
            gc.collect()
    finally:
        spans.disable()
    assert spans._on_gc not in gc.callbacks
    got = spans.drain()
    full = [s for s in got.spans if s.name == "gc.collect"]
    assert full and full[0].attrs["generation"] == 2
    assert full[0].parent is b and full[0].batch == b.batch
    assert b.t0 <= full[0].t0 <= full[0].t1 <= b.t1
    assert set(got.counters) == {"gc.pause_s"}  # the log's one counter
    assert got.counters["gc.pause_s"] >= full[0].seconds > 0
    gc.collect()
    assert spans.drain().spans == []


def test_parent_passes_across_threads_and_batches_number_in_order():
    spans.disable()
    spans.drain()
    spans.enable()
    try:
        with spans.batch("probe.batch") as b1:
            parent = spans.current()
            th = threading.Thread(target=lambda: spans.span("scheduler.task", parent)
                                  .__enter__().__exit__(None, None, None))
            th.start()
            th.join()
        with spans.batch("probe.batch") as b2:
            pass
    finally:
        spans.disable()
    got = spans.drain()
    task = next(s for s in got.spans if s.name == "scheduler.task")
    assert parent is b1 and task.parent is b1 and task.batch == b1.batch
    assert task.thread != b1.thread
    assert b2.batch == b1.batch + 1
    assert spans.drain() == spans.Drained()


def test_many_threads_lose_no_span_counter_or_batch_id():
    import sys

    spans.disable()
    spans.drain()
    threads, each = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    spans.enable()
    try:
        def work():
            for _ in range(each):
                with spans.batch("probe.batch"):
                    with spans.span("shard.search") as s:
                        s.set("rows", 1)

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        spans.disable()
        sys.setswitchinterval(switch)
    got = spans.drain()
    assert len(got.spans) == 2 * threads * each
    assert sum(s.attrs.get("rows", 0) for s in got.spans) == threads * each
    batches = [s.batch for s in got.spans if s.name == "probe.batch"]
    assert len(set(batches)) == threads * each
    for s in got.spans:
        if s.name == "shard.search":
            assert s.parent.name == "probe.batch" and s.batch == s.parent.batch
            assert s.thread == s.parent.thread
