"""The reference's ``tests/test_probe_batch.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU.

Batched multi-query probe pipeline (probe_batch + coalescing).

The contract under test: ``probe_batch(Q)`` returns, per query, exactly the
hits of ``probe(q)`` — same locations in the same order, same distances —
while the scheduler dispatches at most ONE shard-probe fragment per shard
for the whole batch (instead of B × shards).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from _torch_cpu import built_cluster  # noqa: E402,F401
from repro_torch.runtime.frontend import SqlFrontend  # noqa: E402
from repro_torch.serving.serve_loop import ProbeMicroBatcher  # noqa: E402


def _locs(hits):
    return [(h.file_path, h.row_group, h.row_offset) for h in hits]


def _dists(hits):
    return np.asarray([h.distance for h in hits], np.float64)


def _assert_same_hits(seq_hits, batch_hits):
    """Per query: identical ordered locations, distances to float tolerance.

    The batched rerank scores a different candidate-matrix shape, and the
    f32 ``q² − 2qx + x²`` expansion has an absolute noise floor of roughly
    ``|q|² · eps`` (~1e-4 at this data scale), so distances are compared to
    1e-3 absolute while locations must match exactly."""
    assert len(seq_hits) == len(batch_hits)
    for a, b in zip(seq_hits, batch_hits):
        assert _locs(a) == _locs(b)
        np.testing.assert_allclose(_dists(a), _dists(b), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("strategy,kw", [
    ("diskann", {}),
    ("centroid", {"n_probe": 4}),
    ("scan", {}),
])
def test_batch_equals_sequential(built_cluster, strategy, kw):
    c, t, X, centers, rep = built_cluster
    rng = np.random.default_rng(7)
    Q = X[rng.choice(len(X), 6)] + 0.05 * rng.normal(size=(6, 32)).astype(np.float32)
    seq = [c.coordinator.probe("emb", Q[i], 5, strategy=strategy, **kw).hits[0]
           for i in range(len(Q))]
    br = c.coordinator.probe_batch("emb", Q, 5, strategy=strategy, **kw)
    assert br.batch_size == len(Q)
    _assert_same_hits(seq, br.hits)


# k ≤ 8 keeps k·oversample ≤ L=32 (the reference's bound, kept)
@settings(max_examples=8, deadline=None)
@given(
    b=st.integers(1, 6),
    k=st.integers(1, 8),
    strategy=st.sampled_from(["centroid", "diskann"]),
    seed=st.integers(0, 10_000),
)
def test_property_batch_equals_sequential(built_cluster, b, k, strategy, seed):
    """Property: for any batch size, k, and probe strategy, the batched
    pipeline is indistinguishable from per-query probes."""
    c, t, X, centers, rep = built_cluster
    rng = np.random.default_rng(seed)
    Q = X[rng.choice(len(X), b)] + 0.05 * rng.normal(size=(b, 32)).astype(np.float32)
    seq = [c.coordinator.probe("emb", Q[i], k, strategy=strategy).hits[0]
           for i in range(b)]
    br = c.coordinator.probe_batch("emb", Q, k, strategy=strategy)
    _assert_same_hits(seq, br.hits)


def test_batch_probe_coalesces_fragments(built_cluster):
    """B queries × S shards of per-(query, shard) fragments must reach the
    executors as ≤ S coalesced fragments."""
    c, t, X, centers, rep = built_cluster
    stats = c.coordinator.scheduler.stats
    B = 16
    Q = X[:B]
    offered0 = stats.probe_fragments_offered
    coalesced0 = stats.probe_fragments_coalesced
    br = c.coordinator.probe_batch("emb", Q, 5, strategy="diskann")
    assert 1 <= br.probe_fragments <= rep.num_shards
    offered = stats.probe_fragments_offered - offered0
    assert offered == B * rep.num_shards  # full routing: one per (query, shard)
    assert stats.probe_fragments_coalesced - coalesced0 == offered - br.probe_fragments
    assert all(len(h) == 5 for h in br.hits)


def test_batch_probe_shard_routing(built_cluster):
    """n_route restricts each query to the shards owning its nearest
    partitions; results still return k hits per query."""
    c, t, X, centers, rep = built_cluster
    Q = X[:6]
    br = c.coordinator.probe_batch("emb", Q, 5, strategy="diskann", n_route=1)
    assert br.probe_fragments <= rep.num_shards
    assert all(len(h) == 5 for h in br.hits)
    # routed probes read no more than the full-fanout probe
    full = c.coordinator.probe_batch("emb", Q, 5, strategy="diskann")
    assert br.probe_fragments <= full.probe_fragments


def test_micro_batcher_matches_direct(built_cluster):
    c, t, X, centers, rep = built_cluster
    Q = X[:8]
    direct = c.coordinator.probe_batch("emb", Q, 5).hits
    with ProbeMicroBatcher(c.coordinator, "emb", max_batch=8, max_wait_s=0.1) as mb:
        hits = mb.probe_many(Q, k=5)
    _assert_same_hits(direct, hits)
    assert mb.stats.queries == len(Q)
    # concurrent submissions actually coalesced into few batch probes
    assert mb.stats.batches <= 2
    assert mb.stats.max_batch_seen >= 4


def test_frontend_execute_many_batches(built_cluster):
    c, t, X, centers, rep = built_cluster
    fe = SqlFrontend(c.coordinator)
    qs = [",".join(str(float(v)) for v in X[i]) for i in range(5)]
    sqls = [f"SELECT * FROM emb ORDER BY L2_DISTANCE(vec, [{q}]) LIMIT 5" for q in qs]
    stats = c.coordinator.scheduler.stats
    d0 = stats.dispatched
    batched = fe.execute_many(sqls)
    frags_batched = stats.dispatched - d0
    d0 = stats.dispatched
    single = [fe.execute(s) for s in sqls]
    frags_single = stats.dispatched - d0
    _assert_same_hits(single, batched)
    assert frags_batched < frags_single  # the whole block shared one wave


def test_frontend_batcher_attachment(built_cluster):
    c, t, X, centers, rep = built_cluster
    q = ",".join(str(float(v)) for v in X[3])
    sql = f"SELECT * FROM emb ORDER BY L2_DISTANCE(vec, [{q}]) LIMIT 4"
    plain = SqlFrontend(c.coordinator).execute(sql)
    with ProbeMicroBatcher(c.coordinator, "emb", max_wait_s=0.01) as mb:
        via_batcher = SqlFrontend(c.coordinator, batcher=mb).execute(sql)
    _assert_same_hits([plain], [via_batcher])


def test_micro_batcher_adaptive_sizing():
    """Adaptive sizing unit contract: a full drain with backlog doubles
    max_batch (up to the cap), a light drain with an idle queue halves it
    (down to the floor), steady state holds."""
    from concurrent.futures import Future

    from repro_torch.runtime.coordinator import ProbeReport

    class _StubCoordinator:
        def probe_batch(self, table, queries, k, **kw):
            return ProbeReport(
                hits=[[] for _ in range(queries.shape[0])],
                strategy="stub", files_scanned=0, bytes_read=0,
            )

    mb = ProbeMicroBatcher(
        _StubCoordinator(), "t", max_batch=8, adaptive=True,
        min_batch=2, max_batch_cap=64,
    )
    mb._adapt(8, 4)
    assert mb.max_batch == 16 and mb.stats.grows == 1
    mb._adapt(16, 1)
    assert mb.max_batch == 32
    mb._adapt(20, 0)            # steady state: no resize
    assert mb.max_batch == 32
    mb._adapt(4, 0)
    assert mb.max_batch == 16 and mb.stats.shrinks == 1
    for _ in range(4):
        mb._adapt(1, 0)
    assert mb.max_batch == 2     # floored at min_batch
    mb.max_batch = 64
    mb._adapt(64, 10)
    assert mb.max_batch == 64    # capped at max_batch_cap

    # end-to-end: a pre-filled backlog grows the window on the first drains
    mb2 = ProbeMicroBatcher(
        _StubCoordinator(), "t", max_batch=4, adaptive=True,
        min_batch=2, max_batch_cap=64, max_wait_s=0.01,
    )
    from repro_torch.serving.serve_loop import _Submission

    futs = []
    for i in range(40):
        f = Future()
        mb2._queue.put(_Submission(np.zeros(4, np.float32), 5, None, f))
        futs.append(f)
    with mb2:
        for f in futs:
            assert f.result(timeout=5.0) == []
    assert mb2.stats.grows >= 1
    assert mb2.max_batch > 4


def test_micro_batcher_bounded_queue_fails_fast():
    """max_queue backpressure: a submit that finds the queue full raises
    queue.Full immediately (counted in stats.rejected) instead of growing
    the backlog — probes already queued are unaffected."""
    import queue as queue_mod
    import threading

    from repro_torch.runtime.coordinator import ProbeReport

    gate = threading.Event()
    entered = threading.Event()

    class _SlowCoordinator:
        def probe_batch(self, table, queries, k, **kw):
            entered.set()
            gate.wait(timeout=5.0)
            return ProbeReport(
                hits=[[] for _ in range(queries.shape[0])],
                strategy="stub", files_scanned=0, bytes_read=0,
            )

    mb = ProbeMicroBatcher(
        _SlowCoordinator(), "t", max_batch=1, max_wait_s=0.0, max_queue=2,
    )
    q = np.zeros(4, np.float32)
    with mb:
        f0 = mb.submit(q, k=5)          # drained, blocks inside probe_batch
        assert entered.wait(timeout=5.0)
        f1, f2 = mb.submit(q, k=5), mb.submit(q, k=5)  # fill the queue
        with pytest.raises(queue_mod.Full):
            mb.submit(q, k=5)
        assert mb.stats.rejected == 1
        gate.set()
        for f in (f0, f1, f2):
            assert f.result(timeout=5.0) == []
    assert mb.stats.queries == 3        # the rejected probe never ran


def test_micro_batcher_background_tail_compaction():
    """compact_tail_over: a drained batch reporting that many tail rows
    kicks off exactly one background Coordinator.compact_tail, off the
    serving path; below the threshold nothing happens."""
    import threading

    from repro_torch.runtime.coordinator import ProbeReport

    compacted = threading.Event()

    class _TailCoordinator:
        def __init__(self, tail_rows):
            self.tail_rows = tail_rows
            self.calls = []

        def probe_batch(self, table, queries, k, **kw):
            return ProbeReport(
                hits=[[] for _ in range(queries.shape[0])],
                strategy="stub", files_scanned=0, bytes_read=0,
                tail_rows=self.tail_rows,
            )

        def compact_tail(self, table, index, *, threshold_rows):
            self.calls.append((table, index, threshold_rows))
            compacted.set()

    q = np.zeros(4, np.float32)
    coord = _TailCoordinator(tail_rows=128)
    with ProbeMicroBatcher(
        coord, "t", max_wait_s=0.01, compact_tail_over=100, index_name="idx"
    ) as mb:
        assert mb.submit(q, k=5).result(timeout=5.0) == []
        assert compacted.wait(timeout=5.0)
    assert coord.calls == [("t", "idx", 100)]
    assert mb.stats.compactions == 1

    # below the threshold the policy stays quiet
    coord2 = _TailCoordinator(tail_rows=10)
    with ProbeMicroBatcher(
        coord2, "t", max_wait_s=0.01, compact_tail_over=100, index_name="idx"
    ) as mb2:
        assert mb2.submit(q, k=5).result(timeout=5.0) == []
    assert coord2.calls == [] and mb2.stats.compactions == 0

    # the policy needs to know which index to fold into
    with pytest.raises(ValueError):
        ProbeMicroBatcher(coord, "t", compact_tail_over=100)
