"""The port's serving-tier cache hierarchy: ``tests/test_cache.py`` run
against ``repro_torch.serving.cache`` and a cluster the port builds on the
CPU.

The same invariants: LRU byte-bound eviction, snapshot invalidation on
refresh, time-travel isolation, bit-parity on every shard-cache hit, the
semantic layer's exact and thresholded lookups, tenant scoping, watermark
invalidation and admission interplay, the degraded-k rule, and exact hit
accounting under concurrent submission.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serving.cache import (  # noqa: E402
    SemanticResultCache,
    ShardProbeCache,
    query_digest,
)

pytestmark = pytest.mark.cache


# ---------------------------------------------------------------- unit: LRU


class _Cand:
    """Stand-in for fragments.ProbeCandidate in pure-unit cases."""

    def __init__(self, file_path="f.parquet", dist=0.0):
        self.file_path = file_path
        self.approx_distance = dist


def _key(i, snapshot_id=1, table="t"):
    return (table, snapshot_id, i, None, (10, 32, False, 4), None, bytes([i]))


def test_shard_cache_lru_byte_bound_eviction():
    cache = ShardProbeCache(max_bytes=2000)
    for i in range(20):
        cache.put(
            _key(i),
            [_Cand()] * 4,
            table_name="t",
            snapshot_id=1,
            served_by="ex-0",
        )
        assert cache.total_bytes <= cache.max_bytes
    assert cache.stats.evictions > 0
    assert len(cache) < 20
    # LRU order: the survivors are the most recently inserted keys
    surviving = {k for k, _ in cache.entries_snapshot()}
    assert _key(19) in surviving
    assert _key(0) not in surviving


def test_shard_cache_get_refreshes_lru_position():
    cache = ShardProbeCache(max_bytes=10_000)
    for i in range(5):
        cache.put(_key(i), [_Cand()], table_name="t", snapshot_id=1, served_by="e")
    cache.get(_key(0))  # touch the oldest
    order = [k for k, _ in cache.entries_snapshot()]
    assert order[-1] == _key(0)


def test_shard_cache_oversized_entry_is_skipped():
    cache = ShardProbeCache(max_bytes=200)
    cache.put(
        _key(0),
        [_Cand("x" * 500)],
        table_name="t",
        snapshot_id=1,
        served_by="e",
    )
    assert len(cache) == 0  # one entry would evict the whole cache


def test_shard_cache_invalidate_is_identity_not_ordering():
    cache = ShardProbeCache(max_bytes=10_000)
    # snapshot ids are random — a "newer" snapshot may have a SMALLER id
    cache.put(_key(0, snapshot_id=999), [_Cand()], table_name="t",
              snapshot_id=999, served_by="e")
    cache.put(_key(1, snapshot_id=5), [_Cand()], table_name="t",
              snapshot_id=5, served_by="e")
    cache.put(_key(2, snapshot_id=5, table="other"), [_Cand()],
              table_name="other", snapshot_id=5, served_by="e")
    dropped = cache.invalidate("t", 5)  # 5 is now current for table "t"
    assert dropped == 1  # only the id-999 entry for "t"
    assert cache.stats.invalidations == 1
    surviving = {k for k, _ in cache.entries_snapshot()}
    assert _key(1, snapshot_id=5) in surviving
    assert _key(2, snapshot_id=5, table="other") in surviving


# ------------------------------------------------------- unit: semantic layer


def _hits(n=3):
    return [("f.parquet", 0, i) for i in range(n)]


def test_semantic_exact_duplicate_fast_path():
    sem = SemanticResultCache(max_bytes=1 << 16)
    q = np.arange(8, dtype=np.float32)
    sem.observe_snapshot(7)
    sem.put("a", q, 10, None, _hits(), snapshot_id=7)
    hit = sem.lookup("a", q.copy(), 10, None)
    assert hit is not None and hit.hits == _hits()
    assert sem.stats.hits == 1
    # different k or filter is a different scope — never a hit
    assert sem.lookup("a", q, 5, None) is None
    assert sem.lookup("a", q, 10, "price < 30") is None


def test_semantic_distance_threshold():
    sem = SemanticResultCache(max_bytes=1 << 16, distance_threshold=0.5)
    q = np.zeros(8, np.float32)
    sem.observe_snapshot(7)
    sem.put("a", q, 10, None, _hits(), snapshot_id=7)
    near = q + 0.1  # ||near - q|| ≈ 0.28 < 0.5
    far = q + 1.0   # ||far - q|| ≈ 2.8 > 0.5
    assert sem.lookup("a", near, 10, None) is not None
    assert sem.lookup("a", far, 10, None) is None


def test_semantic_tenant_scoping():
    sem = SemanticResultCache(max_bytes=1 << 16, distance_threshold=10.0)
    q = np.zeros(8, np.float32)
    sem.observe_snapshot(7)
    sem.put("tenant_a", q, 10, None, _hits(), snapshot_id=7)
    assert sem.lookup("tenant_b", q, 10, None) is None
    assert sem.lookup("tenant_a", q, 10, None) is not None


def test_semantic_snapshot_watermark_invalidation():
    sem = SemanticResultCache(max_bytes=1 << 16)
    q = np.zeros(8, np.float32)
    sem.observe_snapshot(7)
    sem.put("a", q, 10, None, _hits(), snapshot_id=7)
    assert sem.lookup("a", q, 10, None) is not None
    # a refresh committed: reports now carry a new (random) id
    dropped = sem.observe_snapshot(3)
    assert dropped == 1 and sem.stats.invalidations == 1
    assert sem.lookup("a", q, 10, None) is None
    assert len(sem) == 0


def test_semantic_byte_bound_eviction():
    sem = SemanticResultCache(max_bytes=3000)
    sem.observe_snapshot(1)
    for i in range(20):
        q = np.full(32, float(i), np.float32)
        sem.put("a", q, 10, None, _hits(), snapshot_id=1)
        assert sem.total_bytes <= sem.max_bytes
    assert sem.stats.evictions > 0 and len(sem) < 20
    # the most recent entry survived, the oldest did not
    assert sem.lookup("a", np.full(32, 19.0, np.float32), 10, None) is not None
    assert sem.lookup("a", np.full(32, 0.0, np.float32), 10, None) is None


# ------------------------------------------------- integration: shard layer


@pytest.fixture(scope="module")
def cache_cluster(tmp_path_factory):
    """Module-own port cluster + index, built by the port on the CPU
    (refresh tests mutate it)."""
    import numpy as np

    from repro_torch.lakehouse.table import LakehouseTable
    from repro_torch.runtime.cluster import make_local_cluster
    from repro_torch.runtime.coordinator import IndexConfig

    from conftest import BUILT_CFG, clustered_vectors

    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("cache_cluster")
    c = make_local_cluster(str(root), num_executors=3, device="cpu")
    X, _ = clustered_vectors(rng, n_clusters=24, per_cluster=80)
    t = LakehouseTable(c.catalog, "emb")
    t.create(dim=X.shape[1])
    cats = rng.choice(["news", "blog", "docs"], size=len(X))
    price = rng.integers(1, 100, size=len(X))
    t.append_vectors(
        X,
        num_files=9,
        rows_per_group=128,
        attributes={"category": cats, "price": price},
    )
    c.coordinator.create_index("emb", IndexConfig(name="idx", **BUILT_CFG))
    dim = X.shape[1]
    Q = X[rng.choice(len(X), 6)] + 0.05 * rng.normal(size=(6, dim)).astype(
        np.float32
    )
    return c, t, X, Q.astype(np.float32), rng


def _locs(report):
    return [
        [(h.file_path, h.row_group, h.row_offset) for h in hits]
        for hits in report.hits
    ]


def test_shard_cache_hit_is_bit_parity_and_skips_dispatch(cache_cluster):
    c, t, X, Q, rng = cache_cluster
    cache = ShardProbeCache(max_bytes=8 << 20)
    c.coordinator.probe_cache = None
    off = c.coordinator.probe_batch("emb", Q, 10, strategy="diskann")
    try:
        c.coordinator.probe_cache = cache
        warm1 = c.coordinator.probe_batch("emb", Q, 10, strategy="diskann")
        warm2 = c.coordinator.probe_batch("emb", Q, 10, strategy="diskann")
    finally:
        c.coordinator.probe_cache = None
    # non-repeating traffic: the caching pass is bit-identical to cache-off
    assert _locs(warm1) == _locs(off)
    assert warm1.shard_cache_hits == 0
    # repeat traffic: every Stage-A fragment served from cache, same bits
    assert _locs(warm2) == _locs(off)
    assert warm2.shard_cache_hits > 0
    assert warm2.cache == "shard"
    assert warm1.cache is None
    # a fully-cached Stage A dispatches no shard-probe fragments
    assert warm2.probe_fragments < warm1.probe_fragments
    assert cache.stats.hits == warm2.shard_cache_hits


def test_shard_cache_filtered_hit_parity(cache_cluster):
    c, t, X, Q, rng = cache_cluster
    cache = ShardProbeCache(max_bytes=8 << 20)
    pred = "category = 'news'"
    c.coordinator.probe_cache = None
    off = c.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=pred)
    try:
        c.coordinator.probe_cache = cache
        c.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=pred)
        warm = c.coordinator.probe_batch("emb", Q, 10, strategy="diskann", filter=pred)
    finally:
        c.coordinator.probe_cache = None
    assert _locs(warm) == _locs(off)
    assert warm.shard_cache_hits > 0
    # the predicate is part of the key: an unfiltered repeat cannot hit
    try:
        c.coordinator.probe_cache = cache
        other = c.coordinator.probe_batch("emb", Q, 10, strategy="diskann")
    finally:
        c.coordinator.probe_cache = None
    assert other.shard_cache_hits == 0


def test_invalidation_on_refresh_no_stale_hits(cache_cluster):
    c, t, X, Q, rng = cache_cluster
    cache = ShardProbeCache(max_bytes=8 << 20)
    try:
        c.coordinator.probe_cache = cache
        c.coordinator.probe_batch("emb", Q, 10, strategy="diskann")  # warm
        assert len(cache) > 0
        tail = rng.normal(size=(96, 32)).astype(np.float32)
        t.append_vectors(
            tail,
            num_files=1,
            rows_per_group=96,
            attributes={
                "category": np.array(["news"] * 96),
                "price": np.full(96, 50),
            },
        )
        c.coordinator.refresh_index("emb", "idx")
        assert cache.stats.invalidations > 0
        # post-refresh probe: zero stale hits, exact parity with cache-off
        warm = c.coordinator.probe_batch("emb", Q, 10, strategy="diskann")
        assert warm.shard_cache_hits == 0
        c.coordinator.probe_cache = None
        off = c.coordinator.probe_batch("emb", Q, 10, strategy="diskann")
        assert _locs(warm) == _locs(off)
    finally:
        c.coordinator.probe_cache = None


def test_time_travel_probe_does_not_hit_newer_snapshot(cache_cluster):
    c, t, X, Q, rng = cache_cluster
    # snapshot history: this test runs after the refresh test (module
    # order), but derives its own old/new pair to stay order-independent
    meta = t.metadata()
    old_sid = meta.current_snapshot_id
    t.append_vectors(
        rng.normal(size=(96, 32)).astype(np.float32),
        num_files=1,
        rows_per_group=96,
        attributes={
            "category": np.array(["blog"] * 96),
            "price": np.full(96, 10),
        },
    )
    c.coordinator.refresh_index("emb", "idx")
    cache = ShardProbeCache(max_bytes=8 << 20)
    try:
        c.coordinator.probe_cache = cache
        # warm the cache against the CURRENT snapshot
        c.coordinator.probe_batch("emb", Q, 10, strategy="diskann")
        assert len(cache) > 0
        # a time-travel probe of the old snapshot: its keys carry the old
        # id, so nothing the current snapshot cached can serve it
        tt = c.coordinator.probe_batch(
            "emb", Q, 10, strategy="diskann", snapshot_id=old_sid
        )
        assert tt.shard_cache_hits == 0
        c.coordinator.probe_cache = None
        off = c.coordinator.probe_batch(
            "emb", Q, 10, strategy="diskann", snapshot_id=old_sid
        )
        assert _locs(tt) == _locs(off)
        # repeats of the SAME old snapshot may hit its own entries — same
        # snapshot means same data, so that is correct, and still parity
        c.coordinator.probe_cache = cache
        tt2 = c.coordinator.probe_batch(
            "emb", Q, 10, strategy="diskann", snapshot_id=old_sid
        )
        assert tt2.shard_cache_hits > 0
        assert _locs(tt2) == _locs(off)
    finally:
        c.coordinator.probe_cache = None


# --------------------------------------------- integration: semantic layer


def test_semantic_hit_skips_admission_token(cache_cluster):
    from repro_torch.serving.admission import AdmissionRejected, TenantPolicy
    from repro_torch.serving.serve_loop import ProbeMicroBatcher

    c, t, X, Q, rng = cache_cluster
    sem = SemanticResultCache(max_bytes=1 << 20)
    with ProbeMicroBatcher(
        c.coordinator,
        "emb",
        strategy="diskann",
        max_wait_s=0.001,
        tenant_policies={"a": TenantPolicy(rate_qps=0.001, burst=1.0)},
        semantic_cache=sem,
    ) as mb:
        first = mb.submit(Q[0], 10, tenant="a").result()  # spends the only token
        # the exact repeat is answered at the door — no token consumed
        again = mb.submit(Q[0], 10, tenant="a").result()
        assert [
            (h.file_path, h.row_group, h.row_offset) for h in again
        ] == [(h.file_path, h.row_group, h.row_offset) for h in first]
        assert mb.stats.semantic_hits == 1
        # a fresh query still needs a token the bucket doesn't have
        with pytest.raises(AdmissionRejected):
            mb.submit(Q[1], 10, tenant="a")


def test_degraded_answer_cached_under_degraded_k(cache_cluster):
    from repro_torch.serving.admission import DegradationPolicy, ShrinkK
    from repro_torch.serving.serve_loop import ProbeMicroBatcher

    c, t, X, Q, rng = cache_cluster
    sem = SemanticResultCache(max_bytes=1 << 20)
    # degrade-on: the answer comes back at k_eff = 5, cached under k=5
    with ProbeMicroBatcher(
        c.coordinator,
        "emb",
        strategy="diskann",
        max_wait_s=0.001,
        degradation=DegradationPolicy(steps=(ShrinkK(),)),
        force_degrade="on",
        semantic_cache=sem,
    ) as mb:
        degraded = mb.submit(Q[0], 10, tenant="a").result()
        assert len(degraded) == 5
    # degrade-off, same cache, same query at full k: the degraded answer
    # must NOT be served — the k=10 lookup misses and a real probe answers
    with ProbeMicroBatcher(
        c.coordinator,
        "emb",
        strategy="diskann",
        max_wait_s=0.001,
        semantic_cache=sem,
    ) as mb:
        full = mb.submit(Q[0], 10, tenant="a").result()
        assert len(full) == 10
        assert mb.stats.semantic_hits == 0
    # the degraded answer is still present — under its DEGRADED k
    q0 = np.asarray(Q[0], np.float32)
    assert sem.lookup("a", q0, 5, None) is not None
    entry = sem.lookup("a", q0, 5, None)
    assert entry.report is not None and entry.report.cache == "semantic"


def test_semantic_invalidation_on_refresh(cache_cluster):
    from repro_torch.serving.serve_loop import ProbeMicroBatcher

    c, t, X, Q, rng = cache_cluster
    sem = SemanticResultCache(max_bytes=1 << 20)
    with ProbeMicroBatcher(
        c.coordinator,
        "emb",
        strategy="diskann",
        max_wait_s=0.001,
        semantic_cache=sem,
    ) as mb:
        mb.submit(Q[0], 10, tenant="a").result()
        assert len(sem) == 1
        t.append_vectors(
            rng.normal(size=(96, 32)).astype(np.float32),
            num_files=1,
            rows_per_group=96,
            attributes={
                "category": np.array(["docs"] * 96),
                "price": np.full(96, 20),
            },
        )
        c.coordinator.refresh_index("emb", "idx")
        # the next drained report carries the new snapshot id → watermark
        # moves, pre-refresh answers are evicted, the repeat re-probes
        fresh = mb.submit(Q[0], 10, tenant="a").result()
        assert mb.stats.semantic_hits == 0
        assert mb.stats.cache_invalidations >= 1
        assert sem.stats.invalidations >= 1
        # the fresh answer matches a cache-off probe exactly
        rep = c.coordinator.probe_batch(
            "emb", Q[0][None, :], 10, strategy="diskann"
        )
        assert [
            (h.file_path, h.row_group, h.row_offset) for h in fresh
        ] == [(h.file_path, h.row_group, h.row_offset) for h in rep.hits[0]]


def test_concurrent_submit_hit_accounting(cache_cluster):
    from repro_torch.serving.serve_loop import ProbeMicroBatcher

    c, t, X, Q, rng = cache_cluster
    sem = SemanticResultCache(max_bytes=1 << 20)
    with ProbeMicroBatcher(
        c.coordinator,
        "emb",
        strategy="diskann",
        max_wait_s=0.001,
        semantic_cache=sem,
    ) as mb:
        prime = mb.submit(Q[0], 10, tenant="a").result()
        results = []
        errs = []

        def worker():
            try:
                results.append(mb.submit(Q[0], 10, tenant="a").result(timeout=30))
            except Exception as e:  # pragma: no cover - failure detail
                errs.append(e)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        assert not errs
        assert len(results) == 8
        ref = [(h.file_path, h.row_group, h.row_offset) for h in prime]
        for got in results:
            assert [(h.file_path, h.row_group, h.row_offset) for h in got] == ref
        # every submission is accounted exactly once: the priming miss plus
        # eight lookups, each a hit or a miss, nothing double-counted
        assert mb.stats.semantic_hits + mb.stats.semantic_misses == 9
        assert mb.stats.semantic_hits == 8
        assert sem.stats.hits == 8


def test_query_digest_is_content_addressed():
    q = np.arange(16, dtype=np.float32)
    assert query_digest(q) == query_digest(q.copy())
    assert query_digest(q) != query_digest(q + 1e-6)
