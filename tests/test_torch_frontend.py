"""The port's SQL front door and micro-batcher against the reference's.

- ``tests/test_frontend.py`` run against ``repro_torch.runtime.frontend`` on
  a cluster the port builds on the CPU: DDL parsing, the DDL / query round
  trip, threshold queries, refresh and drop.
- On a catalog ``repro`` builds: the port's ``SqlFrontend`` parses every
  statement to the reference's ``IndexDDLInfo`` or query tuple, executes
  the same SELECTs (top-k, filtered, threshold, ``execute_many``) to the
  reference's hits, and executes REFRESH and DROP on copies of the catalog
  to the reference's outcome; ``CREATE`` through each package's frontend on
  copies of an unindexed catalog gives the same shard and vector counts.
- The port's ``ProbeMicroBatcher`` gives, for each submitted query, the
  reference batcher's hits: filtered and unfiltered submissions, two k's,
  eight submitting threads.

Hits are held at equal row locations in equal order and distances within
1e-5 of |q|^2 + |x|^2 (Stage B scores in the expanded form; torch and XLA
sum in another order), as ``tests/test_torch_system.py`` holds them.
"""

import dataclasses
import os
import shutil
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import clustered_vectors  # noqa: E402
from repro.lakehouse.table import LakehouseTable as RefTable  # noqa: E402
from repro.runtime.cluster import make_local_cluster as ref_cluster  # noqa: E402
from repro.runtime.frontend import SqlFrontend as RefFrontend  # noqa: E402
from repro_torch.lakehouse.table import LakehouseTable  # noqa: E402
from repro_torch.runtime.cluster import make_local_cluster as port_cluster  # noqa: E402
from repro_torch.runtime.frontend import IndexDDLInfo, SqlError, SqlFrontend  # noqa: E402


@pytest.fixture(scope="module")
def fe(tmp_path_factory):
    rng = np.random.default_rng(0)
    c = port_cluster(str(tmp_path_factory.mktemp("sql")), num_executors=2, device="cpu")
    t = LakehouseTable(c.catalog, "docs")
    t.create(dim=16)
    X, _ = clustered_vectors(rng, n_clusters=8, per_cluster=100, dim=16)
    t.append_vectors(X, num_files=4, rows_per_group=128)
    return SqlFrontend(c.coordinator), X


def test_parse_create_with_options(fe):
    frontend, _ = fe
    stmt = frontend.parse(
        "CREATE VECTOR INDEX idx ON docs (vec) WITH (R=16, L=32, PQ_M=4, passes=1);"
    )
    assert isinstance(stmt, IndexDDLInfo)
    assert stmt.action == "create" and stmt.index_name == "idx"
    assert stmt.options["r"] == "16"


def test_parse_rejects_garbage(fe):
    frontend, _ = fe
    with pytest.raises(SqlError):
        frontend.parse("SELECT COUNT(*) FROM docs")


def test_ddl_and_query_roundtrip(fe):
    frontend, X = fe
    rep = frontend.execute(
        "CREATE VECTOR INDEX idx ON docs (vec) WITH (R=16, L=32, passes=1)"
    )
    assert rep.num_shards >= 1
    q = ",".join(str(float(v)) for v in X[0])
    hits = frontend.execute(f"SELECT * FROM docs ORDER BY L2_DISTANCE(vec, [{q}]) LIMIT 5")
    assert len(hits) == 5
    assert hits[0].distance < 1e-3  # the query point itself

    # threshold query: exact pruning bound, results all within the bound
    hits = frontend.execute(f"SELECT * FROM docs WHERE L2_DISTANCE(vec, [{q}]) < 2.0")
    assert hits, "neighbors within radius 2 exist (the point itself)"
    assert all(h.distance <= 4.0 + 1e-3 for h in hits)  # squared bound

    # refresh is a no-op right after build
    rr = frontend.execute("REFRESH INDEX idx ON docs")
    assert rr.noop

    # drop unbinds the statistics file
    frontend.execute("DROP INDEX idx ON docs")
    meta = frontend.coordinator.catalog.load_table("docs")
    assert meta.current_snapshot().statistics_file is None


# -- against the reference, on a catalog repro builds -------------------------

DIM = 16
CREATE = "CREATE VECTOR INDEX idx ON docs (vec) WITH (R=12, L=24, PQ_M=4, passes=1)"


def _ingest(table_cls, catalog, X, attrs):
    t = table_cls(catalog, "docs")
    t.create(dim=DIM)
    t.append_vectors(X, num_files=4, rows_per_group=128, attributes=attrs)
    return t


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    X, _ = clustered_vectors(rng, n_clusters=8, per_cluster=120, dim=DIM)
    attrs = {"price": rng.integers(0, 100, size=len(X)).astype(np.int64),
             "category": rng.choice(["news", "blog", "docs"], size=len(X))}
    Q = X[rng.choice(len(X), 12, replace=False)] + 0.05 * rng.normal(size=(12, DIM)).astype(np.float32)
    return X, attrs, Q.astype(np.float32)


@pytest.fixture(scope="module")
def ref_catalog(tmp_path_factory, data):
    """A catalog ``repro`` indexed through its own frontend."""
    X, attrs, _ = data
    root = str(tmp_path_factory.mktemp("ref_sql"))
    ref = ref_cluster(root, num_executors=2)
    _ingest(RefTable, ref.catalog, X, attrs)
    RefFrontend(ref.coordinator).execute(CREATE)
    return root, ref


def _vec(v):
    return "[" + ", ".join(repr(float(x)) for x in v) + "]"


def _same_hits(got, want, scale):
    assert [(h.file_path, h.row_group, h.row_offset) for h in got] == [
        (h.file_path, h.row_group, h.row_offset) for h in want]
    np.testing.assert_allclose([h.distance for h in got], [h.distance for h in want],
                               rtol=1e-5, atol=scale)


def _scale(X, Q):
    return 1e-5 * (float(np.max(np.sum(Q * Q, 1))) + float(np.max(np.sum(X * X, 1))))


def _selects(Q):
    return [
        f"SELECT * FROM docs ORDER BY L2_DISTANCE(vec, {_vec(Q[0])}) LIMIT 5",
        f"select * from docs order by l2_distance(vec, {_vec(Q[1])}) limit 10;",
        f"SELECT * FROM docs WHERE price < 40 ORDER BY L2_DISTANCE(vec, {_vec(Q[2])}) LIMIT 5",
        f"SELECT * FROM docs WHERE category = 'news' AND price BETWEEN 10 AND 70 "
        f"ORDER BY L2_DISTANCE(vec, {_vec(Q[3])}) LIMIT 4",
        f"SELECT * FROM docs WHERE category IN ('blog', 'docs') OR price >= 95 "
        f"ORDER BY L2_DISTANCE(vec, {_vec(Q[4])}) LIMIT 6",
        f"SELECT * FROM docs WHERE L2_DISTANCE(vec, {_vec(Q[5])}) < 3.0",
    ]


DDL = [
    CREATE,
    "create vector index v2 on docs (emb) with (R=8, L=20, ALPHA=1.3, PQ_NBITS=4, SHARDS=2);",
    "CREATE VECTOR INDEX bare ON docs (vec)",
    "REFRESH INDEX idx ON docs",
    "DROP INDEX idx ON docs;",
]


@pytest.mark.parametrize("i", range(len(DDL) + 6))
def test_parse_matches_reference(data, i):
    _, _, Q = data
    sql = (DDL + _selects(Q))[i]
    got, want = SqlFrontend(None).parse(sql), RefFrontend(None).parse(sql)
    if isinstance(got, IndexDDLInfo):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert repr(g) == repr(w)


def test_parse_rejects_what_reference_rejects():
    from repro.runtime.frontend import SqlError as RefSqlError

    for sql in ("SELECT COUNT(*) FROM docs", "DROP TABLE docs",
                "SELECT * FROM docs WHERE price << 3 ORDER BY L2_DISTANCE(vec, [1]) LIMIT 2",
                "SELECT * FROM docs ORDER BY L2_DISTANCE(vec, [1, x]) LIMIT 2"):
        with pytest.raises(SqlError):
            SqlFrontend(None).parse(sql)
        with pytest.raises(RefSqlError):
            RefFrontend(None).parse(sql)


@pytest.mark.parametrize("i", range(6))
def test_select_matches_reference(ref_catalog, data, i):
    X, _, Q = data
    root, ref = ref_catalog
    port = port_cluster(root, num_executors=2, device="cpu")
    sql = _selects(Q)[i]
    got = SqlFrontend(port.coordinator).execute(sql)
    want = RefFrontend(ref.coordinator).execute(sql)
    assert len(want) > 0
    _same_hits(got, want, _scale(X, Q))


def test_execute_many_matches_reference(ref_catalog, data):
    X, _, Q = data
    root, ref = ref_catalog
    port = port_cluster(root, num_executors=2, device="cpu")
    block = _selects(Q) + [
        f"SELECT * FROM docs WHERE price < {10 * (j + 2)} ORDER BY L2_DISTANCE(vec, {_vec(Q[6 + j])}) "
        f"LIMIT 5" for j in range(4)
    ] + [f"SELECT * FROM docs ORDER BY L2_DISTANCE(vec, {_vec(Q[10 + j])}) LIMIT 5" for j in range(2)]
    got = SqlFrontend(port.coordinator).execute_many(block)
    want = RefFrontend(ref.coordinator).execute_many(block)
    assert len(got) == len(want) == len(block)
    for g, w in zip(got, want):
        _same_hits(g, w, _scale(X, Q))


def _copy(root, dst):
    shutil.copytree(os.path.join(root, "s3"), os.path.join(str(dst), "s3"))
    return str(dst)


def test_refresh_and_drop_match_reference(ref_catalog, data, tmp_path):
    X, attrs, Q = data
    root, _ = ref_catalog
    rng = np.random.default_rng(12)
    tail = rng.normal(size=(100, DIM)).astype(np.float32)
    tail_attrs = {"price": np.arange(100, dtype=np.int64), "category": np.array(["news"] * 100)}
    out = {}
    for who, table_cls, make, front in (
            ("ref", RefTable, lambda r: ref_cluster(r, num_executors=2), RefFrontend),
            ("port", LakehouseTable, lambda r: port_cluster(r, num_executors=2, device="cpu"),
             SqlFrontend)):
        c = make(_copy(root, tmp_path / who))
        table_cls(c.catalog, "docs").append_vectors(tail, num_files=1, rows_per_group=128,
                                                   attributes=tail_attrs)
        fe_ = front(c.coordinator)
        rr = fe_.execute("REFRESH INDEX idx ON docs")
        hits = fe_.execute(f"SELECT * FROM docs ORDER BY L2_DISTANCE(vec, {_vec(tail[3])}) LIMIT 3")
        fe_.execute("DROP INDEX idx ON docs")
        snap = c.catalog.load_table("docs").current_snapshot()
        out[who] = (rr, hits, snap.statistics_file, snap.summary.get("ann.stale-statistics-file"))
    (rr, hits, stats, stale), (wr, whits, wstats, wstale) = out["port"], out["ref"]
    for f in ("inserted", "tombstoned", "shards_refreshed", "shards_rebuilt", "noop"):
        assert getattr(rr, f) == getattr(wr, f), f
    assert rr.inserted == 100
    _same_hits(hits, whits, _scale(X, tail))
    assert stats is None and wstats is None and stale is None and wstale is None


def test_create_through_frontend_matches_reference_counts(data, tmp_path):
    X, attrs, _ = data
    reps = {}
    for who, table_cls, make, front in (
            ("ref", RefTable, lambda r: ref_cluster(r, num_executors=2), RefFrontend),
            ("port", LakehouseTable, lambda r: port_cluster(r, num_executors=2, device="cpu"),
             SqlFrontend)):
        c = make(str(tmp_path / who))
        _ingest(table_cls, c.catalog, X, attrs)
        reps[who] = front(c.coordinator).execute(
            "CREATE VECTOR INDEX idx ON docs (vec) WITH (R=12, L=24, SHARDS=3, passes=1)")
    assert (reps["port"].num_shards, reps["port"].vector_count) == (
        reps["ref"].num_shards, reps["ref"].vector_count) == (3, len(X))


def test_micro_batcher_matches_reference(ref_catalog, data):
    """Eight threads submit the same 48 queries (a third filtered, k of 5
    or 10) to each package's batcher on one catalog: every query's hits
    are the reference's.  The submissions land in one drain (a 2 s window),
    so both batchers issue the same two ``probe_batch`` calls, one per k:
    an unfiltered query's hits depend on whether its batch also carries
    filtered ones (the planner gives it another op on a mixed shard), in
    both packages."""
    from repro.serving.serve_loop import ProbeMicroBatcher as RefBatcher
    from repro_torch.serving.serve_loop import ProbeMicroBatcher

    X, _, Q = data
    root, ref = ref_catalog
    port = port_cluster(root, num_executors=2, device="cpu")
    rng = np.random.default_rng(13)
    queries = np.concatenate([Q, X[rng.choice(len(X), 36, replace=False)]])
    subs = [(queries[i], 5 if i % 4 else 10, f"price < {20 + 3 * i}" if i % 3 == 0 else None)
            for i in range(len(queries))]

    def run(batcher):
        futs = [None] * len(subs)
        start = threading.Barrier(8)

        def client(j):
            start.wait()
            for i in range(j, len(subs), 8):
                q, k, flt = subs[i]
                futs[i] = batcher.submit(q, k, filter=flt)

        threads = [threading.Thread(target=client, args=(j,)) for j in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        return [f.result(timeout=300) for f in futs]

    with ProbeMicroBatcher(port.coordinator, "docs", strategy="diskann", max_batch=64,
                           max_wait_s=2.0) as pmb:
        got = run(pmb)
    with RefBatcher(ref.coordinator, "docs", strategy="diskann", max_batch=64,
                    max_wait_s=2.0) as rmb:
        want = run(rmb)
    assert pmb.stats.batches == rmb.stats.batches == 2
    assert pmb.stats.queries == rmb.stats.queries == len(subs)
    assert pmb.stats.filtered_queries == rmb.stats.filtered_queries == 16
    for g, w in zip(got, want):
        assert len(w) > 0
        _same_hits(g, w, _scale(X, queries))
