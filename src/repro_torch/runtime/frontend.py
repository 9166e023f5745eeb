"""SQL frontend: the paper's DDL + vector-query routing (§6, §8).

The paper adds ``CREATE/REFRESH/DROP INDEX`` in the SqlLexer fallback path
and rewrites ``ORDER BY <distance>(col, literal) LIMIT K`` /
``WHERE <distance>(col, literal) < t`` plans into the distributed probe.
This module is that layer: a small pattern-based parser producing typed
statements, routed to the coordinator.

Supported grammar (case-insensitive):

    CREATE VECTOR INDEX <name> ON <table> (<column>)
        [WITH (R=64, L=100, ALPHA=1.2, PQ_M=48, PQ_NBITS=8, SHARDS=4)]
    REFRESH INDEX <name> ON <table>
    DROP INDEX <name> ON <table>
    SELECT * FROM <table> [WHERE <pred> [AND|OR <pred> ...]]
        ORDER BY L2_DISTANCE(<col>, [v,...]) LIMIT <k>
    SELECT * FROM <table> WHERE L2_DISTANCE(<col>, [v,...]) < <t>

where each ``<pred>`` is an attribute predicate —
``col = <lit>``, ``col IN (<lit>, ...)``, ``col < | <= | > | >= <num>`` or
``col BETWEEN <num> AND <num>`` (AND binds tighter than OR) — pushed
through the probe path as a filtered vector search.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.runtime.coordinator import Coordinator, IndexConfig
from repro_torch.runtime.predicates import PredicateError, parse_predicate


class SqlError(ValueError):
    pass


@dataclass
class IndexDDLInfo:
    action: str  # create | refresh | drop
    index_name: str
    table: str
    column: str = "vec"
    options: dict = field(default_factory=dict)


_CREATE = re.compile(
    r"^\s*CREATE\s+VECTOR\s+INDEX\s+(\w+)\s+ON\s+(\w+)\s*\(\s*(\w+)\s*\)"
    r"(?:\s+WITH\s*\(([^)]*)\))?\s*;?\s*$",
    re.I,
)
_REFRESH = re.compile(r"^\s*REFRESH\s+INDEX\s+(\w+)\s+ON\s+(\w+)\s*;?\s*$", re.I)
_DROP = re.compile(r"^\s*DROP\s+INDEX\s+(\w+)\s+ON\s+(\w+)\s*;?\s*$", re.I)
_TOPK = re.compile(
    r"^\s*SELECT\s+\*\s+FROM\s+(\w+)"
    r"(?:\s+WHERE\s+(?!(?:L2|IP)_DISTANCE\s*\()(.+?))?"
    r"\s+ORDER\s+BY\s+(L2|IP)_DISTANCE\s*\(\s*(\w+)\s*,"
    r"\s*\[([^\]]*)\]\s*\)\s+LIMIT\s+(\d+)\s*;?\s*$",
    re.I | re.S,
)
_THRESH = re.compile(
    r"^\s*SELECT\s+\*\s+FROM\s+(\w+)\s+WHERE\s+(L2|IP)_DISTANCE\s*\(\s*(\w+)\s*,"
    r"\s*\[([^\]]*)\]\s*\)\s*<\s*([\d.eE+-]+)\s*;?\s*$",
    re.I,
)


def _parse_options(raw: Optional[str]) -> dict:
    out = {}
    if not raw:
        return out
    for part in raw.split(","):
        if not part.strip():
            continue
        k, _, v = part.partition("=")
        out[k.strip().lower()] = v.strip()
    return out


def _parse_vector(raw: str) -> np.ndarray:
    try:
        return np.asarray([float(x) for x in raw.split(",") if x.strip()], np.float32)
    except ValueError as e:
        raise SqlError(f"bad vector literal: {e}") from None


class SqlFrontend:
    """Parses + routes statements.  ``batcher`` (optional) is a
    :class:`repro_torch.serving.serve_loop.ProbeMicroBatcher`: when attached,
    single top-k SELECTs are submitted to it so concurrent frontend threads
    share coalesced batch probes instead of issuing one probe each."""

    def __init__(self, coordinator: Coordinator, batcher=None) -> None:
        self.coordinator = coordinator
        self.batcher = batcher

    def parse(self, sql: str):
        if m := _CREATE.match(sql):
            return IndexDDLInfo("create", m.group(1), m.group(2), m.group(3),
                                _parse_options(m.group(4)))
        if m := _REFRESH.match(sql):
            return IndexDDLInfo("refresh", m.group(1), m.group(2))
        if m := _DROP.match(sql):
            return IndexDDLInfo("drop", m.group(1), m.group(2))
        if m := _TOPK.match(sql):
            pred = None
            if m.group(2) is not None:
                try:
                    pred = parse_predicate(m.group(2))
                except PredicateError as e:
                    raise SqlError(f"bad WHERE clause: {e}") from None
            return ("topk", m.group(1), m.group(3).lower(), m.group(4),
                    _parse_vector(m.group(5)), int(m.group(6)), pred)
        if m := _THRESH.match(sql):
            return ("threshold", m.group(1), m.group(2).lower(), m.group(3),
                    _parse_vector(m.group(4)), float(m.group(5)), None)
        raise SqlError(f"unrecognized statement: {sql[:80]!r}")

    def execute(self, sql: str):
        stmt = self.parse(sql)
        if isinstance(stmt, IndexDDLInfo):
            return self._execute_ddl(stmt)
        kind, table, metric, _col, vec, arg, pred = stmt
        if kind == "topk":
            if self.batcher is not None and self.batcher.table_name == table:
                return self.batcher.submit(vec, k=arg, filter=pred).result()
            report = self.coordinator.probe(
                table, vec, arg, strategy="auto", filter=pred
            )
            return report.hits[0]
        # threshold query: centroid index gives *exact* file pruning
        # (paper §4.1); rerank then filters by the bound
        report = self.coordinator.probe(
            table, vec, k=1024, strategy="centroid", n_probe=10**9
        )
        thresh_sq = arg * arg if metric == "l2" else arg  # probe returns squared L2
        return [h for h in report.hits[0] if h.distance <= thresh_sq]

    def execute_many(self, sqls: List[str]) -> List[object]:
        """Micro-batched execution of a statement block.

        Consecutive runs of top-k SELECTs against the same table with the
        same LIMIT drain into ONE ``Coordinator.probe_batch`` call (the
        batched pipeline: coalesced shard fragments, batched kernels) —
        filtered and unfiltered SELECTs coalesce together, each query
        carrying its own WHERE predicate through the batch; every other
        statement executes exactly as :meth:`execute` would.  Results come
        back in statement order."""
        parsed = [self.parse(s) for s in sqls]
        results: List[object] = [None] * len(sqls)
        run: List[int] = []  # indices of the current coalescible run

        def flush() -> None:
            if not run:
                return
            if len(run) == 1:
                results[run[0]] = self.execute(sqls[run[0]])
            else:
                _, table, _, _, _, k, _ = parsed[run[0]]
                queries = np.stack([parsed[i][4] for i in run])
                filters = [parsed[i][6] for i in run]
                report = self.coordinator.probe_batch(
                    table,
                    queries,
                    k,
                    strategy="auto",
                    filter=filters if any(f is not None for f in filters) else None,
                )
                for i, hits in zip(run, report.hits):
                    results[i] = hits
            run.clear()

        for i, stmt in enumerate(parsed):
            coalescible = not isinstance(stmt, IndexDDLInfo) and stmt[0] == "topk"
            if coalescible and run:
                _, t0, m0, _, v0, k0, _ = parsed[run[0]]
                _, t1, m1, _, v1, k1, _ = stmt
                if (t1, m1, k1) != (t0, m0, k0) or v1.shape != v0.shape:
                    flush()
            if coalescible:
                run.append(i)
            else:
                flush()
                results[i] = self.execute(sqls[i])
        flush()
        return results

    def _execute_ddl(self, ddl: IndexDDLInfo):
        if ddl.action == "create":
            o = ddl.options
            cfg = IndexConfig(
                name=ddl.index_name,
                column=ddl.column,
                R=int(o.get("r", 64)),
                L=int(o.get("l", 100)),
                alpha=float(o.get("alpha", 1.2)),
                pq_m=int(o.get("pq_m", 0)),
                pq_nbits=int(o.get("pq_nbits", 8)),
                num_shards=int(o["shards"]) if "shards" in o else None,
                build_passes=int(o.get("passes", 2)),
            )
            return self.coordinator.create_index(ddl.table, cfg)
        if ddl.action == "refresh":
            return self.coordinator.refresh_index(ddl.table, ddl.index_name)
        if ddl.action == "drop":
            # unbinding = metadata-only commit with no statistics-file; the
            # orphaned Puffin is reaped by GC
            self.coordinator.catalog.load_table(ddl.table)

            def mutate(m):
                snap = m.current_snapshot()
                if snap is not None:
                    snap.summary.pop("statistics-file", None)
                    snap.summary.pop("ann.stale-statistics-file", None)
                return m

            return self.coordinator.catalog.commit_with_retries(ddl.table, mutate)
        raise SqlError(ddl.action)
