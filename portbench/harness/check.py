"""Whether what the timed path answered is correct.

The program's answers (hit lists of file, row group, row offset and
distance) are read back to rows of the corpus through the table's file
layout, and judged against the plain reference (``configs/reference.py``),
which works each query's neighbours out itself from the raw corpus.

Each number compared has its limit:

- ``failed``: queries whose answer never came or raised: 0;
- ``malformed``: answers with another number of hits than ``k``, hits not
  ascending, a distance not finite, or a row that is not in the table: 0;
- ``dist_gap``: the widest gap between a hit's distance and the exact
  (float64) distance of its row, over the query's exact k-th distance: the
  configuration's ``checks.dist_gap_max``;
- ``recall_at_10``: mean share of each query's exact neighbours returned:
  at least the configuration's ``checks.recall_at_10_min``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class Check:
    name: str
    value: float
    limit: float
    at_most: bool = True  # value <= limit passes; else value >= limit

    @property
    def ok(self) -> bool:
        return self.value <= self.limit if self.at_most else self.value >= self.limit

    def line(self) -> str:
        op = "<=" if self.at_most else ">="
        return f"check {self.name} {self.value!r} {op} {self.limit!r} {'ok' if self.ok else 'FAILED'}"


class Layout:
    """Rows of the table's files, in the order they were appended."""

    def __init__(self, files: List[Tuple[str, int]], rows_per_group: int) -> None:
        self.rows_per_group = rows_per_group
        self.start: Dict[str, Tuple[int, int]] = {}
        total = 0
        for path, count in files:
            self.start[path] = (total, count)
            total += count

    def rows(self, answers: list, k: int):
        """(rows (Q, k) int64, dists (Q, k) f64, malformed (Q,) bool) of hit
        lists, ``k`` hits due in each; -1 / +inf pad."""
        nq = len(answers)
        rows = np.full((nq, k), -1, np.int64)
        dists = np.full((nq, k), np.inf, np.float64)
        bad = np.zeros(nq, bool)
        for q, hits in enumerate(answers):
            if hits is None:
                bad[q] = True
                continue
            if len(hits) != k:
                bad[q] = True
            for j, h in enumerate(hits[:k]):
                base = self.start.get(h.file_path)
                off = h.row_group * self.rows_per_group + h.row_offset
                if base is None or not 0 <= off < base[1] or not np.isfinite(h.distance):
                    bad[q] = True
                    continue
                rows[q, j] = base[0] + off
                dists[q, j] = h.distance
            got = [h.distance for h in hits]
            if any(a > b for a, b in zip(got, got[1:])):
                bad[q] = True
        return rows, dists, bad


def judge(ref, corpus, queries: np.ndarray, rows: np.ndarray, dists: np.ndarray, k: int,
          device) -> dict:
    """Readings of answers (rows, dists) against the reference: the widest
    distance gap and the recall@k of each query."""
    truth_d, truth_i = ref.topk(corpus, queries, k, device)
    exact = ref.pair_distances(corpus, queries, rows, device)
    # the query's exact k-th distance as the scale
    finite = np.where(np.isfinite(truth_d), truth_d, -np.inf).max(axis=1)
    scale = np.maximum(finite, 1e-12)[:, None]
    held = rows >= 0
    with np.errstate(invalid="ignore"):
        gap = np.where(held, np.abs(dists - exact) / scale, 0.0)
    recall = np.empty(len(queries))
    for q in range(len(queries)):
        want = set(truth_i[q][truth_i[q] >= 0].tolist())
        got = set(rows[q][held[q]].tolist())
        recall[q] = len(want & got) / len(want) if want else float(not got)
    return dict(dist_gap=float(gap.max(initial=0.0)), recall=recall, truth_i=truth_i)
