"""Attribute-predicate IR for filtered vector search.

Hybrid queries — "nearest neighbors of q WHERE category = 'x' AND price < t"
— push a predicate tree through the probe path.  The same tree is consumed
at three altitudes:

- **zone pruning** (coordinator): :meth:`Predicate.zone_may_match` against a
  per-row-group zone (min/max for numeric columns, value→count tags for
  dictionary columns) decides whether a row group can contain a match, and
  :meth:`Predicate.estimate_fraction` turns the zone statistics into a
  selectivity estimate that drives per-shard plan selection;
- **row masking** (executor / coordinator scan): :func:`row_group_mask`
  evaluates the tree against a row group's attribute arrays, mapping string
  literals through the file's own dictionary so per-file code spaces never
  leak into the IR;
- **SQL surface** (frontend): :func:`parse_predicate` parses the WHERE
  fragment grammar ``col = lit | col IN (...) | col <op> num |
  col BETWEEN a AND b`` combined with AND / OR (AND binds tighter).

Predicates are equality-comparable dataclasses: fragment coalescing groups
queries whose predicate trees compare equal, so one mask evaluation covers
every query in the group.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class PredicateError(ValueError):
    pass


@dataclass(frozen=True)
class ColumnHistogram:
    """Equi-width histogram of one int column over one FILE (all row
    groups).  Range predicates estimate their passing fraction from bin
    overlap — far tighter than the (hi-lo)/span guess on skewed data — and
    the estimate feeds the planner's PostfilterBeam pool sizing.  Stored
    once per (file, column) in the ``repro.attr-zonemap-v1`` blob and
    attached to each row group's :class:`ZoneStats` at decode (the per-rg
    estimate therefore reflects the file's distribution)."""

    lo: float
    hi: float
    counts: Tuple[int, ...]

    @property
    def total(self) -> int:
        return sum(self.counts)

    def fraction_between(self, lo: Optional[float], hi: Optional[float]) -> float:
        """Estimated fraction of rows with lo <= value <= hi (either bound
        optional; bound exclusivity is below bin resolution and ignored)."""
        if self.total == 0:
            return 0.0
        q_lo = self.lo if lo is None else max(float(lo), self.lo)
        # +1 closes the last bin: values == hi land in [hi, hi+width) terms
        q_hi = (self.hi + 1.0) if hi is None else min(float(hi) + 1.0, self.hi + 1.0)
        if q_hi <= q_lo:
            return 0.0
        width = (self.hi + 1.0 - self.lo) / len(self.counts)
        covered = 0.0
        for b, c in enumerate(self.counts):
            b_lo = self.lo + b * width
            b_hi = b_lo + width
            overlap = min(q_hi, b_hi) - max(q_lo, b_lo)
            if overlap > 0:
                covered += c * (overlap / width)
        return min(1.0, covered / self.total)

    def to_json(self) -> dict:
        return {"lo": self.lo, "hi": self.hi, "counts": list(self.counts)}

    @staticmethod
    def from_json(obj: dict) -> "ColumnHistogram":
        return ColumnHistogram(
            lo=float(obj["lo"]), hi=float(obj["hi"]), counts=tuple(obj["counts"])
        )

    @staticmethod
    def build(values, bins: int = 16) -> Optional["ColumnHistogram"]:
        arr = np.asarray(values)
        if arr.size == 0:
            return None
        lo, hi = float(arr.min()), float(arr.max())
        counts, _edges = np.histogram(arr, bins=bins, range=(lo, hi + 1.0))
        return ColumnHistogram(lo=lo, hi=hi, counts=tuple(int(c) for c in counts))

    @staticmethod
    def merge(
        hists: List["ColumnHistogram"], bins: int = 16
    ) -> Optional["ColumnHistogram"]:
        """Merge several (file-level) histograms into one equi-width
        histogram over the union range, distributing each source bin's mass
        into the overlapped target bins proportionally.  Counts may come
        out fractional — the merged histogram is an in-memory estimation
        aid (shard-level selectivity evidence), never serialized."""
        hists = [h for h in hists if h is not None and h.total > 0]
        if not hists:
            return None
        if len(hists) == 1:
            return hists[0]
        lo = min(h.lo for h in hists)
        hi = max(h.hi for h in hists)
        width = (hi + 1.0 - lo) / bins
        counts = [0.0] * bins
        for h in hists:
            src_w = (h.hi + 1.0 - h.lo) / len(h.counts)
            for b, c in enumerate(h.counts):
                if not c:
                    continue
                b_lo = h.lo + b * src_w
                b_hi = b_lo + src_w
                t0 = max(0, int((b_lo - lo) / width))
                t1 = min(bins - 1, int((b_hi - lo - 1e-9) / width))
                for t in range(t0, t1 + 1):
                    tb_lo = lo + t * width
                    overlap = min(b_hi, tb_lo + width) - max(b_lo, tb_lo)
                    if overlap > 0:
                        counts[t] += c * (overlap / src_w)
        return ColumnHistogram(lo=lo, hi=hi, counts=tuple(counts))


@dataclass(frozen=True)
class ZoneStats:
    """One (row_group, column) zone-map entry.

    Numeric columns carry ``min``/``max`` plus an optional file-level
    equi-width :class:`ColumnHistogram`; dictionary columns carry
    ``values`` (value → row count).  ``count`` is the row-group size.  The
    histogram is serialized once per (file, column) by the zone-map blob
    codec, not inside each zone entry."""

    count: int
    min: Optional[float] = None
    max: Optional[float] = None
    values: Optional[Dict[str, int]] = None
    hist: Optional[ColumnHistogram] = None

    def to_json(self) -> dict:
        out: dict = {"count": self.count}
        if self.values is not None:
            out["values"] = dict(self.values)
        else:
            out["min"] = self.min
            out["max"] = self.max
        return out

    @staticmethod
    def from_json(obj: dict) -> "ZoneStats":
        if "values" in obj:
            return ZoneStats(count=int(obj["count"]), values=dict(obj["values"]))
        return ZoneStats(count=int(obj["count"]), min=obj["min"], max=obj["max"])


# ---------------------------------------------------------------------------
# predicate tree
# ---------------------------------------------------------------------------


def _codes_for(values: Sequence, dictionary: List[str]) -> np.ndarray:
    """Map literal values to this file's dictionary codes (-1 = absent)."""
    lut = {v: i for i, v in enumerate(dictionary)}
    return np.asarray([lut.get(str(v), -1) for v in values], np.int64)


@dataclass(frozen=True)
class Predicate:
    def columns(self) -> frozenset:
        raise NotImplementedError

    def mask(self, arr: np.ndarray, dictionary: Optional[List[str]]) -> np.ndarray:
        raise NotImplementedError

    def evaluate(
        self,
        columns: Dict[str, np.ndarray],
        dictionaries: Optional[Dict[str, List[str]]] = None,
    ) -> np.ndarray:
        """Row mask over aligned attribute arrays.  ``dictionaries`` maps
        dictionary-encoded column names to their value tables; when a column
        is passed as decoded values (strings), omit its dictionary."""
        raise NotImplementedError

    def zone_may_match(self, zones: Dict[str, ZoneStats]) -> bool:
        """False only if NO row in the zone can satisfy the predicate.
        Columns missing from the zone are conservatively assumed to match."""
        raise NotImplementedError

    def estimate_fraction(self, zones: Dict[str, ZoneStats]) -> float:
        """Estimated fraction of the zone's rows that pass (∈ [0, 1])."""
        raise NotImplementedError


@dataclass(frozen=True)
class _Leaf(Predicate):
    column: str = ""

    def columns(self) -> frozenset:
        return frozenset({self.column})

    def evaluate(self, columns, dictionaries=None):
        arr = columns[self.column]
        dictionary = (dictionaries or {}).get(self.column)
        return self.mask(np.asarray(arr), dictionary)


@dataclass(frozen=True)
class Eq(_Leaf):
    value: object = None

    def mask(self, arr, dictionary):
        if dictionary is not None:
            (code,) = _codes_for([self.value], dictionary)
            return arr == code
        if arr.dtype.kind in ("U", "S", "O"):
            return arr.astype(str) == str(self.value)
        if isinstance(self.value, str):  # string literal vs numeric column
            return np.zeros(arr.shape[0], bool)
        return arr == self.value

    def zone_may_match(self, zones):
        z = zones.get(self.column)
        if z is None:
            return True
        if z.values is not None:
            return str(self.value) in z.values
        if isinstance(self.value, str):
            return False
        return z.min <= self.value <= z.max

    def estimate_fraction(self, zones):
        z = zones.get(self.column)
        if z is None or z.count == 0:
            return 1.0
        if z.values is not None:
            return z.values.get(str(self.value), 0) / z.count
        if not self.zone_may_match(zones):
            return 0.0
        span = max(float(z.max) - float(z.min), 1.0)
        return min(1.0, 1.0 / span)


@dataclass(frozen=True)
class In(_Leaf):
    values: Tuple = ()

    def mask(self, arr, dictionary):
        if dictionary is not None:
            codes = _codes_for(self.values, dictionary)
            return np.isin(arr, codes[codes >= 0])
        if arr.dtype.kind in ("U", "S", "O"):
            return np.isin(arr.astype(str), [str(v) for v in self.values])
        nums = [v for v in self.values if not isinstance(v, str)]
        return np.isin(arr, nums) if nums else np.zeros(arr.shape[0], bool)

    def zone_may_match(self, zones):
        z = zones.get(self.column)
        if z is None:
            return True
        if z.values is not None:
            return any(str(v) in z.values for v in self.values)
        return any(
            z.min <= v <= z.max for v in self.values if not isinstance(v, str)
        )

    def estimate_fraction(self, zones):
        z = zones.get(self.column)
        if z is None or z.count == 0:
            return 1.0
        if z.values is not None:
            return min(1.0, sum(z.values.get(str(v), 0) for v in self.values) / z.count)
        span = max(float(z.max) - float(z.min), 1.0)
        hits = sum(
            1 for v in self.values if not isinstance(v, str) and z.min <= v <= z.max
        )
        return min(1.0, hits / span)


@dataclass(frozen=True)
class Range(_Leaf):
    """lo <= col <= hi (either bound optional; exclusivity per flag)."""

    lo: Optional[float] = None
    hi: Optional[float] = None
    lo_inclusive: bool = True
    hi_inclusive: bool = True

    def mask(self, arr, dictionary):
        if dictionary is not None or arr.dtype.kind in ("U", "S", "O"):
            # range over a string/dictionary column matches nothing — the
            # same conservative convention as Eq/In type mismatches, so a
            # mistyped WHERE never crash-loops executor task retries
            return np.zeros(arr.shape[0], bool)
        out = np.ones(arr.shape[0], bool)
        if self.lo is not None:
            out &= (arr >= self.lo) if self.lo_inclusive else (arr > self.lo)
        if self.hi is not None:
            out &= (arr <= self.hi) if self.hi_inclusive else (arr < self.hi)
        return out

    def zone_may_match(self, zones):
        z = zones.get(self.column)
        if z is None:
            return True
        if z.values is not None:
            return False  # range over a dictionary column matches nothing
        if self.lo is not None and (z.max < self.lo or (z.max == self.lo and not self.lo_inclusive)):
            return False
        if self.hi is not None and (z.min > self.hi or (z.min == self.hi and not self.hi_inclusive)):
            return False
        return True

    def estimate_fraction(self, zones):
        z = zones.get(self.column)
        if z is None or z.count == 0:
            return 1.0
        if z.values is not None:
            return 0.0
        if not self.zone_may_match(zones):
            return 0.0
        if z.hist is not None:
            # histogram-backed estimate: bin-overlap mass instead of the
            # uniform (hi-lo)/span guess — robust to skewed columns, and
            # the signal the planner's band selection keys on.  The
            # histogram is FILE-level, so condition it on this row group's
            # own [min, max]: P(pass | value in rg range).  That keeps the
            # per-rg tightening the span estimator had (a sorted column's
            # fully-passing row group must estimate ~1.0, not the file-
            # wide fraction) on top of the skew-awareness.
            z_lo, z_hi = float(z.min), float(z.max)
            # fraction_between treats both bounds as inclusive; histograms
            # only exist for int columns, so a strict bound shifts by
            # exactly one — without this, 'price < 1' on a column
            # concentrated at 1 would count value 1's whole mass and flip
            # the planner band from prefilter to postfilter
            lo_q = self.lo if (self.lo is None or self.lo_inclusive) else float(self.lo) + 1.0
            hi_q = self.hi if (self.hi is None or self.hi_inclusive) else float(self.hi) - 1.0
            lo_c = z_lo if lo_q is None else max(float(lo_q), z_lo)
            hi_c = z_hi if hi_q is None else min(float(hi_q), z_hi)
            if hi_c < lo_c:
                return 0.0
            denom = z.hist.fraction_between(z_lo, z_hi)
            if denom > 0.0:
                return min(1.0, z.hist.fraction_between(lo_c, hi_c) / denom)
        span = float(z.max) - float(z.min)
        if span <= 0:
            return 1.0
        lo = float(z.min) if self.lo is None else max(float(z.min), float(self.lo))
        hi = float(z.max) if self.hi is None else min(float(z.max), float(self.hi))
        return min(1.0, max(0.0, (hi - lo) / span))


@dataclass(frozen=True)
class And(Predicate):
    children: Tuple[Predicate, ...] = ()

    def columns(self):
        return frozenset().union(*(c.columns() for c in self.children))

    def evaluate(self, columns, dictionaries=None):
        out = self.children[0].evaluate(columns, dictionaries)
        for c in self.children[1:]:
            out = out & c.evaluate(columns, dictionaries)
        return out

    def zone_may_match(self, zones):
        return all(c.zone_may_match(zones) for c in self.children)

    def estimate_fraction(self, zones):
        f = 1.0
        for c in self.children:
            f *= c.estimate_fraction(zones)
        return f


@dataclass(frozen=True)
class Or(Predicate):
    children: Tuple[Predicate, ...] = ()

    def columns(self):
        return frozenset().union(*(c.columns() for c in self.children))

    def evaluate(self, columns, dictionaries=None):
        out = self.children[0].evaluate(columns, dictionaries)
        for c in self.children[1:]:
            out = out | c.evaluate(columns, dictionaries)
        return out

    def zone_may_match(self, zones):
        return any(c.zone_may_match(zones) for c in self.children)

    def estimate_fraction(self, zones):
        return min(1.0, sum(c.estimate_fraction(zones) for c in self.children))


# ---------------------------------------------------------------------------
# row-group evaluation against a vparquet reader
# ---------------------------------------------------------------------------


def row_group_mask(pred: Predicate, reader, rg_id: int) -> np.ndarray:
    """Evaluate ``pred`` over one row group of a :class:`VParquetReader`,
    reading only the referenced attribute columns (column projection).

    A file written without one of the referenced columns (mixed-schema
    appends) matches nothing on that column's leaves — a NaN sentinel
    column makes every Eq/In/Range over it evaluate False while Or-siblings
    on present columns still work.  The oracle's scan path and the
    executor's bitmask path share this function, so parity is preserved
    rather than the probe crashing on older files."""
    columns: Dict[str, np.ndarray] = {}
    dictionaries: Dict[str, List[str]] = {}
    n_rows = reader.row_groups[rg_id]["num_rows"]
    for name in sorted(pred.columns()):
        spec = reader.columns.get(name)
        # missing columns AND non-scalar columns (e.g. the vector column
        # itself) get the sentinel — a 2-D read would otherwise corrupt the
        # row mask shape, crashing the index path while the scan path
        # silently mis-filtered
        if spec is None or spec.vlen != 0:
            columns[name] = np.full(n_rows, np.nan)  # NaN: no leaf matches
            continue
        columns[name] = reader.read_column(name, [rg_id])
        if spec.dictionary is not None:
            dictionaries[name] = spec.dictionary
    return pred.evaluate(columns, dictionaries)


# ---------------------------------------------------------------------------
# WHERE-fragment parser
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    r"\s*(?:(?P<str>'(?:[^']|'')*')|(?P<num>-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)"
    r"|(?P<op><=|>=|!=|<>|=|<|>|\(|\)|,)|(?P<word>\w+))"
)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            if text[pos:].strip():
                raise PredicateError(f"bad predicate near {text[pos:pos+20]!r}")
            break
        pos = m.end()
        if m.group("str") is not None:
            out.append(("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.group("num") is not None:
            raw = m.group("num")
            out.append(("num", float(raw) if ("." in raw or "e" in raw.lower()) else int(raw)))
        elif m.group("op") is not None:
            out.append(("op", m.group("op")))
        else:
            out.append(("word", m.group("word")))
    return out


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]) -> None:
        self.toks = tokens
        self.pos = 0

    def _peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else (None, None)

    def _next(self):
        tok = self._peek()
        self.pos += 1
        return tok

    def _expect_word(self, *words: str):
        kind, val = self._next()
        if kind != "word" or val.upper() not in words:
            raise PredicateError(f"expected {'/'.join(words)}, got {val!r}")
        return val.upper()

    def parse(self) -> Predicate:
        pred = self._or()
        if self.pos != len(self.toks):
            raise PredicateError(f"trailing tokens at {self.toks[self.pos:]}")
        return pred

    def _or(self) -> Predicate:
        terms = [self._and()]
        while self._peek()[0] == "word" and self._peek()[1].upper() == "OR":
            self._next()
            terms.append(self._and())
        return terms[0] if len(terms) == 1 else Or(tuple(terms))

    def _and(self) -> Predicate:
        terms = [self._atom()]
        while self._peek()[0] == "word" and self._peek()[1].upper() == "AND":
            self._next()
            terms.append(self._atom())
        return terms[0] if len(terms) == 1 else And(tuple(terms))

    def _atom(self) -> Predicate:
        kind, val = self._next()
        if kind == "op" and val == "(":
            inner = self._or()
            kind, val = self._next()
            if (kind, val) != ("op", ")"):
                raise PredicateError("unbalanced parenthesis")
            return inner
        if kind != "word":
            raise PredicateError(f"expected column name, got {val!r}")
        column = val
        kind, op = self._next()
        if kind == "word" and op.upper() == "IN":
            k, v = self._next()
            if (k, v) != ("op", "("):
                raise PredicateError("IN requires a parenthesized list")
            values = []
            while True:
                k, v = self._next()
                if k not in ("str", "num"):
                    raise PredicateError(f"bad IN literal {v!r}")
                values.append(v)
                k, v = self._next()
                if (k, v) == ("op", ")"):
                    break
                if (k, v) != ("op", ","):
                    raise PredicateError("bad IN list")
            return In(column, tuple(values))
        if kind == "word" and op.upper() == "BETWEEN":
            k, lo = self._next()
            if k != "num":
                raise PredicateError("BETWEEN requires numeric bounds")
            self._expect_word("AND")
            k, hi = self._next()
            if k != "num":
                raise PredicateError("BETWEEN requires numeric bounds")
            return Range(column, lo=lo, hi=hi)
        if kind != "op" or op not in ("=", "!=", "<>", "<", "<=", ">", ">="):
            raise PredicateError(f"bad operator {op!r}")
        k, lit = self._next()
        if k not in ("str", "num"):
            raise PredicateError(f"bad literal {lit!r}")
        if op == "=":
            return Eq(column, lit)
        if op in ("!=", "<>"):
            raise PredicateError("!= is not supported (no zone-safe pruning)")
        if k == "str":
            raise PredicateError(f"range comparison on string literal {lit!r}")
        if op == "<":
            return Range(column, hi=lit, hi_inclusive=False)
        if op == "<=":
            return Range(column, hi=lit)
        if op == ">":
            return Range(column, lo=lit, lo_inclusive=False)
        return Range(column, lo=lit)


def parse_predicate(text: str) -> Predicate:
    """Parse a SQL WHERE fragment into a :class:`Predicate` tree."""
    toks = _tokenize(text)
    if not toks:
        raise PredicateError("empty predicate")
    return _Parser(toks).parse()
