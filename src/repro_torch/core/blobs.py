"""Byte-level blob codecs for the three Puffin blob types (paper §4).

- ``flockdb-ann-centroid-v1`` (:func:`encode_centroid_blob`) — §4.1: 32-byte
  header (magic ``ANNI``), fixed-size entries ``(centroid f32[D], file_idx
  u32, max_distance f32)``, length-prefixed UTF-8 file-paths table.
- ``flockdb-ann-index-v1`` (:func:`encode_shard_blob`) — §4.3: header (magic
  ``DANN``, version, dims, count, R, L, medoid, metric, PQ params), PQ
  codebook, PQ codes, adjacency offset table (N+1 × u64), zstd-compressed
  varint adjacency (per-node degree + neighbor ids), optional full f32
  vectors (the paper's retention policy: omit when the engine can re-fetch
  from Parquet during rerank), delta-encoded vector-ID→location map,
  tombstone bitmap.
- ``flockdb-ann-routing-v1`` (:func:`encode_routing_blob`) — JSON metadata
  (shard table, tombstone ratios, base snapshot id, params) + binary
  partition-centroid codebook.
- ``repro.attr-zonemap-v1`` (:func:`encode_zonemap_blob`) — filtered
  search: per-(file, row-group) attribute zones (min/max for numeric
  columns, value→count tags for dictionary columns) plus per-shard
  row-group membership, so the coordinator can prune shards and row
  groups against WHERE predicates before dispatch.
- ``repro.fresh-tail-v1`` (:func:`encode_fresh_tail_blob`) — freshness:
  the appended-but-unindexed row groups committed since the last indexed
  snapshot.  Append commits maintain it; probes serve the listed row
  groups through exact-scan plan ops so writes are searchable without a
  rebuild; a refresh/compaction resets it.

Deviation from the paper, recorded per DESIGN.md: the shard blob carries the
PQ **codes** section explicitly.  The paper lists only the codebook, but the
probe path it describes ("PQ-approximate distances for candidate scoring")
requires per-vector codes; DiskANN stores them in a sidecar file, we inline
them as a section.
"""

from __future__ import annotations

import io
import json
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

try:
    import zstandard as _zstd

    def _c(b: bytes) -> bytes:
        return _zstd.ZstdCompressor(level=3).compress(b)

    def _d(b: bytes) -> bytes:
        return _zstd.ZstdDecompressor().decompress(b)

except Exception:  # pragma: no cover
    import zlib

    def _c(b: bytes) -> bytes:
        return zlib.compress(b, 6)

    def _d(b: bytes) -> bytes:
        return zlib.decompress(b)


CENTROID_BLOB_TYPE = "flockdb-ann-centroid-v1"
SHARD_BLOB_TYPE = "flockdb-ann-index-v1"
ROUTING_BLOB_TYPE = "flockdb-ann-routing-v1"
ATTR_ZONEMAP_BLOB_TYPE = "repro.attr-zonemap-v1"
FRESH_TAIL_BLOB_TYPE = "repro.fresh-tail-v1"

_METRIC_CODE = {"l2": 0, "ip": 1}
_METRIC_NAME = {v: k for k, v in _METRIC_CODE.items()}


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------


# The shard blob holds one varint per adjacency entry and three per vector
# in the location map: millions per shard.  The reference writes and reads
# them one at a time in Python; these numpy forms give the same bytes.


def _varint_lengths(values: np.ndarray) -> np.ndarray:
    """Bytes each non-negative value takes as a LEB128 varint."""
    v = np.asarray(values, np.uint64)
    lengths = np.ones(v.shape, np.int64)
    rest = v >> np.uint64(7)
    while rest.any():
        lengths += rest > 0
        rest >>= np.uint64(7)
    return lengths


def _encode_varints(values: np.ndarray) -> Tuple[bytes, np.ndarray]:
    """LEB128-encode every value (non-negative, < 2**64) back to back.
    Returns (bytes, per-value byte lengths)."""
    v = np.asarray(values, np.uint64).reshape(-1)
    lengths = _varint_lengths(v)
    if v.size == 0:
        return b"", lengths
    width = int(lengths.max())
    pos = np.arange(width)
    grid = ((v[:, None] >> (pos * 7).astype(np.uint64)[None, :]) & np.uint64(0x7F)).astype(np.uint8)
    grid |= np.where(pos[None, :] < lengths[:, None] - 1, 0x80, 0).astype(np.uint8)
    return grid[pos[None, :] < lengths[:, None]].tobytes(), lengths


def _decode_varints(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Every LEB128 varint in ``data``.  Returns (values uint64, index of
    the value that each byte belongs to)."""
    raw = np.frombuffer(data, np.uint8)
    if raw.size == 0:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    last = (raw & 0x80) == 0
    value_of = np.cumsum(last) - last  # value index of each byte
    starts = np.flatnonzero(np.concatenate([[True], last[:-1]]))
    shift = (np.arange(raw.size) - starts[value_of]) * 7
    parts = (raw & 0x7F).astype(np.uint64) << shift.astype(np.uint64)
    return np.bitwise_or.reduceat(parts, starts), value_of


# ---------------------------------------------------------------------------
# centroid blob (ANNI, §4.1)
# ---------------------------------------------------------------------------

_ANNI_MAGIC = b"ANNI"
_ANNI_HEADER = struct.Struct("<4sBBHIIIQI")  # magic, ver, metric, entry_size,
# dims, entry_count, file_count, paths_offset, reserved  -> 32 bytes


@dataclass
class CentroidEntry:
    centroid: np.ndarray  # (D,) f32
    file_index: int
    max_distance: float


def encode_centroid_blob(
    centroids: np.ndarray,  # (N, D) f32
    file_indices: np.ndarray,  # (N,) u32 (index into file_paths)
    max_distances: np.ndarray,  # (N,) f32
    file_paths: List[str],
    metric: str = "l2",
) -> bytes:
    centroids = np.ascontiguousarray(centroids, dtype=np.float32)
    n, d = centroids.shape
    entry_size = d * 4 + 4 + 4
    entries = io.BytesIO()
    fi = np.asarray(file_indices, dtype=np.uint32)
    md = np.asarray(max_distances, dtype=np.float32)
    for i in range(n):
        entries.write(centroids[i].tobytes())
        entries.write(struct.pack("<If", int(fi[i]), float(md[i])))
    entry_bytes = entries.getvalue()
    paths = io.BytesIO()
    paths.write(struct.pack("<I", len(file_paths)))
    for p in file_paths:
        raw = p.encode("utf-8")
        paths.write(struct.pack("<H", len(raw)))
        paths.write(raw)
    paths_offset = _ANNI_HEADER.size + len(entry_bytes)
    header = _ANNI_HEADER.pack(
        _ANNI_MAGIC, 1, _METRIC_CODE[metric], entry_size, d, n, len(file_paths), paths_offset, 0
    )
    return header + entry_bytes + paths.getvalue()


def decode_centroid_blob(data: bytes):
    magic, ver, metric_code, entry_size, d, n, n_files, paths_offset, _r = _ANNI_HEADER.unpack(
        data[: _ANNI_HEADER.size]
    )
    if magic != _ANNI_MAGIC:
        raise ValueError("bad ANNI magic")
    centroids = np.empty((n, d), np.float32)
    file_indices = np.empty(n, np.uint32)
    max_distances = np.empty(n, np.float32)
    pos = _ANNI_HEADER.size
    for i in range(n):
        centroids[i] = np.frombuffer(data, np.float32, d, pos)
        pos += d * 4
        file_indices[i], max_distances[i] = struct.unpack_from("<If", data, pos)
        pos += 8
    pos = paths_offset
    (count,) = struct.unpack_from("<I", data, pos)
    pos += 4
    file_paths: List[str] = []
    for _ in range(count):
        (ln,) = struct.unpack_from("<H", data, pos)
        pos += 2
        file_paths.append(data[pos : pos + ln].decode("utf-8"))
        pos += ln
    return centroids, file_indices, max_distances, file_paths, _METRIC_NAME[metric_code]


# ---------------------------------------------------------------------------
# shard blob (DANN, §4.3)
# ---------------------------------------------------------------------------

_DANN_MAGIC = b"DANN"
# magic, version, dims, count, R, L, medoid, metric, has_vectors, pq_m,
# pq_nbits, alpha, 7 section offsets (codebook, codes, adj_offsets, adjacency,
# vectors, locmap, tombstones)
_DANN_HEADER = struct.Struct("<4sIIQIIQBBHHf7Q")


@dataclass
class ShardLocationMap:
    """vector id -> (file_path, row_group_id, row_offset); §4.3."""

    file_paths: List[str]
    file_idx: np.ndarray  # (N,) u32
    row_group: np.ndarray  # (N,) u32
    row_offset: np.ndarray  # (N,) u32

    def lookup(self, vec_id: int) -> Tuple[str, int, int]:
        return (
            self.file_paths[int(self.file_idx[vec_id])],
            int(self.row_group[vec_id]),
            int(self.row_offset[vec_id]),
        )


def _encode_locmap(loc: ShardLocationMap) -> bytes:
    buf = io.BytesIO()
    buf.write(struct.pack("<I", len(loc.file_paths)))
    for p in loc.file_paths:
        raw = p.encode("utf-8")
        buf.write(struct.pack("<H", len(raw)))
        buf.write(raw)
    n = len(loc.file_idx)
    buf.write(struct.pack("<Q", n))
    # delta-encode each stream (ids are the sorted order already — §4.3)
    for arr in (loc.file_idx, loc.row_group, loc.row_offset):
        a = np.asarray(arr, dtype=np.int64)
        deltas = np.diff(a, prepend=0)
        # zig-zag so negatives stay compact
        zz = ((deltas << 1) ^ (deltas >> 63)).astype(np.uint64)
        raw, _ = _encode_varints(zz)
        buf.write(struct.pack("<Q", len(raw)))
        buf.write(raw)
    return _c(buf.getvalue())


def _decode_locmap(data: bytes) -> ShardLocationMap:
    data = _d(data)
    pos = 0
    (n_files,) = struct.unpack_from("<I", data, pos)
    pos += 4
    file_paths = []
    for _ in range(n_files):
        (ln,) = struct.unpack_from("<H", data, pos)
        pos += 2
        file_paths.append(data[pos : pos + ln].decode("utf-8"))
        pos += ln
    (n,) = struct.unpack_from("<Q", data, pos)
    pos += 8
    streams = []
    for _ in range(3):
        (ln,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        raw = data[pos : pos + ln]
        pos += ln
        zz = _decode_varints(raw)[0][:n].astype(np.int64)
        vals = (zz >> 1) ^ -(zz & 1)  # un-zigzag
        streams.append(np.cumsum(vals).astype(np.uint32) if n else vals.astype(np.uint32))
    return ShardLocationMap(file_paths, streams[0], streams[1], streams[2])


def encode_shard_blob(
    graph,  # VamanaGraph
    locmap: ShardLocationMap,
    *,
    include_vectors: bool = True,
) -> bytes:
    """Serialize a Vamana shard to the DANN layout."""
    from repro_torch.core.vamana import VamanaGraph  # local import to avoid cycle

    assert isinstance(graph, VamanaGraph)
    n = graph.n
    d = graph.dim
    p = graph.params
    pq = graph.pq
    codebook_bytes = pq.tobytes() if pq is not None else b""
    pq_m = pq.m if pq is not None else 0
    pq_nbits = pq.nbits if pq is not None else 0
    codes_bytes = (
        _c(np.ascontiguousarray(graph.pq_codes[:n]).tobytes()) if pq is not None else b""
    )
    # adjacency: varint per §4.3, zstd over the whole section
    # (each row: its degree, then its live neighbor ids, in row order)
    adj = np.asarray(graph.adjacency[:n], np.int64)
    live = adj >= 0
    values = np.concatenate([live.sum(axis=1, keepdims=True), adj], axis=1)
    body, lengths = _encode_varints(values[np.concatenate([np.ones((n, 1), bool), live], axis=1)])
    row_bytes = np.bincount(
        np.repeat(np.arange(n), live.sum(axis=1) + 1), weights=lengths, minlength=n
    ).astype(np.uint64)
    offsets = np.zeros(n + 1, np.uint64)
    offsets[1:] = np.cumsum(row_bytes)
    adjacency_bytes = _c(body)
    offsets_bytes = offsets.tobytes()
    vectors_bytes = (
        np.ascontiguousarray(graph.vectors[:n], dtype=np.float32).tobytes()
        if include_vectors
        else b""
    )
    locmap_bytes = _encode_locmap(locmap)
    tombstone_bytes = np.packbits(graph.tombstones[:n]).tobytes()

    header_size = _DANN_HEADER.size
    off = header_size
    section_offsets = []
    for blob in (codebook_bytes, codes_bytes, offsets_bytes, adjacency_bytes, vectors_bytes, locmap_bytes, tombstone_bytes):
        section_offsets.append(off)
        off += len(blob)
    header = _DANN_HEADER.pack(
        _DANN_MAGIC,
        1,
        d,
        n,
        p.R,
        p.L,
        graph.medoid,
        _METRIC_CODE[p.metric],
        1 if include_vectors else 0,
        pq_m,
        pq_nbits,
        p.alpha,
        *section_offsets,
    )
    return b"".join(
        [header, codebook_bytes, codes_bytes, offsets_bytes, adjacency_bytes, vectors_bytes, locmap_bytes, tombstone_bytes]
    )


def decode_shard_blob(
    data: bytes,
    *,
    vectors_override: Optional[np.ndarray] = None,
    lazy_vectors: bool = False,
    device="cuda",
):
    """Decode a DANN blob back into a (VamanaGraph, ShardLocationMap).

    ``vectors_override`` supplies full vectors when the blob was written with
    ``include_vectors=False`` (the paper's re-fetch-from-Parquet policy);
    ``lazy_vectors=True`` instead returns the graph with zeroed vectors so
    the caller can fetch them through the location map (the executor's lean
    path).  ``device`` is the decoded graph's device.
    """
    from repro_torch.core.pq import PQCodebook
    from repro_torch.core.vamana import VamanaGraph, VamanaParams, _round_capacity

    (
        magic,
        version,
        d,
        n,
        R,
        L,
        medoid,
        metric_code,
        has_vectors,
        pq_m,
        pq_nbits,
        alpha,
        off_codebook,
        off_codes,
        off_offsets,
        off_adjacency,
        off_vectors,
        off_locmap,
        off_tombstones,
    ) = _DANN_HEADER.unpack(data[: _DANN_HEADER.size])
    if magic != _DANN_MAGIC:
        raise ValueError("bad DANN magic")
    metric = _METRIC_NAME[metric_code]
    params = VamanaParams(R=R, L=L, alpha=alpha, metric=metric)
    pq = None
    codes = None
    if pq_m:
        K = 1 << pq_nbits
        dsub = d // pq_m
        pq = PQCodebook.frombytes(data[off_codebook:off_codes], pq_m, K, dsub, metric)
        codes = np.frombuffer(_d(data[off_codes:off_offsets]), np.uint8).reshape(n, pq_m)
    adj_raw = _d(data[off_adjacency:off_vectors])
    cap = _round_capacity(n)
    adjacency = np.full((cap, R), -1, np.int32)
    if n:
        # the offsets table gives each row's first byte: its degree varint
        offsets = np.frombuffer(data[off_offsets:off_adjacency], np.uint64)
        if offsets.size != n + 1 or int(offsets[n]) != len(adj_raw):
            raise ValueError("adjacency offsets do not match the adjacency section")
        vals, value_of = _decode_varints(adj_raw)
        head = value_of[offsets[:n].astype(np.int64)]
        deg = vals[head].astype(np.int64)
        rows = np.repeat(np.arange(n), deg)
        cols = np.arange(rows.size) - np.repeat(np.cumsum(deg) - deg, deg)
        adjacency[rows, cols] = vals[np.repeat(head + 1, deg) + cols]
    if has_vectors:
        vectors = np.frombuffer(data[off_vectors:off_locmap], np.float32).reshape(n, d)
    elif vectors_override is not None:
        vectors = np.ascontiguousarray(vectors_override, dtype=np.float32)
        if vectors.shape != (n, d):
            raise ValueError(f"override shape {vectors.shape} != ({n},{d})")
    elif lazy_vectors:
        vectors = np.zeros((n, d), np.float32)
    else:
        raise ValueError("blob has no vectors and no override provided")
    padded = np.zeros((cap, d), np.float32)
    padded[:n] = vectors
    tombstones = np.unpackbits(
        np.frombuffer(data[off_tombstones:], np.uint8), count=n
    ).astype(bool)
    ts = np.zeros(cap, bool)
    ts[:n] = tombstones
    graph = VamanaGraph(
        vectors=padded,
        adjacency=adjacency,
        n=n,
        medoid=medoid,
        params=params,
        tombstones=ts,
        device=device,
    )
    if pq is not None:
        graph.attach_pq(pq, codes)
    locmap = _decode_locmap(data[off_locmap:off_tombstones])
    return graph, locmap


# ---------------------------------------------------------------------------
# attribute zone-map blob (repro.attr-zonemap-v1)
# ---------------------------------------------------------------------------


@dataclass
class AttrZoneMap:
    """Per-(file, row_group) attribute zones + per-shard row-group membership.

    ``zones[file][rg][column]`` is a :class:`repro_torch.runtime.predicates.ZoneStats`
    — min/max for numeric columns, value→count tags for dictionary columns.
    ``shard_membership[shard_id]`` lists the (file, row_group) pairs whose
    rows the shard indexed, so the coordinator can skip a whole shard when no
    member zone can satisfy a predicate; ``None`` (e.g. after a refresh that
    didn't recompute membership) disables pruning for that shard but keeps
    the row-group statistics usable for planning."""

    columns: Dict[str, str]  # column name -> "int" | "dict"
    zones: Dict[str, List[Dict[str, "ZoneStats"]]]
    shard_membership: Optional[Dict[int, List[Tuple[str, int]]]] = None
    # shard-level merged histograms (computed on demand from the decoded
    # file-level histograms, memoized per shard)
    _shard_hist_cache: Dict[int, Dict[str, object]] = field(
        default_factory=dict, repr=False, compare=False
    )

    def _shard_hists(self, shard_id: int) -> Dict[str, object]:
        """Per-column histograms merged across the shard's member FILES.

        A shard typically indexes rows from several files; estimating a
        Range predicate's passing fraction against each row group's
        file-level histogram lets one file's distribution stand in for the
        shard's.  Merging the distinct member files' histograms (re-binned
        over the union range) gives ``plan_filtered`` shard-level evidence
        instead.  Shards spanning a single file keep the file histogram
        bit-for-bit.  Cached per shard; the merged histogram is in-memory
        only, never serialized."""
        cached = self._shard_hist_cache.get(shard_id)
        if cached is not None:
            return cached
        from repro_torch.runtime.predicates import ColumnHistogram

        per_col: Dict[str, List[object]] = {}
        seen: Dict[str, set] = {}
        files = sorted({fp for fp, _ in self.shard_membership[shard_id]})
        for fp in files:
            for rg in self.zones.get(fp, []):
                for col, z in rg.items():
                    if z.hist is not None and col not in seen.setdefault(fp, set()):
                        seen[fp].add(col)
                        per_col.setdefault(col, []).append(z.hist)
        merged = {
            col: ColumnHistogram.merge(hists)
            for col, hists in per_col.items()
            if len(hists) > 1
        }
        merged = {col: h for col, h in merged.items() if h is not None}
        self._shard_hist_cache[shard_id] = merged
        return merged

    def shard_zones(self, shard_id: int) -> Optional[List[Dict[str, "ZoneStats"]]]:
        """The member zones of one shard (None = membership unknown), with
        each zone's histogram upgraded from file-level to the shard-level
        merge (see :meth:`_shard_hists`) so selectivity estimates reflect
        every file the shard indexed."""
        if self.shard_membership is None or shard_id not in self.shard_membership:
            return None
        from dataclasses import replace as _replace

        shard_hists = self._shard_hists(shard_id)
        out = []
        for fp, rg in self.shard_membership[shard_id]:
            per_file = self.zones.get(fp)
            if per_file is None or rg >= len(per_file):
                return None  # stale membership: never prune on partial info
            entry = per_file[rg]
            if shard_hists:
                entry = {
                    col: (
                        _replace(z, hist=shard_hists[col])
                        if z.hist is not None and col in shard_hists
                        else z
                    )
                    for col, z in entry.items()
                }
            out.append(entry)
        return out


def encode_zonemap_blob(zm: AttrZoneMap) -> bytes:
    # per-file equi-width int histograms are stored ONCE per (file, column)
    # — each row group's ZoneStats references the shared file-level
    # histogram, so serializing it inside every zone entry would only
    # duplicate bytes
    histograms: Dict[str, Dict[str, dict]] = {}
    for fp, per_file in zm.zones.items():
        for rg in per_file:
            for col, z in rg.items():
                if z.hist is not None and col not in histograms.get(fp, {}):
                    histograms.setdefault(fp, {})[col] = z.hist.to_json()
    meta = {
        "version": 1,
        "columns": dict(zm.columns),
        "zones": {
            fp: [{c: z.to_json() for c, z in rg.items()} for rg in per_file]
            for fp, per_file in zm.zones.items()
        },
        "histograms": histograms or None,
        "shard-membership": (
            {str(sid): [[fp, rg] for fp, rg in pairs] for sid, pairs in zm.shard_membership.items()}
            if zm.shard_membership is not None
            else None
        ),
    }
    return _c(json.dumps(meta, separators=(",", ":")).encode("utf-8"))


def decode_zonemap_blob(data: bytes) -> AttrZoneMap:
    from dataclasses import replace as _replace

    from repro_torch.runtime.predicates import ColumnHistogram, ZoneStats

    meta = json.loads(_d(data).decode("utf-8"))
    membership = meta.get("shard-membership")
    histograms = {
        fp: {c: ColumnHistogram.from_json(h) for c, h in cols.items()}
        for fp, cols in (meta.get("histograms") or {}).items()
    }
    zones: Dict[str, List[Dict[str, ZoneStats]]] = {}
    for fp, per_file in meta["zones"].items():
        file_hists = histograms.get(fp, {})
        decoded = []
        for rg in per_file:
            entry = {c: ZoneStats.from_json(z) for c, z in rg.items()}
            for c, h in file_hists.items():
                if c in entry:
                    entry[c] = _replace(entry[c], hist=h)
            decoded.append(entry)
        zones[fp] = decoded
    return AttrZoneMap(
        columns=dict(meta["columns"]),
        zones=zones,
        shard_membership=(
            {int(sid): [(fp, int(rg)) for fp, rg in pairs] for sid, pairs in membership.items()}
            if membership is not None
            else None
        ),
    )


def build_zonemap(store, file_paths: List[str]) -> Optional[AttrZoneMap]:
    """Scan the attribute columns of ``file_paths`` into an AttrZoneMap.

    Returns None when the table carries no attribute columns (pure-vector
    tables get no zone-map blob at all)."""
    from dataclasses import replace as _replace

    from repro_torch.lakehouse.vparquet import VParquetReader
    from repro_torch.runtime.predicates import ColumnHistogram, ZoneStats

    columns: Dict[str, str] = {}
    zones: Dict[str, List[Dict[str, ZoneStats]]] = {}
    for fp in file_paths:
        reader = VParquetReader.from_store(store, fp)
        attr_specs = reader.attribute_specs()
        per_file: List[Dict[str, ZoneStats]] = []
        int_values: Dict[str, List[np.ndarray]] = {}
        for rg_id in range(reader.num_row_groups):
            rg_zones: Dict[str, ZoneStats] = {}
            for name, spec in attr_specs.items():
                arr = reader.read_column(name, [rg_id])
                if spec.dictionary is not None:
                    columns[name] = "dict"
                    codes, counts = np.unique(arr, return_counts=True)
                    rg_zones[name] = ZoneStats(
                        count=int(arr.shape[0]),
                        values={
                            spec.dictionary[int(c)]: int(n) for c, n in zip(codes, counts)
                        },
                    )
                else:
                    columns[name] = "int"
                    int_values.setdefault(name, []).append(arr)
                    rg_zones[name] = ZoneStats(
                        count=int(arr.shape[0]),
                        min=(arr.min().item() if arr.shape[0] else 0),
                        max=(arr.max().item() if arr.shape[0] else 0),
                    )
            per_file.append(rg_zones)
        # per-file equi-width histograms for int columns: shared by every
        # row group's ZoneStats — range-predicate selectivity estimation
        # (predicates.Range.estimate_fraction) reads them, and the planner
        # sizes PostfilterBeam pools from the result
        for name, parts in int_values.items():
            hist = ColumnHistogram.build(np.concatenate(parts))
            if hist is None:
                continue
            for rg_zones in per_file:
                if name in rg_zones:
                    rg_zones[name] = _replace(rg_zones[name], hist=hist)
        zones[fp] = per_file
    if not columns:
        return None
    return AttrZoneMap(columns=columns, zones=zones)


# ---------------------------------------------------------------------------
# fresh-tail blob (repro.fresh-tail-v1)
# ---------------------------------------------------------------------------


@dataclass
class TailEntry:
    """One appended-but-unindexed data file: its row groups and their sizes."""

    file_path: str
    row_groups: List[int]
    row_counts: List[int]

    @property
    def num_rows(self) -> int:
        return int(sum(self.row_counts))


@dataclass
class FreshTail:
    """The fresh-tail tier manifest: row groups appended since the last
    indexed snapshot.  ``base_snapshot_id`` is the snapshot the bound index
    actually covers; every entry lists one data file committed after it.
    Probes serve these row groups through exact-scan plan ops alongside the
    graph shards, so appends are searchable without a rebuild; a compaction
    (refresh_index) folds them into the shards and resets the tail."""

    base_snapshot_id: int
    entries: List[TailEntry]

    @property
    def total_rows(self) -> int:
        return int(sum(e.num_rows for e in self.entries))

    @property
    def total_row_groups(self) -> int:
        return int(sum(len(e.row_groups) for e in self.entries))

    def row_group_list(self) -> List[Tuple[str, int, int]]:
        """Flat (file_path, row_group, row_count) triples in tail order —
        the enumeration that defines each row group's synthetic plan-grid
        id (-1, -2, ... in this order)."""
        out: List[Tuple[str, int, int]] = []
        for e in self.entries:
            for rg, cnt in zip(e.row_groups, e.row_counts):
                out.append((e.file_path, int(rg), int(cnt)))
        return out


def encode_fresh_tail_blob(tail: FreshTail) -> bytes:
    meta = {
        "version": 1,
        "base-snapshot-id": tail.base_snapshot_id,
        "entries": [
            {
                "file": e.file_path,
                "row-groups": [int(g) for g in e.row_groups],
                "row-counts": [int(c) for c in e.row_counts],
            }
            for e in tail.entries
        ],
    }
    return _c(json.dumps(meta, separators=(",", ":")).encode("utf-8"))


def decode_fresh_tail_blob(data: bytes) -> FreshTail:
    meta = json.loads(_d(data).decode("utf-8"))
    return FreshTail(
        base_snapshot_id=int(meta["base-snapshot-id"]),
        entries=[
            TailEntry(
                file_path=e["file"],
                row_groups=[int(g) for g in e["row-groups"]],
                row_counts=[int(c) for c in e["row-counts"]],
            )
            for e in meta["entries"]
        ],
    )


# ---------------------------------------------------------------------------
# routing blob
# ---------------------------------------------------------------------------


@dataclass
class ShardInfo:
    shard_id: int
    blob_index: int  # index of this shard's blob within the Puffin file
    vector_count: int
    byte_size: int
    tombstone_ratio: float = 0.0
    executor_hint: str = ""


@dataclass
class RoutingTable:
    base_snapshot_id: int
    dims: int
    metric: str
    params: Dict[str, str]  # R, L, alpha, pq_m, pq_nbits...
    shards: List[ShardInfo]
    covered_files: List[str]
    partition_centroids: np.ndarray  # (P, D) f32 — Stage-0 codebook
    shard_of_partition: Optional[np.ndarray] = None  # (P,) u32

    @property
    def num_shards(self) -> int:
        return len(self.shards)


def encode_routing_blob(rt: RoutingTable) -> bytes:
    meta = {
        "base-snapshot-id": rt.base_snapshot_id,
        "dims": rt.dims,
        "metric": rt.metric,
        "params": rt.params,
        "covered-files": rt.covered_files,
        "shards": [
            {
                "shard-id": s.shard_id,
                "blob-index": s.blob_index,
                "vector-count": s.vector_count,
                "byte-size": s.byte_size,
                "tombstone-ratio": s.tombstone_ratio,
                "executor-hint": s.executor_hint,
            }
            for s in rt.shards
        ],
        "num-partitions": int(rt.partition_centroids.shape[0]),
        "shard-of-partition": (
            rt.shard_of_partition.tolist() if rt.shard_of_partition is not None else None
        ),
    }
    meta_raw = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    cents = np.ascontiguousarray(rt.partition_centroids, dtype=np.float32).tobytes()
    return struct.pack("<I", len(meta_raw)) + meta_raw + cents


def decode_routing_blob(data: bytes) -> RoutingTable:
    (meta_len,) = struct.unpack_from("<I", data, 0)
    meta = json.loads(data[4 : 4 + meta_len].decode("utf-8"))
    p = meta["num-partitions"]
    d = meta["dims"]
    cents = np.frombuffer(data, np.float32, p * d, 4 + meta_len).reshape(p, d).copy()
    shards = [
        ShardInfo(
            shard_id=s["shard-id"],
            blob_index=s["blob-index"],
            vector_count=s["vector-count"],
            byte_size=s["byte-size"],
            tombstone_ratio=s.get("tombstone-ratio", 0.0),
            executor_hint=s.get("executor-hint", ""),
        )
        for s in meta["shards"]
    ]
    sop = meta.get("shard-of-partition")
    return RoutingTable(
        base_snapshot_id=meta["base-snapshot-id"],
        dims=d,
        metric=meta["metric"],
        params=dict(meta["params"]),
        shards=shards,
        covered_files=list(meta["covered-files"]),
        partition_centroids=cents,
        shard_of_partition=np.asarray(sop, np.uint32) if sop is not None else None,
    )
