"""``vparquet`` — a minimal columnar file format with row groups.

pyarrow is not available in this environment, so the framework carries its
own Parquet-shaped format.  It preserves the three properties the paper's
protocols depend on:

1. **Column projection** — the index build reads *only* the vector column
   (paper Stage 1: "column projection limited to the vector column").
2. **Row-group granularity** — the exact-rerank stage reads *only* the row
   groups containing candidate vectors (paper Stage B: "per-file row-group
   masks").
3. **Footer-based random access** — readers range-read the footer, then
   range-read only the targeted column chunks.

Layout::

    magic ``VPQ1``
    column chunk bytes (row-group-major, column-minor), each optionally zstd
    footer JSON  { "columns": [{name,dtype,vlen}],
                   "row_groups": [{num_rows, chunks:{col:{offset,length,codec}}}] }
    footer length (u32 LE)
    magic ``VPQ1``
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.lakehouse.objectstore import ObjectStore

try:
    import zstandard as _zstd

    _HAVE_ZSTD = True
except Exception:  # pragma: no cover
    _HAVE_ZSTD = False

MAGIC = b"VPQ1"


def _encode(codec: Optional[str], data: bytes) -> bytes:
    if codec == "zstd" and _HAVE_ZSTD:
        return _zstd.ZstdCompressor(level=1).compress(data)
    return data


def _decode(codec: Optional[str], data: bytes) -> bytes:
    if codec == "zstd":
        return _zstd.ZstdDecompressor().decompress(data)
    return data


@dataclass
class ColumnSpec:
    name: str
    dtype: str  # numpy dtype string
    vlen: int  # vector length per row (0 => scalar column)
    # dictionary-encoded string column: the stored ints are codes into this
    # per-file value table (attribute columns for filtered search)
    dictionary: Optional[List[str]] = None


class VParquetWriter:
    def __init__(self, columns: Sequence[ColumnSpec], codec: Optional[str] = None) -> None:
        self.columns = list(columns)
        self.codec = codec if (codec != "zstd" or _HAVE_ZSTD) else None
        self._chunks: List[bytes] = [MAGIC]
        self._offset = len(MAGIC)
        self._row_groups: List[dict] = []

    def write_row_group(self, arrays: Dict[str, np.ndarray]) -> None:
        num_rows = None
        chunk_meta: Dict[str, dict] = {}
        for spec in self.columns:
            arr = np.ascontiguousarray(arrays[spec.name])
            if str(arr.dtype) != spec.dtype:
                raise TypeError(f"column {spec.name}: dtype {arr.dtype} != {spec.dtype}")
            rows = arr.shape[0]
            if spec.vlen and (arr.ndim != 2 or arr.shape[1] != spec.vlen):
                raise ValueError(f"column {spec.name}: expected (N,{spec.vlen}), got {arr.shape}")
            if not spec.vlen and arr.ndim != 1:
                raise ValueError(f"column {spec.name}: expected 1-D, got {arr.shape}")
            if num_rows is None:
                num_rows = rows
            elif rows != num_rows:
                raise ValueError("ragged row group")
            raw = arr.tobytes()
            stored = _encode(self.codec, raw)
            chunk_meta[spec.name] = {
                "offset": self._offset,
                "length": len(stored),
                "codec": self.codec if self.codec else None,
            }
            self._chunks.append(stored)
            self._offset += len(stored)
        self._row_groups.append({"num_rows": int(num_rows or 0), "chunks": chunk_meta})

    def finish(self) -> bytes:
        footer = json.dumps(
            {
                "columns": [
                    {"name": c.name, "dtype": c.dtype, "vlen": c.vlen}
                    | ({"dictionary": c.dictionary} if c.dictionary is not None else {})
                    for c in self.columns
                ],
                "row_groups": self._row_groups,
            },
            separators=(",", ":"),
        ).encode("utf-8")
        self._chunks.append(footer)
        self._chunks.append(struct.pack("<I", len(footer)))
        self._chunks.append(MAGIC)
        return b"".join(self._chunks)


class VParquetReader:
    """Footer-driven reader over a byte-range callable."""

    def __init__(self, size: int, range_reader) -> None:
        self._read = range_reader
        tail = range_reader(size - 8, 8)
        (footer_len,) = struct.unpack("<I", tail[:4])
        if tail[4:8] != MAGIC:
            raise ValueError("bad vparquet trailing magic")
        footer = json.loads(range_reader(size - 8 - footer_len, footer_len).decode("utf-8"))
        self.columns = {
            c["name"]: ColumnSpec(c["name"], c["dtype"], c["vlen"], c.get("dictionary"))
            for c in footer["columns"]
        }
        self.row_groups: List[dict] = footer["row_groups"]

    @classmethod
    def from_bytes(cls, data: bytes) -> "VParquetReader":
        return cls(len(data), lambda off, ln: data[off : off + ln])

    @classmethod
    def from_store(cls, store: ObjectStore, key: str) -> "VParquetReader":
        return cls(store.stat(key).size, store.range_reader(key))

    @property
    def num_rows(self) -> int:
        return sum(rg["num_rows"] for rg in self.row_groups)

    def attribute_specs(self) -> Dict[str, ColumnSpec]:
        """Scalar attribute columns — everything but the reserved ``vec``
        and ``id`` columns.  The single definition of "filterable column"
        shared by zone-map construction and the table scan paths."""
        return {
            name: spec
            for name, spec in self.columns.items()
            if spec.vlen == 0 and name not in ("vec", "id")
        }

    @property
    def num_row_groups(self) -> int:
        return len(self.row_groups)

    def row_group_offsets(self) -> np.ndarray:
        """Starting global row index of each row group (plus total at end)."""
        sizes = [rg["num_rows"] for rg in self.row_groups]
        return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    def read_column(
        self, name: str, row_group_ids: Optional[Sequence[int]] = None
    ) -> np.ndarray:
        """Read one column from the selected row groups (all if None)."""
        spec = self.columns[name]
        ids = range(len(self.row_groups)) if row_group_ids is None else row_group_ids
        parts: List[np.ndarray] = []
        for rg_id in ids:
            rg = self.row_groups[rg_id]
            meta = rg["chunks"][name]
            raw = _decode(meta["codec"], self._read(meta["offset"], meta["length"]))
            arr = np.frombuffer(raw, dtype=np.dtype(spec.dtype))
            if spec.vlen:
                arr = arr.reshape(rg["num_rows"], spec.vlen)
            parts.append(arr)
        if not parts:
            shape = (0, spec.vlen) if spec.vlen else (0,)
            return np.empty(shape, dtype=np.dtype(spec.dtype))
        return np.concatenate(parts, axis=0)

    def read_rows(
        self, name: str, row_group_id: int, row_offsets: Sequence[int]
    ) -> np.ndarray:
        """Read specific rows of one row group (Stage-B candidate fetch)."""
        col = self.read_column(name, [row_group_id])
        return col[np.asarray(row_offsets, dtype=np.int64)]


# -- convenience helpers used throughout tests/benchmarks -------------------

def dictionary_encode(values: np.ndarray) -> Tuple[np.ndarray, List[str]]:
    """String array → (int32 codes, sorted value dictionary)."""
    strs = np.asarray(values).astype(str)
    dictionary, codes = np.unique(strs, return_inverse=True)
    return codes.astype(np.int32), [str(v) for v in dictionary]


def write_vector_file(
    store: ObjectStore,
    key: str,
    vectors: np.ndarray,
    *,
    rows_per_group: int = 4096,
    codec: Optional[str] = None,
    extra_columns: Optional[Dict[str, np.ndarray]] = None,
) -> int:
    """Write an embedding table file with a ``vec`` column (+ row ``id``).

    ``extra_columns`` carries attribute columns for filtered search: numeric
    arrays are stored as-is; string arrays are dictionary-encoded (int32
    codes + per-file value table in the footer's ``ColumnSpec``)."""
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    cols = [ColumnSpec("vec", "float32", d), ColumnSpec("id", "int64", 0)]
    extra = dict(extra_columns or {})
    for name, arr in list(extra.items()):
        arr = np.asarray(arr)
        if arr.dtype.kind in ("U", "S", "O"):
            codes, dictionary = dictionary_encode(arr)
            extra[name] = codes
            cols.append(ColumnSpec(name, "int32", 0, dictionary))
            continue
        vlen = arr.shape[1] if arr.ndim == 2 else 0
        cols.append(ColumnSpec(name, str(arr.dtype), vlen))
    w = VParquetWriter(cols, codec=codec)
    ids = np.arange(n, dtype=np.int64)
    for start in range(0, n, rows_per_group):
        stop = min(start + rows_per_group, n)
        group = {"vec": vectors[start:stop], "id": ids[start:stop]}
        for name, arr in extra.items():
            group[name] = arr[start:stop]
        w.write_row_group(group)
    data = w.finish()
    store.put(key, data)
    return len(data)


def read_vector_column(
    store: ObjectStore, key: str, row_group_ids: Optional[Sequence[int]] = None
) -> np.ndarray:
    return VParquetReader.from_store(store, key).read_column("vec", row_group_ids)
