"""Table-level IO: the INSERT-SELECT write path and the scan read path.

``LakehouseTable`` bundles (catalog, store, table name) and exposes the two
paths the paper's protocols reuse:

- **write path** — partition an embedding corpus into N vparquet data files
  and commit them as an Iceberg append (this is what "the engine's existing
  INSERT-SELECT path" produces);
- **read path** — scan the vector column of selected files / row groups with
  projection, which both the index build (Stage 1) and exact rerank
  (Stage B) use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from typing import TYPE_CHECKING

from repro_torch.lakehouse.objectstore import ObjectStore
from repro_torch.lakehouse.vparquet import ColumnSpec, VParquetReader, write_vector_file

if TYPE_CHECKING:  # avoid a lakehouse <-> iceberg import cycle at runtime
    from repro_torch.iceberg.catalog import RestCatalog
    from repro_torch.iceberg.snapshot import Snapshot, TableMetadata


@dataclass
class RowLocation:
    """(file, row group, row offset) — the paper's vector-ID→location tuple."""

    file_path: str
    row_group_id: int
    row_offset: int


class LakehouseTable:
    def __init__(self, catalog: RestCatalog, name: str) -> None:
        self.catalog = catalog
        self.store: ObjectStore = catalog.store
        self.name = name

    # -- write path -----------------------------------------------------------
    def create(self, dim: int) -> TableMetadata:
        return self.catalog.create_table(
            self.name, {"id": "long", "vec": f"vector<float32,{dim}>"}
        )

    def append_vectors(
        self,
        vectors: np.ndarray,
        *,
        num_files: int = 4,
        rows_per_group: int = 4096,
        file_prefix: str = "data",
        attributes: Optional[Dict[str, np.ndarray]] = None,
    ) -> TableMetadata:
        """Write ``vectors`` as ``num_files`` data files and commit an append.

        ``attributes`` adds per-row attribute columns alongside ``vec``:
        int64 (or any numeric) arrays are stored directly, string arrays are
        dictionary-encoded per file — the substrate filtered search scans."""
        from repro_torch.iceberg.snapshot import DataFile  # lazy: avoid import cycle

        vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        meta = self.catalog.load_table(self.name)
        n = vectors.shape[0]
        attrs = {k: np.asarray(v) for k, v in (attributes or {}).items()}
        for name, arr in attrs.items():
            if arr.shape[0] != n:
                raise ValueError(f"attribute {name}: {arr.shape[0]} rows != {n}")
        splits = np.array_split(np.arange(n), num_files)
        existing = len(self.current_files()) if meta.current_snapshot_id else 0
        files: List[DataFile] = []
        for i, idx in enumerate(splits):
            if len(idx) == 0:
                continue
            key = f"{meta.location}/data/{file_prefix}-{existing + i:05d}.vpq"
            size = write_vector_file(
                self.store,
                key,
                vectors[idx],
                rows_per_group=rows_per_group,
                extra_columns={k: v[idx] for k, v in attrs.items()} or None,
            )
            files.append(DataFile(path=key, record_count=len(idx), file_size_bytes=size))
        return self.catalog.append_files(self.name, files)

    def delete_files(self, paths: List[str]) -> TableMetadata:
        return self.catalog.delete_files(self.name, paths)

    # -- read path --------------------------------------------------------------
    def metadata(self) -> TableMetadata:
        return self.catalog.load_table(self.name)

    def current_snapshot(self) -> Optional[Snapshot]:
        return self.metadata().current_snapshot()

    def current_files(self, snapshot_id: Optional[int] = None) -> "List[DataFile]":
        from repro_torch.iceberg.snapshot import live_data_files  # lazy: import cycle

        meta = self.metadata()
        snap = (
            meta.snapshot_by_id(snapshot_id)
            if snapshot_id is not None
            else meta.current_snapshot()
        )
        if snap is None:
            return []
        return live_data_files(self.store, snap)

    def reader(self, file_path: str) -> VParquetReader:
        return VParquetReader.from_store(self.store, file_path)

    def scan_vectors(
        self, snapshot_id: Optional[int] = None, file_paths: Optional[Sequence[str]] = None
    ) -> Tuple[np.ndarray, List[RowLocation]]:
        """Full scan of the vector column (the paper's "no index" path).

        Returns the concatenated vectors plus per-row locations.
        """
        files = self.current_files(snapshot_id)
        if file_paths is not None:
            wanted = set(file_paths)
            files = [f for f in files if f.path in wanted]
        vecs: List[np.ndarray] = []
        locs: List[RowLocation] = []
        for f in files:
            r = self.reader(f.path)
            for rg_id, rg in enumerate(r.row_groups):
                arr = r.read_column("vec", [rg_id])
                vecs.append(arr)
                locs.extend(
                    RowLocation(f.path, rg_id, row) for row in range(rg["num_rows"])
                )
        if not vecs:
            return np.empty((0, 0), np.float32), []
        return np.concatenate(vecs, axis=0), locs

    def attribute_schema(self) -> Dict[str, "ColumnSpec"]:
        """Scalar attribute columns across all live data files — the
        filterable surface of the table (mixed-schema appends contribute
        their union; the first file carrying a column defines its spec)."""
        out: Dict[str, ColumnSpec] = {}
        for f in self.current_files():
            for name, spec in self.reader(f.path).attribute_specs().items():
                out.setdefault(name, spec)
        return out

    def scan_attributes(
        self,
        columns: Optional[Sequence[str]] = None,
        snapshot_id: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Scan attribute columns, row-aligned with :meth:`scan_vectors`.

        Dictionary-encoded string columns come back as decoded value arrays
        (each file's codes mapped through its own dictionary).  Files
        written without a column (mixed-schema appends) keep the alignment:
        their rows are filled with ``None`` and the column comes back as an
        object array — never a float promotion, which would silently round
        int64 values above 2^53.  Homogeneous tables keep native dtypes."""
        files = self.current_files(snapshot_id)
        readers = [self.reader(f.path) for f in files]
        names = (
            list(columns)
            if columns is not None
            else sorted({n for r in readers for n in r.attribute_specs()})
        )
        out: Dict[str, List[np.ndarray]] = {name: [] for name in names}
        for r in readers:
            for name in names:
                spec = r.columns.get(name)
                if spec is None:
                    out[name].append(np.full(r.num_rows, None, dtype=object))
                    continue
                arr = r.read_column(name)
                if spec.dictionary is not None:
                    arr = np.asarray(spec.dictionary, dtype=object)[arr]
                out[name].append(arr)
        return {k: np.concatenate(v) for k, v in out.items() if v}

    def fetch_rows(
        self, masks: Dict[str, Dict[int, List[int]]]
    ) -> Tuple[np.ndarray, List[RowLocation]]:
        """Stage-B fetch: ``masks[file][row_group] = [row offsets]``."""
        vecs: List[np.ndarray] = []
        locs: List[RowLocation] = []
        for file_path, groups in masks.items():
            r = self.reader(file_path)
            for rg_id, rows in groups.items():
                arr = r.read_rows("vec", rg_id, rows)
                vecs.append(arr)
                locs.extend(RowLocation(file_path, rg_id, row) for row in rows)
        if not vecs:
            return np.empty((0, 0), np.float32), []
        return np.concatenate(vecs, axis=0), locs
