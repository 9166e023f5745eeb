"""Snapshot differ — the primitive behind incremental refresh (paper §7.1).

Given two snapshot IDs, classify every data file as EXISTING (live in both),
ADDED (live only in the target), or DELETED (live only in the base).  The
refresh protocol feeds ADDED files to Vamana greedy insert and DELETED files
to lazy tombstoning.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.iceberg.snapshot import DataFile, TableMetadata, live_data_files
from repro_torch.lakehouse.objectstore import ObjectStore


@dataclass
class SnapshotDiff:
    base_snapshot_id: int
    target_snapshot_id: int
    existing: List[DataFile] = field(default_factory=list)
    added: List[DataFile] = field(default_factory=list)
    deleted: List[DataFile] = field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not self.added and not self.deleted


def diff_snapshots(
    store: ObjectStore,
    meta: TableMetadata,
    base_snapshot_id: int,
    target_snapshot_id: int,
) -> SnapshotDiff:
    base_files: Dict[str, DataFile] = {
        f.path: f for f in live_data_files(store, meta.snapshot_by_id(base_snapshot_id))
    }
    target_files: Dict[str, DataFile] = {
        f.path: f for f in live_data_files(store, meta.snapshot_by_id(target_snapshot_id))
    }
    diff = SnapshotDiff(base_snapshot_id, target_snapshot_id)
    for path, f in sorted(target_files.items()):
        (diff.existing if path in base_files else diff.added).append(f)
    for path, f in sorted(base_files.items()):
        if path not in target_files:
            diff.deleted.append(f)
    return diff
