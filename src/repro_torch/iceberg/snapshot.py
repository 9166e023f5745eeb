"""Iceberg table metadata: snapshots, manifests, manifest lists.

A deliberately compact but semantically faithful model of the Iceberg spec
surface the paper uses:

- a table is a chain of immutable **snapshots**;
- each snapshot references a **manifest list**, which references **manifest
  files**, whose entries carry a status flag (EXISTING / ADDED / DELETED)
  and describe the data files live at that snapshot;
- the snapshot **summary** is a free-form string map — the paper binds a
  Puffin index file through ``summary["statistics-file"]``;
- commits are arbitrated by the catalog with optimistic concurrency.

Everything serializes to JSON in the object store under
``<table_location>/metadata/`` so that multiple "engines" (processes) can
read the same table — the multi-engine interoperability property.
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

from repro_torch.lakehouse.objectstore import ObjectStore

STATISTICS_FILE_PROP = "statistics-file"


class FileStatus(str, Enum):
    EXISTING = "EXISTING"
    ADDED = "ADDED"
    DELETED = "DELETED"


@dataclass
class DataFile:
    path: str
    record_count: int
    file_size_bytes: int
    partition: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "path": self.path,
            "record-count": self.record_count,
            "file-size-bytes": self.file_size_bytes,
            "partition": self.partition,
        }

    @staticmethod
    def from_json(obj: dict) -> "DataFile":
        return DataFile(
            path=obj["path"],
            record_count=int(obj["record-count"]),
            file_size_bytes=int(obj["file-size-bytes"]),
            partition=dict(obj.get("partition", {})),
        )


@dataclass
class ManifestEntry:
    status: FileStatus
    data_file: DataFile

    def to_json(self) -> dict:
        return {"status": self.status.value, "data-file": self.data_file.to_json()}

    @staticmethod
    def from_json(obj: dict) -> "ManifestEntry":
        return ManifestEntry(FileStatus(obj["status"]), DataFile.from_json(obj["data-file"]))


@dataclass
class Manifest:
    path: str
    entries: List[ManifestEntry]

    def live_files(self) -> List[DataFile]:
        return [e.data_file for e in self.entries if e.status != FileStatus.DELETED]

    @staticmethod
    def write(store: ObjectStore, path: str, entries: List[ManifestEntry]) -> "Manifest":
        payload = json.dumps({"entries": [e.to_json() for e in entries]}).encode()
        store.put(path, payload)
        return Manifest(path, entries)

    @staticmethod
    def read(store: ObjectStore, path: str) -> "Manifest":
        obj = json.loads(store.get(path).decode())
        return Manifest(path, [ManifestEntry.from_json(e) for e in obj["entries"]])


@dataclass
class Snapshot:
    snapshot_id: int
    parent_snapshot_id: Optional[int]
    sequence_number: int
    timestamp_ms: int
    manifest_list: str  # object-store key of the manifest list JSON
    operation: str  # append | delete | replace | overwrite
    summary: Dict[str, str] = field(default_factory=dict)

    @property
    def statistics_file(self) -> Optional[str]:
        return self.summary.get(STATISTICS_FILE_PROP)

    def to_json(self) -> dict:
        return {
            "snapshot-id": self.snapshot_id,
            "parent-snapshot-id": self.parent_snapshot_id,
            "sequence-number": self.sequence_number,
            "timestamp-ms": self.timestamp_ms,
            "manifest-list": self.manifest_list,
            "operation": self.operation,
            "summary": dict(self.summary),
        }

    @staticmethod
    def from_json(obj: dict) -> "Snapshot":
        return Snapshot(
            snapshot_id=int(obj["snapshot-id"]),
            parent_snapshot_id=obj.get("parent-snapshot-id"),
            sequence_number=int(obj["sequence-number"]),
            timestamp_ms=int(obj["timestamp-ms"]),
            manifest_list=obj["manifest-list"],
            operation=obj.get("operation", "append"),
            summary=dict(obj.get("summary", {})),
        )


@dataclass
class TableMetadata:
    table_uuid: str
    location: str
    schema: Dict[str, str]  # column name -> type string (incl. vector cols)
    version: int
    current_snapshot_id: Optional[int]
    snapshots: List[Snapshot] = field(default_factory=list)
    properties: Dict[str, str] = field(default_factory=dict)

    # -- lookups -----------------------------------------------------------
    def snapshot_by_id(self, snapshot_id: int) -> Snapshot:
        for s in self.snapshots:
            if s.snapshot_id == snapshot_id:
                return s
        raise KeyError(f"snapshot {snapshot_id} not found")

    def current_snapshot(self) -> Optional[Snapshot]:
        if self.current_snapshot_id is None:
            return None
        return self.snapshot_by_id(self.current_snapshot_id)

    def snapshot_as_of(self, timestamp_ms: int) -> Snapshot:
        """Time travel: the latest snapshot at or before ``timestamp_ms``."""
        eligible = [s for s in self.snapshots if s.timestamp_ms <= timestamp_ms]
        if not eligible:
            raise KeyError(f"no snapshot as of {timestamp_ms}")
        return max(eligible, key=lambda s: (s.timestamp_ms, s.sequence_number))

    # -- serialization -----------------------------------------------------
    def to_json(self) -> dict:
        return {
            "table-uuid": self.table_uuid,
            "location": self.location,
            "schema": self.schema,
            "version": self.version,
            "current-snapshot-id": self.current_snapshot_id,
            "snapshots": [s.to_json() for s in self.snapshots],
            "properties": dict(self.properties),
        }

    @staticmethod
    def from_json(obj: dict) -> "TableMetadata":
        return TableMetadata(
            table_uuid=obj["table-uuid"],
            location=obj["location"],
            schema=dict(obj["schema"]),
            version=int(obj["version"]),
            current_snapshot_id=obj.get("current-snapshot-id"),
            snapshots=[Snapshot.from_json(s) for s in obj.get("snapshots", [])],
            properties=dict(obj.get("properties", {})),
        )


# -- manifest list helpers ---------------------------------------------------

def write_manifest_list(store: ObjectStore, path: str, manifest_paths: List[str]) -> None:
    store.put(path, json.dumps({"manifests": manifest_paths}).encode())


def read_manifest_list(store: ObjectStore, path: str) -> List[str]:
    return list(json.loads(store.get(path).decode())["manifests"])


def live_data_files(store: ObjectStore, snapshot: Snapshot) -> List[DataFile]:
    """All data files live at ``snapshot`` (flattened across manifests)."""
    out: List[DataFile] = []
    for mpath in read_manifest_list(store, snapshot.manifest_list):
        out.extend(Manifest.read(store, mpath).live_files())
    return out


def new_snapshot_id() -> int:
    return uuid.uuid4().int & ((1 << 62) - 1)


def now_ms() -> int:
    return int(time.time() * 1000)
