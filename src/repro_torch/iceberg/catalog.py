"""REST-catalog semantics: atomic commit via optimistic concurrency.

The paper (§1, §10) leans on the Iceberg REST catalog for commit arbitration:
two concurrent committers race; one wins, the other observes a conflict and
must retry against the new base.  We reproduce that contract with a
conditional put (``if_none_match``) on a monotonically versioned metadata
object — the same mechanism the Hadoop/Object-store catalogs use.

API shape (subset of the REST catalog the paper touches):

- ``create_table`` / ``load_table`` / ``table_exists`` / ``drop_table``
- ``commit(table, base_version, mutate)`` — CAS commit of mutated metadata
- ``commit_with_retries`` — rebase-and-retry loop (paper §10 notes wasted
  work under contention; the retry counter is surfaced for tests)
- snapshot producers: ``append_files``, ``delete_files``,
  ``set_statistics_file`` (the paper's metadata-only index commit, §7.4)
"""

from __future__ import annotations

import json
import threading
import uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.iceberg.snapshot import (
    DataFile,
    FileStatus,
    Manifest,
    ManifestEntry,
    Snapshot,
    TableMetadata,
    new_snapshot_id,
    now_ms,
    read_manifest_list,
    write_manifest_list,
    STATISTICS_FILE_PROP,
)
from repro_torch.lakehouse.objectstore import NoSuchKey, ObjectStore, PreconditionFailed


class CommitConflict(RuntimeError):
    """Another committer won the race; caller must rebase and retry."""


@dataclass
class CommitStats:
    attempts: int = 0
    conflicts: int = 0


class RestCatalog:
    """Catalog over an object store.  Safe for concurrent in-process use;
    cross-process safety comes from the store's conditional put."""

    def __init__(self, store: ObjectStore, warehouse: str = "warehouse") -> None:
        self.store = store
        self.warehouse = warehouse.strip("/")
        self._lock = threading.Lock()
        self.commit_stats = CommitStats()

    # -- paths ---------------------------------------------------------------
    def _table_dir(self, name: str) -> str:
        return f"{self.warehouse}/{name}"

    def _metadata_key(self, name: str, version: int) -> str:
        return f"{self._table_dir(name)}/metadata/v{version}.metadata.json"

    # -- table lifecycle ------------------------------------------------------
    def create_table(self, name: str, schema: Dict[str, str]) -> TableMetadata:
        meta = TableMetadata(
            table_uuid=str(uuid.uuid4()),
            location=self._table_dir(name),
            schema=dict(schema),
            version=0,
            current_snapshot_id=None,
            snapshots=[],
            properties={},
        )
        try:
            self.store.put(
                self._metadata_key(name, 0),
                json.dumps(meta.to_json()).encode(),
                if_none_match=True,
            )
        except PreconditionFailed:
            raise CommitConflict(f"table {name} already exists") from None
        return meta

    def table_exists(self, name: str) -> bool:
        return self.store.exists(self._metadata_key(name, 0))

    def latest_version(self, name: str) -> int:
        prefix = f"{self._table_dir(name)}/metadata/"
        best = -1
        for key in self.store.list(prefix):
            base = key.rsplit("/", 1)[-1]
            if base.startswith("v") and base.endswith(".metadata.json"):
                try:
                    best = max(best, int(base[1 : -len(".metadata.json")]))
                except ValueError:
                    continue
        if best < 0:
            raise NoSuchKey(name)
        return best

    def load_table(self, name: str, version: Optional[int] = None) -> TableMetadata:
        v = self.latest_version(name) if version is None else version
        data = self.store.get(self._metadata_key(name, v))
        return TableMetadata.from_json(json.loads(data.decode()))

    def drop_table(self, name: str) -> None:
        for key in self.store.list(self._table_dir(name)):
            self.store.delete(key)

    # -- commit ---------------------------------------------------------------
    def commit(
        self,
        name: str,
        base: TableMetadata,
        mutate: Callable[[TableMetadata], TableMetadata],
    ) -> TableMetadata:
        """One CAS attempt: apply ``mutate`` to a copy of ``base``, write
        v(base+1).  ``base`` is never mutated, so a conflicted caller can
        reload and retry against a clean view."""
        base_version = base.version
        new_meta = mutate(TableMetadata.from_json(base.to_json()))
        new_meta.version = base_version + 1
        payload = json.dumps(new_meta.to_json()).encode()
        with self._lock:
            self.commit_stats.attempts += 1
        try:
            self.store.put(self._metadata_key(name, new_meta.version), payload, if_none_match=True)
        except PreconditionFailed:
            with self._lock:
                self.commit_stats.conflicts += 1
            raise CommitConflict(
                f"metadata v{new_meta.version} already exists for {name}"
            ) from None
        return new_meta

    def commit_with_retries(
        self,
        name: str,
        mutate: Callable[[TableMetadata], TableMetadata],
        max_retries: int = 10,
    ) -> TableMetadata:
        """Rebase-and-retry loop — reloads latest metadata on each conflict."""
        for _ in range(max_retries):
            base = self.load_table(name)
            try:
                return self.commit(name, base, mutate)
            except CommitConflict:
                continue
        raise CommitConflict(f"gave up after {max_retries} retries for {name}")

    # -- snapshot producers -----------------------------------------------------
    def _snapshot_paths(self, meta: TableMetadata) -> tuple[str, str]:
        token = uuid.uuid4().hex[:12]
        mdir = f"{meta.location}/metadata"
        return f"{mdir}/manifest-{token}.json", f"{mdir}/manifest-list-{token}.json"

    def _load_tail(self, snap: Snapshot):
        """Decode the fresh-tail manifest a snapshot carries (None if it
        carries none)."""
        from repro_torch.core.blobs import FRESH_TAIL_BLOB_TYPE, decode_fresh_tail_blob
        from repro_torch.iceberg.puffin import PuffinReader

        path = snap.summary.get("ann.fresh-tail-file")
        if path is None:
            return None
        reader = PuffinReader(self.store.stat(path).size, self.store.range_reader(path))
        return decode_fresh_tail_blob(reader.read_first(FRESH_TAIL_BLOB_TYPE))

    def _write_tail(self, meta: TableMetadata, snap: Snapshot, tail) -> None:
        """Persist a fresh-tail manifest as a small Puffin file and bind it
        to ``snap.summary["ann.fresh-tail-file"]``.  Written inside the
        commit closure; a conflicted retry writes a fresh token'd file and
        the loser becomes a GC-able orphan."""
        from repro_torch.core.blobs import FRESH_TAIL_BLOB_TYPE, encode_fresh_tail_blob
        from repro_torch.iceberg.puffin import PuffinWriter

        writer = PuffinWriter(file_properties={"created-by": "repro-flockdb"})
        writer.add_blob(
            encode_fresh_tail_blob(tail),
            type=FRESH_TAIL_BLOB_TYPE,
            snapshot_id=snap.snapshot_id,
            properties={
                "base-snapshot-id": str(tail.base_snapshot_id),
                "row-count": str(tail.total_rows),
            },
        )
        token = uuid.uuid4().hex[:12]
        path = f"{meta.location}/metadata/ann-tail-{token}.puffin"
        self.store.put(path, writer.finish())
        snap.summary["ann.fresh-tail-file"] = path

    def _tail_entry(self, file_path: str):
        """Row-group membership of one freshly written data file."""
        from repro_torch.core.blobs import TailEntry
        from repro_torch.lakehouse.vparquet import VParquetReader

        r = VParquetReader.from_store(self.store, file_path)
        return TailEntry(
            file_path=file_path,
            row_groups=list(range(r.num_row_groups)),
            row_counts=[int(rg["num_rows"]) for rg in r.row_groups],
        )

    def append_files(
        self, name: str, files: List[DataFile], extra_summary: Optional[Dict[str, str]] = None
    ) -> TableMetadata:
        def mutate(meta: TableMetadata) -> TableMetadata:
            manifest_path, list_path = self._snapshot_paths(meta)
            entries = [ManifestEntry(FileStatus.ADDED, f) for f in files]
            Manifest.write(self.store, manifest_path, entries)
            parent = meta.current_snapshot()
            prior = read_manifest_list(self.store, parent.manifest_list) if parent else []
            write_manifest_list(self.store, list_path, prior + [manifest_path])
            snap = Snapshot(
                snapshot_id=new_snapshot_id(),
                parent_snapshot_id=parent.snapshot_id if parent else None,
                sequence_number=(parent.sequence_number + 1) if parent else 1,
                timestamp_ms=now_ms(),
                manifest_list=list_path,
                operation="append",
                summary=dict(extra_summary or {}),
            )
            # Carry forward the statistics-file binding unless overridden: an
            # append invalidates index *freshness* but not its snapshot binding;
            # the refresh protocol decides when to rebind (paper §7).
            if parent and STATISTICS_FILE_PROP not in snap.summary:
                stale = parent.statistics_file or parent.summary.get(
                    "ann.stale-statistics-file"
                )
                if stale:
                    snap.summary["ann.stale-statistics-file"] = stale
                    # Fresh-tail maintenance: the carried index does not
                    # cover the files this commit appends.  Extend the
                    # parent's tail manifest (or start one at the parent —
                    # the last snapshot the index was bound against) with
                    # the new files' row groups, so probes can serve the
                    # appended rows without a rebuild.
                    from repro_torch.core.blobs import FreshTail

                    prior = self._load_tail(parent)
                    base_id = (
                        prior.base_snapshot_id
                        if prior is not None
                        else parent.snapshot_id
                    )
                    entries = list(prior.entries) if prior is not None else []
                    entries.extend(self._tail_entry(f.path) for f in files)
                    self._write_tail(
                        meta, snap, FreshTail(base_snapshot_id=base_id, entries=entries)
                    )
            meta.snapshots.append(snap)
            meta.current_snapshot_id = snap.snapshot_id
            return meta

        return self.commit_with_retries(name, mutate)

    def delete_files(self, name: str, paths: List[str]) -> TableMetadata:
        doomed = set(paths)

        def mutate(meta: TableMetadata) -> TableMetadata:
            parent = meta.current_snapshot()
            if parent is None:
                raise ValueError("cannot delete from an empty table")
            manifest_path, list_path = self._snapshot_paths(meta)
            entries: List[ManifestEntry] = []
            for mpath in read_manifest_list(self.store, parent.manifest_list):
                for e in Manifest.read(self.store, mpath).entries:
                    if e.status == FileStatus.DELETED:
                        continue
                    status = (
                        FileStatus.DELETED if e.data_file.path in doomed else FileStatus.EXISTING
                    )
                    entries.append(ManifestEntry(status, e.data_file))
            Manifest.write(self.store, manifest_path, entries)
            write_manifest_list(self.store, list_path, [manifest_path])
            snap = Snapshot(
                snapshot_id=new_snapshot_id(),
                parent_snapshot_id=parent.snapshot_id,
                sequence_number=parent.sequence_number + 1,
                timestamp_ms=now_ms(),
                manifest_list=list_path,
                operation="delete",
                summary={},
            )
            stale = parent.statistics_file or parent.summary.get(
                "ann.stale-statistics-file"
            )
            if stale:
                snap.summary["ann.stale-statistics-file"] = stale
                # tail entries whose file was just deleted drop out; the
                # rest stay searchable against the new snapshot
                prior = self._load_tail(parent)
                if prior is not None:
                    from repro_torch.core.blobs import FreshTail

                    kept = [e for e in prior.entries if e.file_path not in doomed]
                    if kept:
                        self._write_tail(
                            meta,
                            snap,
                            FreshTail(
                                base_snapshot_id=prior.base_snapshot_id, entries=kept
                            ),
                        )
            meta.snapshots.append(snap)
            meta.current_snapshot_id = snap.snapshot_id
            return meta

        return self.commit_with_retries(name, mutate)

    def expire_snapshots(self, name: str, keep_last: int = 1) -> TableMetadata:
        """Metadata-only commit dropping all but the last ``keep_last``
        snapshots.  This is what makes superseded index Puffin files (and
        their snapshots' manifests) orphaned *in the served metadata*, so a
        subsequent orphan sweep can safely delete them (paper §7.4)."""
        from repro_torch.iceberg.gc import expire_snapshots  # lazy: gc imports snapshot only

        if keep_last < 1:
            raise ValueError("must keep at least one snapshot")
        return self.commit_with_retries(
            name, lambda meta: expire_snapshots(meta, keep_last)
        )

    def set_statistics_file(
        self,
        name: str,
        puffin_path: str,
        *,
        expected_base_snapshot_id: Optional[int] = None,
        extra_summary: Optional[Dict[str, str]] = None,
    ) -> TableMetadata:
        """Metadata-only commit binding a Puffin file (paper §5 Stage 2, §7.4).

        Structurally a REPLACE: the manifest list is reused verbatim; only the
        snapshot summary changes.  ``expected_base_snapshot_id`` implements
        the paper's concurrent-refresh arbitration: if the table moved past
        the snapshot the index was built against, the commit raises and the
        caller must re-diff and retry.
        """

        def mutate(meta: TableMetadata) -> TableMetadata:
            parent = meta.current_snapshot()
            if parent is None:
                raise ValueError("cannot bind statistics to an empty table")
            if (
                expected_base_snapshot_id is not None
                and parent.snapshot_id != expected_base_snapshot_id
            ):
                raise CommitConflict(
                    f"table advanced: expected base {expected_base_snapshot_id}, "
                    f"found {parent.snapshot_id}"
                )
            snap = Snapshot(
                snapshot_id=new_snapshot_id(),
                parent_snapshot_id=parent.snapshot_id,
                sequence_number=parent.sequence_number + 1,
                timestamp_ms=now_ms(),
                manifest_list=parent.manifest_list,  # no data change
                operation="replace",
                summary={STATISTICS_FILE_PROP: puffin_path, **(extra_summary or {})},
            )
            meta.snapshots.append(snap)
            meta.current_snapshot_id = snap.snapshot_id
            return meta

        return self.commit_with_retries(name, mutate)
