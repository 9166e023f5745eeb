"""Orphan-file cleanup (paper §7.4: superseded Puffin files are "reaped by
the table format's existing orphan-file cleanup").

An object under the table location is *referenced* if it is:
- a metadata json (``v*.metadata.json``) at or below the retained version,
- a manifest list / manifest reachable from any retained snapshot,
- a data file live in any retained snapshot's manifests (any status — DELETED
  entries still reference the file for time travel),
- a Puffin file named by any retained snapshot's summary
  (``statistics-file``, ``ann.stale-statistics-file``, or the fresh-tail
  manifest ``ann.fresh-tail-file``).

Everything else is an orphan.  ``collect_orphans`` returns them;
``expire_and_collect`` additionally drops old snapshots first, which is how
superseded index Puffins (e.g. the pre-refresh index) become orphaned.

Passing ``catalog=`` to ``expire_and_collect`` COMMITS the expiration as a
new metadata version before collecting.  Without it the expiration exists
only in the caller's in-memory copy: the catalog keeps serving the expired
snapshots, and deleting their now-orphaned objects leaves the served
metadata pointing at missing manifests/Puffins (time travel crashes with
NoSuchKey).  Deleting orphans is therefore only safe with the committed
form — the uncommitted form remains for dry-run inspection.
"""

from __future__ import annotations

from typing import List, Optional, Set

from repro_torch.iceberg.snapshot import (
    Manifest,
    TableMetadata,
    read_manifest_list,
    STATISTICS_FILE_PROP,
)
from repro_torch.lakehouse.objectstore import ObjectStore


def _referenced_keys(store: ObjectStore, meta: TableMetadata) -> Set[str]:
    refs: Set[str] = set()
    for v in range(meta.version + 1):
        refs.add(f"{meta.location}/metadata/v{v}.metadata.json")
    for snap in meta.snapshots:
        refs.add(snap.manifest_list)
        for mpath in read_manifest_list(store, snap.manifest_list):
            refs.add(mpath)
            for entry in Manifest.read(store, mpath).entries:
                refs.add(entry.data_file.path)
        for key in (
            STATISTICS_FILE_PROP,
            "ann.stale-statistics-file",
            "ann.fresh-tail-file",
        ):
            if key in snap.summary:
                refs.add(snap.summary[key])
    return refs


def collect_orphans(store: ObjectStore, meta: TableMetadata) -> List[str]:
    refs = _referenced_keys(store, meta)
    return [k for k in store.list(meta.location + "/") if k not in refs]


def expire_snapshots(meta: TableMetadata, keep_last: int = 1) -> TableMetadata:
    """Drop all but the last ``keep_last`` snapshots (by sequence number)."""
    if keep_last < 1:
        raise ValueError("must keep at least one snapshot")
    meta.snapshots.sort(key=lambda s: s.sequence_number)
    meta.snapshots = meta.snapshots[-keep_last:]
    if meta.snapshots:
        meta.current_snapshot_id = meta.snapshots[-1].snapshot_id
    return meta


def expire_and_collect(
    store: ObjectStore,
    meta: TableMetadata,
    keep_last: int = 1,
    delete: bool = False,
    catalog=None,
    table_name: Optional[str] = None,
) -> List[str]:
    """Expire old snapshots, then list (optionally delete) orphans.

    With ``catalog`` (a :class:`repro_torch.iceberg.catalog.RestCatalog`) and
    ``table_name``, the expiration is committed as a metadata-only new
    version first, so the catalog's served snapshot list agrees with what
    remains in storage — required before ``delete=True`` or readers can
    load snapshots whose backing objects are gone."""
    if catalog is not None:
        if table_name is None:
            # the location basename only happens to equal the catalog name
            # today — don't commit against a guessed table
            raise ValueError("table_name is required when catalog is given")
        meta = catalog.expire_snapshots(table_name, keep_last=keep_last)
    else:
        meta = expire_snapshots(meta, keep_last)
    orphans = collect_orphans(store, meta)
    if delete:
        for key in orphans:
            store.delete(key)
    return orphans
