"""Iceberg-format substrate: Puffin container, snapshots, catalog, diff, GC.

This package implements the table-format mechanics the paper relies on:

- :mod:`repro_torch.iceberg.puffin` — the Puffin sidecar binary container
  (magic ``PFA1``, concatenated blobs, JSON footer, flags) with per-blob
  compression and byte-range random access.
- :mod:`repro_torch.iceberg.snapshot` — snapshots, manifests, manifest lists.
- :mod:`repro_torch.iceberg.catalog` — REST-catalog semantics: atomic commit with
  optimistic concurrency, time travel, ``set-properties`` metadata-only
  updates (the paper's §7.4 refresh commit).
- :mod:`repro_torch.iceberg.diff` — manifest-level snapshot diff
  (EXISTING / ADDED / DELETED), the primitive behind incremental refresh.
- :mod:`repro_torch.iceberg.gc` — orphan-file cleanup, which reaps superseded
  Puffin index files for free (paper §7.4).
"""

from repro_torch.iceberg.puffin import (  # noqa: F401
    BlobMetadata,
    PuffinReader,
    PuffinWriter,
    read_footer,
)
from repro_torch.iceberg.snapshot import (  # noqa: F401
    DataFile,
    FileStatus,
    Manifest,
    Snapshot,
    TableMetadata,
)
from repro_torch.iceberg.catalog import CommitConflict, RestCatalog  # noqa: F401
from repro_torch.iceberg.diff import SnapshotDiff, diff_snapshots  # noqa: F401
from repro_torch.iceberg.gc import collect_orphans  # noqa: F401
