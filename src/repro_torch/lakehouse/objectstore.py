"""S3-compatible object store simulation over a local directory.

The paper's engine reads everything from object storage and treats executor
SSD purely as a cache.  This module provides the storage contract the rest of
the system programs against:

- immutable puts (no partial overwrite; conditional put for CAS commits),
- byte-range gets (``get_range``) — the access pattern Puffin depends on,
- listing by prefix, deletes, etags, and per-object size,
- simple read/write byte accounting so benchmarks can report "data read from
  S3" the way the paper's Table 2 does.

Thread safety: a single lock guards metadata; payload IO is done outside the
lock where possible.  Executors in the in-process runtime share one store
instance, mirroring a shared S3 endpoint.
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional


class NoSuchKey(KeyError):
    pass


class PreconditionFailed(RuntimeError):
    """Conditional put failed (CAS conflict)."""


@dataclass
class ObjectStat:
    key: str
    size: int
    etag: str


@dataclass
class StoreMetrics:
    """Byte/op accounting, reset-able per benchmark."""

    bytes_read: int = 0
    bytes_written: int = 0
    get_ops: int = 0
    put_ops: int = 0
    range_gets: int = 0
    per_key_reads: Dict[str, int] = field(default_factory=dict)

    def reset(self) -> None:
        self.bytes_read = 0
        self.bytes_written = 0
        self.get_ops = 0
        self.put_ops = 0
        self.range_gets = 0
        self.per_key_reads.clear()


class ObjectStore:
    """Local-directory object store with S3-like semantics."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._etags: Dict[str, str] = {}
        self.metrics = StoreMetrics()

    # -- path mapping ------------------------------------------------------
    def _path(self, key: str) -> str:
        key = key.lstrip("/")
        if ".." in key.split("/"):
            raise ValueError(f"invalid key: {key}")
        return os.path.join(self.root, key)

    # -- writes ------------------------------------------------------------
    def put(self, key: str, data: bytes, *, if_none_match: bool = False) -> ObjectStat:
        """Atomic put.  ``if_none_match=True`` fails if the key exists (CAS
        create — what an Iceberg catalog uses to arbitrate commits)."""
        path = self._path(key)
        etag = hashlib.sha256(data).hexdigest()[:16]
        with self._lock:
            if if_none_match and os.path.exists(path):
                raise PreconditionFailed(key)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp.%d" % threading.get_ident()
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic on POSIX
            self._etags[key] = etag
            self.metrics.bytes_written += len(data)
            self.metrics.put_ops += 1
        return ObjectStat(key=key, size=len(data), etag=etag)

    def delete(self, key: str) -> None:
        path = self._path(key)
        with self._lock:
            try:
                os.remove(path)
            except FileNotFoundError:
                raise NoSuchKey(key) from None
            self._etags.pop(key, None)

    # -- reads -------------------------------------------------------------
    def exists(self, key: str) -> bool:
        return os.path.isfile(self._path(key))

    def stat(self, key: str) -> ObjectStat:
        path = self._path(key)
        try:
            size = os.path.getsize(path)
        except OSError:
            raise NoSuchKey(key) from None
        return ObjectStat(key=key, size=size, etag=self._etags.get(key, ""))

    def get(self, key: str) -> bytes:
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise NoSuchKey(key) from None
        with self._lock:
            self.metrics.bytes_read += len(data)
            self.metrics.get_ops += 1
            self.metrics.per_key_reads[key] = self.metrics.per_key_reads.get(key, 0) + len(data)
        return data

    def get_range(self, key: str, offset: int, length: int) -> bytes:
        """Byte-range get — the Puffin footer/blob access path."""
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                data = f.read(length)
        except FileNotFoundError:
            raise NoSuchKey(key) from None
        with self._lock:
            self.metrics.bytes_read += len(data)
            self.metrics.get_ops += 1
            self.metrics.range_gets += 1
            self.metrics.per_key_reads[key] = self.metrics.per_key_reads.get(key, 0) + len(data)
        return data

    def range_reader(self, key: str):
        """Callable suitable for :class:`repro_torch.iceberg.puffin.PuffinReader`."""
        return lambda off, ln: self.get_range(key, off, ln)

    # -- listing -----------------------------------------------------------
    def list(self, prefix: str = "") -> List[str]:
        prefix = prefix.lstrip("/")
        out: List[str] = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for name in filenames:
                if name.endswith(".tmp") or ".tmp." in name:
                    continue
                full = os.path.join(dirpath, name)
                key = os.path.relpath(full, self.root).replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def iter_stats(self, prefix: str = "") -> Iterator[ObjectStat]:
        for key in self.list(prefix):
            yield self.stat(key)
