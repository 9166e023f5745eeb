"""Puffin sidecar container — spec-faithful binary layout (paper §2.1, §4).

File structure (Apache Iceberg Puffin spec, mirrored by the paper):

    Magic (4 bytes, ``PFA1``)
    Blob 1 payload (opaque bytes, independently compressed)
    ...
    Blob N payload
    Magic (4 bytes)           --+
    Footer payload (UTF-8 JSON, | footer
      optionally compressed)    |
    Footer payload size (i32 LE)|
    Flags (4 bytes)             |
    Magic (4 bytes)           --+

The footer JSON carries one entry per blob: ``type`` (opaque string),
``fields`` (Iceberg field IDs), ``offset``/``length``, ``compression-codec``
and a free-form ``properties`` map.  Unknown blob types are ignored by
readers — the extension point the paper builds on.

Random access contract (paper §4.2): a reader fetches the tail of the file
(footer) with one byte-range request, parses blob offsets, then range-reads
only the blobs it needs.  :class:`PuffinReader` preserves this contract by
operating over an abstract ``range_reader`` callable so the same code path
serves local files and the object store.
"""

from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

try:  # zstd is the codec the paper uses; fall back to zlib if unavailable.
    import zstandard as _zstd

    _HAVE_ZSTD = True
except Exception:  # pragma: no cover - environment dependent
    _zstd = None
    _HAVE_ZSTD = False

MAGIC = b"PFA1"
_FOOTER_TAIL = 4 + 4 + 4  # payload size + flags + trailing magic

# Footer flag bit 0 of byte 0: footer payload is compressed (spec).
FLAG_FOOTER_COMPRESSED = 0x01


class PuffinError(ValueError):
    """Malformed Puffin file."""


def preferred_codec() -> str:
    """Best codec available in this environment: zstd (the paper's choice)
    when the ``zstandard`` package is importable, else zlib.  Writers that
    don't care about a specific codec should use this so the blob footer
    records whatever was actually applied."""
    return "zstd" if _HAVE_ZSTD else "zlib"


def _compress(codec: Optional[str], data: bytes) -> bytes:
    if codec is None or codec == "none":
        return data
    if codec == "zstd":
        if not _HAVE_ZSTD:
            raise PuffinError("zstd codec requested but zstandard not available")
        return _zstd.ZstdCompressor(level=3).compress(data)
    if codec == "zlib":
        return zlib.compress(data, 6)
    raise PuffinError(f"unknown compression codec: {codec}")


def _decompress(codec: Optional[str], data: bytes) -> bytes:
    if codec is None or codec == "none":
        return data
    if codec == "zstd":
        if not _HAVE_ZSTD:
            raise PuffinError("zstd codec required but zstandard not available")
        return _zstd.ZstdDecompressor().decompress(data)
    if codec == "zlib":
        return zlib.decompress(data)
    raise PuffinError(f"unknown compression codec: {codec}")


@dataclass
class BlobMetadata:
    """One footer entry.  Field names follow the Puffin spec JSON keys."""

    type: str
    offset: int
    length: int  # stored (possibly compressed) length
    fields: List[int] = field(default_factory=list)
    snapshot_id: int = -1
    sequence_number: int = -1
    compression_codec: Optional[str] = None
    properties: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> dict:
        out = {
            "type": self.type,
            "fields": list(self.fields),
            "snapshot-id": self.snapshot_id,
            "sequence-number": self.sequence_number,
            "offset": self.offset,
            "length": self.length,
            "properties": dict(self.properties),
        }
        if self.compression_codec:
            out["compression-codec"] = self.compression_codec
        return out

    @staticmethod
    def from_json(obj: dict) -> "BlobMetadata":
        return BlobMetadata(
            type=obj["type"],
            offset=int(obj["offset"]),
            length=int(obj["length"]),
            fields=[int(f) for f in obj.get("fields", [])],
            snapshot_id=int(obj.get("snapshot-id", -1)),
            sequence_number=int(obj.get("sequence-number", -1)),
            compression_codec=obj.get("compression-codec"),
            properties=dict(obj.get("properties", {})),
        )


class PuffinWriter:
    """Streaming writer mirroring the reader's layout (paper §5: ~200 lines).

    Usage::

        w = PuffinWriter(file_properties={"created-by": "repro"})
        w.add_blob(b"...", type="flockdb-ann-routing-v1", properties={...})
        w.add_blob(b"...", type="flockdb-ann-index-v1", compression="zstd")
        payload = w.finish()           # full file bytes
    """

    def __init__(
        self,
        file_properties: Optional[Dict[str, str]] = None,
        compress_footer: bool = False,
    ) -> None:
        self._chunks: List[bytes] = [MAGIC]
        self._offset = len(MAGIC)
        self._blobs: List[BlobMetadata] = []
        self._properties = dict(file_properties or {})
        self._compress_footer = compress_footer
        self._finished = False

    @property
    def blobs(self) -> Sequence[BlobMetadata]:
        return tuple(self._blobs)

    def add_blob(
        self,
        payload: bytes,
        *,
        type: str,
        fields: Sequence[int] = (),
        snapshot_id: int = -1,
        sequence_number: int = -1,
        compression: Optional[str] = None,
        properties: Optional[Dict[str, str]] = None,
        precompressed: bool = False,
    ) -> BlobMetadata:
        """``precompressed=True`` marks ``payload`` as already stored-form
        (used when re-assembling a Puffin from another file's raw blob
        ranges during incremental refresh — unchanged shards are byte-copied,
        never re-encoded)."""
        if self._finished:
            raise PuffinError("writer already finished")
        stored = payload if precompressed else _compress(compression, payload)
        meta = BlobMetadata(
            type=type,
            offset=self._offset,
            length=len(stored),
            fields=list(fields),
            snapshot_id=snapshot_id,
            sequence_number=sequence_number,
            compression_codec=compression if compression not in (None, "none") else None,
            properties=dict(properties or {}),
        )
        self._chunks.append(stored)
        self._offset += len(stored)
        self._blobs.append(meta)
        return meta

    def finish(self) -> bytes:
        if self._finished:
            raise PuffinError("writer already finished")
        self._finished = True
        footer_json = json.dumps(
            {
                "blobs": [b.to_json() for b in self._blobs],
                "properties": self._properties,
            },
            separators=(",", ":"),
        ).encode("utf-8")
        flags = bytearray(4)
        if self._compress_footer:
            # Spec: footer compression is zstd-only (lz4 reserved).
            footer_payload = _compress("zstd" if _HAVE_ZSTD else "zlib", footer_json)
            flags[0] |= FLAG_FOOTER_COMPRESSED
        else:
            footer_payload = footer_json
        tail = b"".join(
            [
                MAGIC,
                footer_payload,
                struct.pack("<i", len(footer_payload)),
                bytes(flags),
                MAGIC,
            ]
        )
        self._chunks.append(tail)
        return b"".join(self._chunks)


def read_footer(
    size: int, range_reader: Callable[[int, int], bytes]
) -> tuple[List[BlobMetadata], Dict[str, str]]:
    """Parse the footer using byte-range reads only.

    ``range_reader(offset, length)`` returns bytes.  Two reads are issued:
    one for the fixed tail (to learn the footer payload size), one for the
    payload itself — matching the paper's "HTTP range request for just the
    footer" access pattern.
    """
    if size < len(MAGIC) + _FOOTER_TAIL + len(MAGIC):
        raise PuffinError("file too small to be a Puffin file")
    tail = range_reader(size - _FOOTER_TAIL, _FOOTER_TAIL)
    payload_size = struct.unpack("<i", tail[0:4])[0]
    flags = tail[4:8]
    if tail[8:12] != MAGIC:
        raise PuffinError("bad trailing magic")
    if payload_size < 0:
        raise PuffinError("negative footer payload size")
    footer_start = size - _FOOTER_TAIL - payload_size - len(MAGIC)
    if footer_start < len(MAGIC):
        raise PuffinError("footer overlaps header")
    blob = range_reader(footer_start, len(MAGIC) + payload_size)
    if blob[:4] != MAGIC:
        raise PuffinError("bad footer magic")
    payload = blob[4:]
    if flags[0] & FLAG_FOOTER_COMPRESSED:
        try:
            payload = _decompress("zstd", payload)
        except Exception:
            payload = _decompress("zlib", payload)
    obj = json.loads(payload.decode("utf-8"))
    blobs = [BlobMetadata.from_json(b) for b in obj.get("blobs", [])]
    return blobs, dict(obj.get("properties", {}))


class PuffinReader:
    """Random-access reader over an abstract range-read callable."""

    def __init__(self, size: int, range_reader: Callable[[int, int], bytes]) -> None:
        self._size = size
        self._read = range_reader
        header = range_reader(0, 4)
        if header != MAGIC:
            raise PuffinError("bad header magic")
        self.blobs, self.properties = read_footer(size, range_reader)

    @classmethod
    def from_bytes(cls, data: bytes) -> "PuffinReader":
        return cls(len(data), lambda off, ln: data[off : off + ln])

    def blobs_of_type(self, blob_type: str) -> List[BlobMetadata]:
        return [b for b in self.blobs if b.type == blob_type]

    def read_blob(self, meta: BlobMetadata) -> bytes:
        stored = self._read(meta.offset, meta.length)
        if len(stored) != meta.length:
            raise PuffinError(
                f"short read: wanted {meta.length} bytes at {meta.offset}, got {len(stored)}"
            )
        return _decompress(meta.compression_codec, stored)

    def read_first(self, blob_type: str) -> bytes:
        metas = self.blobs_of_type(blob_type)
        if not metas:
            raise PuffinError(f"no blob of type {blob_type!r}")
        return self.read_blob(metas[0])
