"""The reference's ``tests/test_puffin.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU.

Puffin container: spec conformance, roundtrips, range-read access.
"""

import struct

import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.iceberg.puffin import MAGIC, PuffinError, PuffinReader, PuffinWriter, preferred_codec  # noqa: E402

_zstd_only = pytest.mark.skipif(
    preferred_codec() != "zstd", reason="zstandard not installed"
)


def _file(blobs, **kw):
    w = PuffinWriter(**kw)
    metas = [w.add_blob(payload, **meta) for payload, meta in blobs]
    return w.finish(), metas


def test_layout_magic_and_footer():
    data, _ = _file([(b"hello", dict(type="t1"))])
    assert data[:4] == MAGIC
    assert data[-4:] == MAGIC
    # footer payload length field
    (ln,) = struct.unpack("<i", data[-12:-8])
    assert 0 < ln < len(data)


def test_roundtrip_multiple_blobs():
    data, _ = _file(
        [
            (b"a" * 1000, dict(type="flockdb-ann-routing-v1", properties={"x": "1"})),
            (b"b" * 5000, dict(type="flockdb-ann-index-v1", snapshot_id=42)),
            (b"c" * 10, dict(type="unknown-type")),
        ]
    )
    r = PuffinReader.from_bytes(data)
    assert [b.type for b in r.blobs] == [
        "flockdb-ann-routing-v1",
        "flockdb-ann-index-v1",
        "unknown-type",
    ]
    assert r.read_blob(r.blobs[0]) == b"a" * 1000
    assert r.read_blob(r.blobs[1]) == b"b" * 5000
    assert r.blobs[1].snapshot_id == 42
    assert r.blobs[0].properties == {"x": "1"}


@pytest.mark.parametrize("codec", [None, pytest.param("zstd", marks=_zstd_only), "zlib"])
def test_compression_codecs(codec):
    payload = b"z" * 100_000
    data, metas = _file([(payload, dict(type="t", compression=codec))])
    if codec:
        assert metas[0].length < len(payload)
    r = PuffinReader.from_bytes(data)
    assert r.read_first("t") == payload


def test_range_read_access_pattern():
    """Reader must touch only the footer + requested blob ranges."""
    data, _ = _file(
        [(b"x" * 100_000, dict(type="big")), (b"y" * 10, dict(type="small"))]
    )
    reads = []

    def tracked(off, ln):
        reads.append((off, ln))
        return data[off : off + ln]

    r = PuffinReader(len(data), tracked)
    footer_bytes = sum(ln for _, ln in reads)
    assert footer_bytes < 1000  # header magic + footer only
    r.read_first("small")
    assert reads[-1][1] == 10  # exactly the small blob's stored length


def test_unknown_blob_types_ignored():
    data, _ = _file([(b"q", dict(type="future-type-v9"))])
    r = PuffinReader.from_bytes(data)
    assert r.blobs_of_type("flockdb-ann-index-v1") == []


def test_corrupt_magic_rejected():
    data, _ = _file([(b"p", dict(type="t"))])
    with pytest.raises(PuffinError):
        PuffinReader.from_bytes(b"XXXX" + data[4:])
    with pytest.raises(PuffinError):
        PuffinReader.from_bytes(data[:-4] + b"XXXX")


def test_compressed_footer():
    data, _ = _file([(b"p" * 100, dict(type="t"))], compress_footer=True)
    r = PuffinReader.from_bytes(data)
    assert r.read_first("t") == b"p" * 100


def test_precompressed_blob_passthrough():
    zstandard = pytest.importorskip("zstandard")

    payload = b"w" * 50_000
    stored = zstandard.ZstdCompressor().compress(payload)
    w = PuffinWriter()
    w.add_blob(stored, type="t", compression="zstd", precompressed=True)
    data = w.finish()
    r = PuffinReader.from_bytes(data)
    assert r.read_first("t") == payload


@settings(max_examples=25, deadline=None)
@given(
    payloads=st.lists(st.binary(min_size=0, max_size=2048), min_size=1, max_size=6),
    codec=st.sampled_from([None, preferred_codec()]),
)
def test_property_roundtrip(payloads, codec):
    w = PuffinWriter()
    for i, p in enumerate(payloads):
        w.add_blob(p, type=f"t{i}", compression=codec, properties={"i": str(i)})
    data = w.finish()
    r = PuffinReader.from_bytes(data)
    assert len(r.blobs) == len(payloads)
    for i, p in enumerate(payloads):
        assert r.read_first(f"t{i}") == p


def _tiny_shard():
    import numpy as np
    from repro_torch.core.blobs import ShardLocationMap
    from repro_torch.core.vamana import VamanaParams
    from _torch_cpu import build_vamana

    rng = np.random.default_rng(0)
    vecs = rng.normal(size=(48, 8)).astype(np.float32)
    graph = build_vamana(vecs, VamanaParams(R=8, L=16, alpha=1.2, metric="l2"),
                         passes=1, batch=48)
    n = graph.n
    locmap = ShardLocationMap(
        ["f0"],
        np.zeros(n, np.uint32),
        np.zeros(n, np.uint32),
        np.arange(n, dtype=np.uint32),
    )
    return graph, locmap


@pytest.mark.parametrize("force_zlib", [False, True],
                         ids=["env-codec", "zlib-fallback"])
def test_shard_blob_codec_roundtrip(monkeypatch, force_zlib):
    """DANN shard blobs roundtrip under the environment codec (zstd when
    available) AND under the zlib fallback path the module falls back to
    when zstandard is absent."""
    import zlib

    import numpy as np
    from repro_torch.core import blobs as B

    if force_zlib:
        monkeypatch.setattr(B, "_c", lambda b: zlib.compress(b, 6))
        monkeypatch.setattr(B, "_d", zlib.decompress)
    graph, locmap = _tiny_shard()
    blob = B.encode_shard_blob(graph, locmap, include_vectors=True)
    g2, lm2 = B.decode_shard_blob(blob, device="cpu")
    assert g2.n == graph.n and g2.medoid == graph.medoid
    np.testing.assert_allclose(g2.vectors[: graph.n], graph.vectors[: graph.n])
    np.testing.assert_array_equal(g2.adjacency[: graph.n], graph.adjacency[: graph.n])
    assert lm2.file_paths == locmap.file_paths
    np.testing.assert_array_equal(lm2.row_offset, locmap.row_offset)


@pytest.mark.parametrize("force_zlib", [False, True],
                         ids=["env-codec", "zlib-fallback"])
def test_zonemap_blob_codec_roundtrip(monkeypatch, force_zlib):
    import zlib

    from repro_torch.core import blobs as B
    from repro_torch.runtime.predicates import ZoneStats

    if force_zlib:
        monkeypatch.setattr(B, "_c", lambda b: zlib.compress(b, 6))
        monkeypatch.setattr(B, "_d", zlib.decompress)
    zm = B.AttrZoneMap(
        columns={"price": "int", "category": "dict"},
        zones={
            "f0": [
                {"price": ZoneStats(count=10, min=1, max=9),
                 "category": ZoneStats(count=10, values={"a": 4, "b": 6})},
                {"price": ZoneStats(count=5, min=50, max=99),
                 "category": ZoneStats(count=5, values={"c": 5})},
            ]
        },
        shard_membership={0: [("f0", 0)], 1: [("f0", 0), ("f0", 1)]},
    )
    zm2 = B.decode_zonemap_blob(B.encode_zonemap_blob(zm))
    assert zm2.columns == zm.columns
    assert zm2.shard_membership == zm.shard_membership
    assert zm2.zones["f0"][0]["category"].values == {"a": 4, "b": 6}
    assert zm2.zones["f0"][1]["price"].min == 50
    assert zm2.shard_zones(1) == zm.zones["f0"]
    assert zm2.shard_zones(9) is None
