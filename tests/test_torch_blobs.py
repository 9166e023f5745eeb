"""Puffin shard blobs cross between the two packages (the paper's claim that
any engine reads the index).

A ``flockdb-ann-index-v1`` blob written by ``repro`` decodes in
``repro_torch`` to equal arrays and the other way round, and the port's
vectorized varint encoder writes the reference's bytes exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import clustered_vectors  # noqa: E402
from repro.core import blobs as jblobs  # noqa: E402
from repro.core import vamana as jv  # noqa: E402
from repro_torch.core import blobs as tblobs  # noqa: E402
from repro_torch.core import vamana as tv  # noqa: E402


@pytest.fixture(scope="module")
def graph_and_locmap():
    rng = np.random.default_rng(0)
    X, _ = clustered_vectors(rng, n_clusters=6, per_cluster=120, dim=16)
    g = jv.build_vamana(X, jv.VamanaParams(R=12, L=24), passes=1, batch=64, seed=2,
                        with_pq=True, pq_m=4)
    g.tombstone(np.array([3, 77, 400]))
    n = g.n
    # locations with large jumps, so deltas need multi-byte (and negative,
    # zig-zagged) varints
    locmap = jblobs.ShardLocationMap(
        [f"s3://bucket/data-{i:05d}.vpq" for i in range(5)],
        rng.integers(0, 5, size=n).astype(np.uint32),
        rng.integers(0, 300, size=n).astype(np.uint32),
        rng.integers(0, 1 << 20, size=n).astype(np.uint32),
    )
    return g, locmap


def _port_graph(g):
    return tv.graph_from_arrays(
        g.vectors, g.adjacency, g.n, g.medoid,
        tv.VamanaParams(R=g.params.R, L=g.params.L, alpha=g.params.alpha, metric=g.params.metric),
        pq_codebook=g.pq.codebook, pq_codes=g.pq_codes, tombstones=g.tombstones, device="cpu",
    )


def _port_locmap(lm):
    return tblobs.ShardLocationMap(list(lm.file_paths), lm.file_idx, lm.row_group, lm.row_offset)


def _assert_same_graph(a, b):
    assert (a.n, a.medoid, a.dim) == (b.n, b.medoid, b.dim)
    assert (a.params.R, a.params.L, a.params.metric) == (b.params.R, b.params.L, b.params.metric)
    assert abs(a.params.alpha - b.params.alpha) < 1e-6
    np.testing.assert_array_equal(a.adjacency, b.adjacency)
    np.testing.assert_array_equal(a.vectors, b.vectors)
    np.testing.assert_array_equal(a.tombstones, b.tombstones)
    np.testing.assert_array_equal(a.pq.codebook, b.pq.codebook)
    np.testing.assert_array_equal(a.pq_codes, b.pq_codes)


def _assert_same_locmap(a, b):
    assert list(a.file_paths) == list(b.file_paths)
    for f in ("file_idx", "row_group", "row_offset"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("include_vectors", [True, False])
def test_reference_blob_decodes_in_port(graph_and_locmap, include_vectors):
    g, lm = graph_and_locmap
    blob = jblobs.encode_shard_blob(g, lm, include_vectors=include_vectors)
    kw = {} if include_vectors else {"vectors_override": g.vectors[: g.n]}
    got, got_lm = tblobs.decode_shard_blob(blob, device="cpu", **kw)
    want, want_lm = jblobs.decode_shard_blob(blob, **kw)
    _assert_same_graph(got, want)
    _assert_same_locmap(got_lm, want_lm)
    assert got.device == torch.device("cpu")


def test_port_blob_decodes_in_reference(graph_and_locmap):
    g, lm = graph_and_locmap
    blob = tblobs.encode_shard_blob(_port_graph(g), _port_locmap(lm))
    got, got_lm = jblobs.decode_shard_blob(blob)
    _assert_same_graph(got, g)
    _assert_same_locmap(got_lm, lm)


@pytest.mark.parametrize("include_vectors", [True, False])
def test_port_encoder_writes_reference_bytes(graph_and_locmap, include_vectors):
    g, lm = graph_and_locmap
    want = jblobs.encode_shard_blob(g, lm, include_vectors=include_vectors)
    got = tblobs.encode_shard_blob(_port_graph(g), _port_locmap(lm), include_vectors=include_vectors)
    assert got == want


def test_adjacency_with_holes_round_trips_like_reference(graph_and_locmap):
    """Rows whose -1 slots are not a suffix still encode as the reference
    does (the encoder keeps the live ids in row order)."""
    g, lm = graph_and_locmap
    port = _port_graph(g)
    port.adjacency[5, 0] = -1
    port.adjacency[9, 2:5] = -1
    ref = jv.VamanaGraph(
        vectors=port.vectors, adjacency=port.adjacency.copy(), n=port.n, medoid=port.medoid,
        params=g.params, tombstones=port.tombstones, pq=g.pq, pq_codes=port.pq_codes,
    )
    assert tblobs.encode_shard_blob(port, _port_locmap(lm)) == jblobs.encode_shard_blob(ref, lm)


@pytest.mark.parametrize("values", [
    [0], [127, 128, 255, 16383, 16384], [2**32 - 1, 2**40 + 5, 2**63 + 9], list(range(300)),
])
def test_varint_codec_matches_reference(values):
    import io

    buf = io.BytesIO()
    for v in values:
        jblobs._write_varint(buf, v)
    data, lengths = tblobs._encode_varints(np.asarray(values, np.uint64))
    assert data == buf.getvalue()
    assert int(lengths.sum()) == len(data)
    decoded, _ = tblobs._decode_varints(data)
    assert decoded.tolist() == values


def test_graph_from_arrays_pads_to_capacity():
    vecs = np.arange(20, dtype=np.float32).reshape(10, 2)
    adj = np.tile(np.arange(3, dtype=np.int32), (10, 1))
    g = tv.graph_from_arrays(vecs, adj, 10, 0, tv.VamanaParams(R=4, L=8), device="cpu")
    assert g.vectors.shape == (1024, 2) and g.adjacency.shape == (1024, 4)
    assert (g.adjacency[:10, 3] == -1).all() and (g.adjacency[10:] == -1).all()
    np.testing.assert_array_equal(g.vectors[:10], vecs)
