"""The reference's ``tests/test_vparquet.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU.

vparquet columnar format: projection, row-group masks, range reads.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from _torch_cpu import tmp_store  # noqa: E402,F401
from repro_torch.lakehouse.vparquet import ColumnSpec, VParquetReader, VParquetWriter, read_vector_column, write_vector_file  # noqa: E402


def test_roundtrip_with_projection(tmp_store, rng):
    vecs = rng.normal(size=(1000, 16)).astype(np.float32)
    write_vector_file(tmp_store, "d/f.vpq", vecs, rows_per_group=128)
    r = VParquetReader.from_store(tmp_store, "d/f.vpq")
    assert r.num_rows == 1000
    assert r.num_row_groups == 8
    np.testing.assert_allclose(r.read_column("vec"), vecs)
    ids = r.read_column("id")
    np.testing.assert_array_equal(ids, np.arange(1000))


def test_row_group_mask_reads_only_target_bytes(tmp_store, rng):
    vecs = rng.normal(size=(4096, 32)).astype(np.float32)
    write_vector_file(tmp_store, "d/g.vpq", vecs, rows_per_group=512)
    tmp_store.metrics.reset()
    r = VParquetReader.from_store(tmp_store, "d/g.vpq")
    sub = r.read_column("vec", [3])
    np.testing.assert_allclose(sub, vecs[3 * 512 : 4 * 512])
    # bytes read ≈ one row group + footer, far less than the file
    assert tmp_store.metrics.bytes_read < vecs.nbytes / 4


def test_read_rows(tmp_store, rng):
    vecs = rng.normal(size=(300, 8)).astype(np.float32)
    write_vector_file(tmp_store, "d/h.vpq", vecs, rows_per_group=100)
    r = VParquetReader.from_store(tmp_store, "d/h.vpq")
    got = r.read_rows("vec", 2, [5, 50, 99])
    np.testing.assert_allclose(got, vecs[[205, 250, 299]])


def test_zstd_codec(tmp_store):
    pytest.importorskip("zstandard")
    vecs = np.zeros((5000, 64), np.float32)  # compressible
    n_plain = write_vector_file(tmp_store, "p.vpq", vecs)
    n_zstd = write_vector_file(tmp_store, "z.vpq", vecs, codec="zstd")
    assert n_zstd < n_plain / 10
    np.testing.assert_allclose(read_vector_column(tmp_store, "z.vpq"), vecs)


@settings(max_examples=20, deadline=None)
@given(
    n=st.integers(1, 500),
    d=st.integers(1, 32),
    rows_per_group=st.integers(1, 200),
)
def test_property_roundtrip(n, d, rows_per_group):
    rng = np.random.default_rng(n * 31 + d)
    vecs = rng.normal(size=(n, d)).astype(np.float32)
    w = VParquetWriter([ColumnSpec("vec", "float32", d)])
    for s in range(0, n, rows_per_group):
        w.write_row_group({"vec": vecs[s : s + rows_per_group]})
    data = w.finish()
    r = VParquetReader.from_bytes(data)
    assert r.num_rows == n
    np.testing.assert_allclose(r.read_column("vec"), vecs)
    # per-group reads concatenate to the whole
    parts = [r.read_column("vec", [g]) for g in range(r.num_row_groups)]
    np.testing.assert_allclose(np.concatenate(parts), vecs)


def test_attribute_columns_and_dictionary_encoding(tmp_store, rng):
    """String attribute columns dictionary-encode per file: stored ints are
    codes into the footer's value table; numeric attributes store raw."""
    vecs = rng.normal(size=(200, 8)).astype(np.float32)
    cat = np.asarray(["news", "games", "books", "games"] * 50)
    price = rng.integers(0, 100, size=200).astype(np.int64)
    write_vector_file(
        tmp_store, "a.vpq", vecs, rows_per_group=64,
        extra_columns={"category": cat, "price": price},
    )
    r = VParquetReader.from_store(tmp_store, "a.vpq")
    spec = r.columns["category"]
    assert spec.dtype == "int32"
    assert spec.dictionary == ["books", "games", "news"]  # sorted uniques
    codes = r.read_column("category")
    decoded = np.asarray(spec.dictionary, dtype=object)[codes]
    np.testing.assert_array_equal(decoded.astype(str), cat)
    assert r.columns["price"].dictionary is None
    np.testing.assert_array_equal(r.read_column("price"), price)
    # row-group projection of attribute columns works like any column
    np.testing.assert_array_equal(r.read_column("price", [1]), price[64:128])


def test_table_append_scan_attributes(tmp_store, rng):
    from repro_torch.iceberg.catalog import RestCatalog
    from repro_torch.lakehouse.table import LakehouseTable

    cat = RestCatalog(tmp_store)
    t = LakehouseTable(cat, "t")
    t.create(dim=8)
    vecs = rng.normal(size=(120, 8)).astype(np.float32)
    tags = np.asarray([f"t{i % 5}" for i in range(120)])
    price = rng.integers(0, 10, size=120).astype(np.int64)
    t.append_vectors(vecs, num_files=3, rows_per_group=32,
                     attributes={"tag": tags, "price": price})
    attrs = t.scan_attributes()
    _, locs = t.scan_vectors()
    assert len(attrs["tag"]) == len(locs) == 120
    # row alignment with scan_vectors: files are written by index split
    np.testing.assert_array_equal(attrs["price"], price)
    np.testing.assert_array_equal(attrs["tag"].astype(str), tags)
    assert set(t.attribute_schema()) == {"tag", "price"}
    with pytest.raises(ValueError):
        t.append_vectors(vecs, attributes={"short": price[:5]})
