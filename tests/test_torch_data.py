"""The reference's ``tests/test_data.py`` run against the port, and the two
packages' token pipelines held to each other.

The first five cases are the reference's, with their assertions, on
``repro_torch.data``.  Then parity: ``SyntheticTokens.batch(step)`` gives
the reference's arrays over seeds, steps, hosts and codebooks, and a token
table written by either package is read by the other into the same
batches (the vparquet bytes are the same, and both readers walk them
alike).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import tmp_store  # noqa: E402,F401
from repro.data import pipeline as RP  # noqa: E402
from repro.lakehouse.objectstore import ObjectStore as RefObjectStore  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens, TokenTableReader, write_token_table  # noqa: E402
from repro_torch.lakehouse.objectstore import ObjectStore  # noqa: E402


def test_synthetic_deterministic_across_restarts():
    a = SyntheticTokens(vocab_size=1000, seq_len=16, batch_size=4, seed=1)
    b = SyntheticTokens(vocab_size=1000, seq_len=16, batch_size=4, seed=1)
    ids1, lab1 = a.batch(7)
    ids2, lab2 = b.batch(7)
    np.testing.assert_array_equal(ids1, ids2)
    np.testing.assert_array_equal(ids1[:, 1:], lab1[:, :-1])  # next-token shift


def test_synthetic_host_sharding_disjoint():
    h0 = SyntheticTokens(vocab_size=1000, seq_len=8, batch_size=2, seed=1, host_id=0, num_hosts=2)
    h1 = SyntheticTokens(vocab_size=1000, seq_len=8, batch_size=2, seed=1, host_id=1, num_hosts=2)
    ids0, _ = h0.batch(0)
    ids1, _ = h1.batch(0)
    assert not np.array_equal(ids0, ids1)


def test_synthetic_vocab_bound():
    d = SyntheticTokens(vocab_size=64, seq_len=32, batch_size=8, seed=2)
    ids, labels = d.batch(0)
    assert ids.min() >= 0 and ids.max() < 64


def test_codebook_stream_shape():
    d = SyntheticTokens(vocab_size=100, seq_len=8, batch_size=2, num_codebooks=4, seed=0)
    ids, labels = d.batch(0)
    assert ids.shape == (2, 8, 4) and labels.shape == (2, 8, 4)


def test_token_table_roundtrip(tmp_store):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 5000, size=10_000).astype(np.int32)
    write_token_table(tmp_store, "tok/a.vpq", tokens, rows_per_group=2048)
    reader = TokenTableReader(tmp_store, ["tok/a.vpq"], seq_len=16, batch_size=4)
    batches = list(reader)
    assert len(batches) == 10_000 // (4 * 17)
    ids, labels = batches[0]
    np.testing.assert_array_equal(ids[:, 1:], labels[:, :-1])  # per-row shift
    flat = np.c_[ids, labels[:, -1:]].reshape(-1)
    np.testing.assert_array_equal(flat, tokens[: 4 * 17])


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("host_id,num_hosts", [(0, 1), (0, 2), (1, 2), (3, 4)])
@pytest.mark.parametrize("num_codebooks", [0, 4])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batches_match_reference(seed, num_codebooks, host_id, num_hosts):
    kw = dict(vocab_size=151_936, seq_len=24, batch_size=3, num_codebooks=num_codebooks, seed=seed,
              host_id=host_id, num_hosts=num_hosts)
    ours, ref = SyntheticTokens(**kw), RP.SyntheticTokens(**kw)
    for step in (0, 1, 9):
        for got, want in zip(ours.batch(step), ref.batch(step)):
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    # the iterator is batch(0), batch(1), ...
    for step, (got, want) in enumerate(zip(iter(ours), iter(ref))):
        np.testing.assert_array_equal(got[0], want[0])
        if step == 2:
            break


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_token_tables_cross_read(tmp_path, writer):
    """A table of two files written by one package, read by both with two
    hosts: the same bytes, the same batches, host by host."""
    rng = np.random.default_rng(3)
    store, ref_store = ObjectStore(str(tmp_path / "s3")), RefObjectStore(str(tmp_path / "s3"))
    write = write_token_table if writer == "port" else RP.write_token_table
    keys = ["tok/a.vpq", "tok/b.vpq"]
    for key in keys:
        tokens = rng.integers(0, 32_000, size=7_000).astype(np.int32)
        n = write(store if writer == "port" else ref_store, key, tokens, rows_per_group=1024)
        assert n == len(store.get(key))
    for host in (0, 1):
        kw = dict(keys=keys, seq_len=31, batch_size=2, host_id=host, num_hosts=2)
        got = list(TokenTableReader(store, **kw))
        want = list(RP.TokenTableReader(ref_store, **kw))
        assert len(got) == len(want) == 7_000 // 64
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


def test_token_table_bytes_match_reference(tmp_path):
    tokens = np.arange(5_000, dtype=np.int32) * 7 % 1_000
    store = ObjectStore(str(tmp_path / "s3"))
    write_token_table(store, "p.vpq", tokens, rows_per_group=512)
    RP.write_token_table(RefObjectStore(str(tmp_path / "s3")), "r.vpq", tokens, rows_per_group=512)
    assert store.get("p.vpq") == store.get("r.vpq")
