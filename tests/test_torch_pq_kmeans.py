"""The reference's ``tests/test_pq_kmeans.py`` run against the port: the same cases and
assertions, on data the port builds on the CPU.

k-means + product quantization: convergence, codec quality, ADC.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import assign, train_kmeans  # noqa: E402
from repro_torch.core.pq import PQCodebook, decode  # noqa: E402
from _torch_cpu import adc_scores, encode, reconstruction_error, train_pq  # noqa: E402
from conftest import clustered_vectors  # noqa: E402


def test_kmeans_recovers_clusters(rng):
    X, centers = clustered_vectors(rng, n_clusters=8, per_cluster=200, dim=16, scale=8.0)
    cents, inertia = train_kmeans(X, 8, iters=25, seed=0)
    # every true center has a learned centroid nearby
    d = np.sqrt(((centers[:, None, :] - cents[None]) ** 2).sum(-1)).min(axis=1)
    assert (d < 2.0).all(), d


def test_kmeans_inertia_decreases(rng):
    X, _ = clustered_vectors(rng, n_clusters=5, per_cluster=100, dim=8)
    _, i1 = train_kmeans(X, 5, iters=2, seed=0)
    _, i2 = train_kmeans(X, 5, iters=20, seed=0)
    assert i2 <= i1 * 1.001


def test_kmeans_no_empty_clusters(rng):
    X = rng.normal(size=(500, 4)).astype(np.float32)
    cents, _ = train_kmeans(X, 64, iters=10, seed=1)
    counts = np.bincount(assign(X, cents), minlength=64)
    assert (counts > 0).all()


def test_pq_roundtrip_shapes(rng):
    X = rng.normal(size=(2000, 64)).astype(np.float32)
    pq = train_pq(X, m=8, nbits=6, iters=5)
    codes = encode(pq, X)
    assert codes.shape == (2000, 8) and codes.dtype == np.uint8
    assert codes.max() < 64
    approx = decode(pq, codes)
    assert approx.shape == X.shape


def test_pq_error_improves_with_bits(rng):
    X, _ = clustered_vectors(rng, n_clusters=8, per_cluster=250, dim=32)
    e_small = reconstruction_error(train_pq(X, m=4, nbits=4, iters=6), X)
    e_big = reconstruction_error(train_pq(X, m=16, nbits=8, iters=6), X)
    assert e_big < e_small * 0.5


def test_adc_approximates_exact(rng):
    X, _ = clustered_vectors(rng, n_clusters=8, per_cluster=125, dim=32)
    pq = train_pq(X, m=16, nbits=8, iters=6)
    codes = encode(pq, X)
    Q = X[:8]
    s = np.asarray(adc_scores(pq, Q, codes, backend="ref"))
    exact = ((Q[:, None, :] - X[None]) ** 2).sum(-1)
    for qi in range(8):
        corr = np.corrcoef(s[qi], exact[qi])[0, 1]
        assert corr > 0.95
    # ADC of a vector against its own code ≈ its reconstruction error
    own = s[np.arange(8), np.arange(8)]
    recon = ((decode(pq, codes[:8]) - Q) ** 2).sum(-1)
    np.testing.assert_allclose(own, recon, rtol=1e-3, atol=1e-3)


def test_codebook_serialization(rng):
    X = rng.normal(size=(1000, 32)).astype(np.float32)
    pq = train_pq(X, m=8, nbits=5, iters=4)
    blob = pq.tobytes()
    pq2 = PQCodebook.frombytes(blob, pq.m, pq.K, pq.dsub, pq.metric)
    np.testing.assert_allclose(pq.codebook, pq2.codebook)
    np.testing.assert_array_equal(encode(pq, X[:50]), encode(pq2, X[:50]))


def test_paper_pq_memory_claim():
    """Paper §9.2: 2.5e8 vectors × m=48 = 12 GB of PQ codes per shard."""
    n, m = 2.5e8, 48
    assert abs(n * m / 1e9 - 12.0) < 0.1
