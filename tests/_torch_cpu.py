"""The port's entry points pinned to the CPU, and the port's twins of
conftest's fixtures, for the reference's test modules run against the port
(``tests/test_torch_<module>.py``).

Every port entry point runs on the card unless it is given
``device="cpu"``; the names below are the port's own with that argument
bound, so a ported test body reads as the reference's.  A module that
imports a fixture from here uses it in place of conftest's fixture of the
same name.
"""

from functools import partial

import numpy as np
import pytest

from conftest import BUILT_CFG, clustered_vectors
from repro_torch.core import blobs as _blobs
from repro_torch.core import kmeans as _kmeans
from repro_torch.core import pq as _pq
from repro_torch.core import vamana as _vamana
from repro_torch.runtime import cluster as _cluster

CPU = "cpu"

make_local_cluster = partial(_cluster.make_local_cluster, device=CPU)
build_vamana = partial(_vamana.build_vamana, device=CPU)
brute_force_topk = partial(_vamana.brute_force_topk, device=CPU)
train_kmeans = partial(_kmeans.train_kmeans, device=CPU)
assign = partial(_kmeans.assign, device=CPU)
train_pq = partial(_pq.train_pq, device=CPU)
encode = partial(_pq.encode, device=CPU)
adc_scores = partial(_pq.adc_scores, device=CPU)
reconstruction_error = partial(_pq.reconstruction_error, device=CPU)
decode_shard_blob = partial(_blobs.decode_shard_blob, device=CPU)


@pytest.fixture(scope="module")
def built_cluster(tmp_path_factory):
    """conftest's ``built_cluster`` (table "emb", index "idx"), built by the
    port on the CPU, once per module that imports it (the reference's is
    shared by the whole run)."""
    from repro_torch.lakehouse.table import LakehouseTable
    from repro_torch.runtime.coordinator import IndexConfig

    rng = np.random.default_rng(0)
    c = make_local_cluster(str(tmp_path_factory.mktemp("cluster")), num_executors=3)
    t = LakehouseTable(c.catalog, "emb")
    t.create(dim=32)
    X, centers = clustered_vectors(rng, n_clusters=24, per_cluster=80, dim=32)
    t.append_vectors(X, num_files=9, rows_per_group=128)
    rep = c.coordinator.create_index("emb", IndexConfig(name="idx", **BUILT_CFG))
    return c, t, X, centers, rep


@pytest.fixture()
def tmp_store(tmp_path):
    from repro_torch.lakehouse.objectstore import ObjectStore

    return ObjectStore(str(tmp_path / "s3"))
