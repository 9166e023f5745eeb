"""Hand-written Hopper kernels for the unfiltered DiskANN path.

Three kernels, each with a plain PyTorch version in :mod:`repro_torch.kernels.ref`
and a dispatching public wrapper in :mod:`repro_torch.kernels.ops`:

- ``rerank_distances`` — dense exact-distance matrix (Stage-B rerank,
  ground truth), ``csrc/rerank.cu``
- ``gather_rerank``    — exact rerank of each query's candidate pool
  (Stage-A ``search_pq``), ``csrc/rerank.cu``
- ``kmeans_assign``    — nearest-centroid assignment (Stage-0 k-means, PQ
  encoding, shard ownership), ``csrc/kmeans_assign.cu``

The CUDA sources build on first use (:mod:`repro_torch.kernels._build`);
importing this package builds nothing.
"""

from repro_torch.kernels.ops import (  # noqa: F401
    exact_distances,
    exact_topk,
    gather_rerank,
    kmeans_assign,
)
