"""Hand-written Hopper kernels.

Each kernel has a plain PyTorch version in :mod:`repro_torch.kernels.ref`
and a dispatching public wrapper in :mod:`repro_torch.kernels.ops`:

- ``rerank_distances`` — dense exact-distance matrix (Stage-B rerank,
  ground truth), ``csrc/rerank.cu``
- ``gather_rerank``    — exact rerank of each query's candidate pool
  (Stage-A ``search_pq``), ``csrc/rerank.cu``
- ``kmeans_assign``    — nearest-centroid assignment (Stage-0 k-means, PQ
  encoding, shard ownership), ``csrc/kmeans_assign.cu``
- ``masked_exact_topk`` / ``masked_pq_topk`` / ``unified_masked_topk`` —
  masked exact, PQ-ADC and mixed-flavor top-k (filtered Stage A, the fresh
  tail), ``csrc/masked_topk.cu``; the exact scan also in bf16 and int8
  (the quantized ExactScan ahead of the full-precision guard)
- ``pq_scan``          — dense PQ-ADC score matrix (``core/pq.adc_scores``),
  ``csrc/pq_scan.cu``; ``ops.pq_scan`` / ``ops.pq_scan_topk`` (not
  re-exported here: the name is its wrapper module's)

The CUDA sources build on first use (:mod:`repro_torch.kernels._build`);
importing this package builds nothing.
"""

from repro_torch.kernels.ops import (  # noqa: F401
    exact_distances,
    exact_topk,
    expand_mask_plane,
    gather_rerank,
    kmeans_assign,
    masked_exact_topk,
    masked_exact_topk_dedup,
    masked_exact_topk_multi,
    masked_pq_topk,
    masked_pq_topk_dedup,
    masked_pq_topk_multi,
    unified_masked_topk,
    unified_masked_topk_dedup,
)
