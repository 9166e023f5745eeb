"""File-level centroid index (paper §3.3, §4.1) — the coordinator-tier index.

One entry per data file: the centroid of the file's vectors plus
``max_distance`` (the largest distance from the centroid to any vector in
the file).  Probing is ~10⁴ distance computations — sub-millisecond — so it
runs on the coordinator and prunes the file list before dispatch.

Pruning rules:
- **top-k queries**: keep the ``n_probe`` files with nearest centroids
  (recall/latency dial; paper Table 2 uses ~4 % of files).
- **threshold queries**: *exact* pruning — a file whose
  ``centroid_distance − max_distance > threshold`` cannot contain a match
  (triangle inequality; paper §4.1), so eliminating it is safe.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.blobs import decode_centroid_blob, encode_centroid_blob
from repro_torch.lakehouse.table import LakehouseTable


@dataclass
class CentroidIndex:
    centroids: np.ndarray  # (F, D) f32
    max_distances: np.ndarray  # (F,) f32 — L2 (not squared) radius
    file_paths: List[str]
    metric: str = "l2"

    @property
    def num_files(self) -> int:
        return len(self.file_paths)

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    # -- probes ---------------------------------------------------------------
    def _centroid_dists(self, query: np.ndarray) -> np.ndarray:
        return self._centroid_dists_batch(query[None, :])[0]

    def _centroid_dists_batch(self, queries: np.ndarray) -> np.ndarray:
        """(B, D) → (B, F) centroid distances, one vectorized pass."""
        q = np.asarray(queries, np.float32)
        if self.metric == "ip":
            return -(q @ self.centroids.T)
        diff = self.centroids[None, :, :] - q[:, None, :]  # (B, F, D)
        return np.sqrt(np.maximum(np.einsum("bfd,bfd->bf", diff, diff), 0.0))

    def probe_topk(self, query: np.ndarray, n_probe: int) -> List[str]:
        """The ``n_probe`` most promising files for a top-K query."""
        return self.probe_topk_batch(np.asarray(query, np.float32)[None, :], n_probe)[0]

    def probe_topk_batch(self, queries: np.ndarray, n_probe: int) -> List[List[str]]:
        """Batched routing: per-query ``n_probe`` file lists from a single
        (B, F) distance computation instead of B sequential passes."""
        d = self._centroid_dists_batch(queries)
        keep = min(n_probe, self.num_files)
        order = np.argsort(d, axis=1)[:, :keep]
        return [[self.file_paths[i] for i in row] for row in order]

    def probe_threshold(self, query: np.ndarray, threshold: float) -> List[str]:
        """Exact pruning for ``WHERE dist < threshold`` queries (L2 only)."""
        if self.metric != "l2":
            raise ValueError("threshold pruning requires a true metric (l2)")
        d = self._centroid_dists(np.asarray(query, np.float32))
        keep = d - self.max_distances <= threshold
        return [self.file_paths[i] for i in np.flatnonzero(keep)]

    # -- blob codec ---------------------------------------------------------------
    def to_blob(self) -> bytes:
        return encode_centroid_blob(
            self.centroids,
            np.arange(self.num_files, dtype=np.uint32),
            self.max_distances,
            self.file_paths,
            self.metric,
        )

    @staticmethod
    def from_blob(data: bytes) -> "CentroidIndex":
        centroids, file_indices, max_distances, file_paths, metric = decode_centroid_blob(data)
        order = np.argsort(file_indices)
        return CentroidIndex(
            centroids=centroids[order],
            max_distances=max_distances[order],
            file_paths=[file_paths[int(file_indices[i])] for i in order],
            metric=metric,
        )

    def size_bytes(self) -> int:
        """Uncompressed entry-section size — validates the paper's 30.8 MB
        figure for 10⁴ files × 768 d (§4.1)."""
        return self.num_files * (self.dim * 4 + 8)


def build_centroid_index(
    table: LakehouseTable,
    snapshot_id: Optional[int] = None,
    metric: str = "l2",
) -> CentroidIndex:
    """Scan each data file's vector column and compute (centroid, radius)."""
    files = table.current_files(snapshot_id)
    cents: List[np.ndarray] = []
    radii: List[float] = []
    paths: List[str] = []
    for f in files:
        reader = table.reader(f.path)
        vecs = reader.read_column("vec")
        if vecs.shape[0] == 0:
            continue
        c = vecs.mean(axis=0)
        diff = vecs - c[None, :]
        radius = float(np.sqrt(np.max(np.einsum("nd,nd->n", diff, diff))))
        cents.append(c.astype(np.float32))
        radii.append(radius)
        paths.append(f.path)
    if not cents:
        raise ValueError("no data files with vectors")
    return CentroidIndex(
        centroids=np.stack(cents),
        max_distances=np.asarray(radii, np.float32),
        file_paths=paths,
        metric=metric,
    )
