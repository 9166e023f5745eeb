"""Device-resident sharded ANN index: the Stage-A + C probe on one card.

Port of ``repro/serving/device_index.py``.  Each shard is one Vamana graph
held as dense tensors on the device (vectors, padded adjacency, medoid,
live count), every shard padded to the largest capacity.  A probe runs the
full-precision beam search over each shard (Stage A), keeps each shard's
``k * oversample`` best (at most ``L``) and merges every shard's candidates
into one global top-k (Stage C).  The reference maps shards over a mesh
axis with ``shard_map`` and gathers the candidates with ``all_gather``; on
one card the shard dimension is a loop, and the merge is a sort of the
concatenated candidates.

Graphs decoded from a Puffin file go straight into :meth:`DeviceAnnIndex.
from_graphs`.  ``abstract`` and ``shardings`` of the reference (shape-only
indexes for dry-run lowering on a mesh) arrive with the port of
``launch/``.

Sentinels are the beam's: a pool slot never filled holds id ``cap`` (the
padded capacity) at distance +inf, and its payload is -1; a slot the beam
deduplicated keeps its id at +inf, so its payload comes back at +inf, as
in the reference.  With no payload the probe returns, as the reference
does, ``adjacency[:, :, 0]`` of each hit: the hit's first neighbour, not
its id.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core.vamana import _Beam
from repro_torch.kernels.device_cache import concrete_device, device_lock, resolve_device


@dataclass
class DeviceAnnIndex:
    """Sharded index tensors on one device; the leading dim is the shard."""

    vectors: torch.Tensor  # (n_shards, cap, D) f32 | bf16
    adjacency: torch.Tensor  # (n_shards, cap, R) int64, -1 pad
    medoids: torch.Tensor  # (n_shards,) int64
    counts: torch.Tensor  # (n_shards,) int64 valid nodes per shard
    payload: Optional[torch.Tensor] = None  # (n_shards, cap) int64, e.g. row numbers
    # beam runners kept across probes, by (shard, query shape, L, ...)
    _beams: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_shards(self) -> int:
        return self.vectors.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @staticmethod
    def from_graphs(graphs, payloads=None, dtype=torch.float32, device="cuda") -> "DeviceAnnIndex":
        """Pack host Vamana graphs (``vectors``, ``adjacency``, ``medoid``,
        ``n``) into device tensors, every shard padded to the largest
        capacity and degree; ``payloads[i]`` fills shard i's first rows."""
        dev = resolve_device(device)
        cap = max(g.vectors.shape[0] for g in graphs)
        R = max(g.adjacency.shape[1] for g in graphs)
        D = graphs[0].vectors.shape[1]
        n = len(graphs)
        vecs = np.zeros((n, cap, D), np.float32)
        adj = np.full((n, cap, R), -1, np.int64)
        meds = np.zeros(n, np.int64)
        counts = np.zeros(n, np.int64)
        pl = None if payloads is None else np.zeros((n, cap), np.int64)
        for i, g in enumerate(graphs):
            c = g.vectors.shape[0]
            vecs[i, :c] = g.vectors
            adj[i, :c, : g.adjacency.shape[1]] = g.adjacency
            meds[i] = g.medoid
            counts[i] = g.n
            if pl is not None:
                pl[i, : len(payloads[i])] = payloads[i]
        return DeviceAnnIndex(
            vectors=torch.from_numpy(vecs).to(device=dev, dtype=dtype),
            adjacency=torch.from_numpy(adj).to(dev),
            medoids=torch.from_numpy(meds).to(dev),
            counts=torch.from_numpy(counts).to(dev),
            payload=None if pl is None else torch.from_numpy(pl).to(dev),
        )

    def _beam(self, shard: int, q_shape, L: int, max_iters: int, metric: str) -> _Beam:
        """Shard ``shard``'s beam runner for these shapes, kept across probes
        (on a card it holds the captured CUDA graph); rebuilt when one of
        the index's tensors was replaced."""
        key = (shard, q_shape, L, max_iters, metric)
        src = (self.vectors, self.adjacency, self.medoids, self.counts)
        held = self._beams.get(key)
        if held is None or any(a is not b for a, b in zip(held[0], src)):
            beam = _Beam(
                self.vectors[shard], self.adjacency[shard], int(self.counts[shard]),
                int(self.medoids[shard]), q_shape, L, max_iters, metric, False,
            )
            held = self._beams[key] = (src, beam)
        return held[1]


def make_probe_fn(*, k: int, L: int = 32, metric: str = "l2", oversample: int = 2, device="cuda"):
    """Build the Stage-A + C probe.

    Returned fn: ``(index, queries (B, D)) -> (dists (B, k), payload (B,
    k))``, globally merged, ascending, on the index's device; queries may be
    numpy or a tensor.  Per shard: the full-precision beam (``max_iters =
    int(1.3 L) + 8``), its ``min(k * oversample, L)`` best, each mapped to
    its payload (-1 for an empty slot).  Ties keep the lower position, as
    ``lax.top_k`` does."""
    dev = concrete_device(device)
    max_iters = int(1.3 * L) + 8
    k_local = min(k * oversample, L)

    def probe(index: DeviceAnnIndex, queries):
        if index.device != dev:
            raise ValueError(f"index lives on {index.device}, the probe on {dev}")
        if not torch.is_tensor(queries):
            queries = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
        q = queries.to(device=dev, dtype=torch.float32).contiguous()
        cap = index.vectors.shape[1]
        payload = index.payload if index.payload is not None else index.adjacency[:, :, 0]
        dists, pls = [], []
        for s in range(index.n_shards):
            with device_lock(dev):
                beam = index._beam(s, tuple(q.shape), L, max_iters, metric)
                ids, d, _, _ = beam.run(q)
                order = torch.sort(d, dim=1, stable=True).indices[:, :k_local]
                lids = ids.gather(1, order)
                dists.append(d.gather(1, order))
                pls.append(torch.where(lids < cap, payload[s][lids.clamp(0, cap - 1)], -1))
        all_d, all_p = torch.cat(dists, dim=1), torch.cat(pls, dim=1)
        order = torch.sort(all_d, dim=1, stable=True).indices[:, :k]
        return all_d.gather(1, order), all_p.gather(1, order)

    return probe
