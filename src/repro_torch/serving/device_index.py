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
from_graphs`.  :meth:`DeviceAnnIndex.abstract` is the shape-only index of a
dry-run (``meta`` tensors in the dtypes the port holds: int64 adjacency,
medoids, counts and payload, where the reference holds int32), and
:meth:`DeviceAnnIndex.shardings` its placement on a mesh.

On a mesh (``make_probe_fn(mesh, ...)``) the index's shard dim is split
over ``shard_axes``; the probe is the counterpart of the reference's
``shard_map``: each rank runs the same per-shard beam on its own block
(``to_local()``), then the candidates are gathered over every shard axis
with ``all_gather`` and merged into the stable global top-k, which every
rank holds (the reference gathers over ``pod`` too, where the shards are
replicated, and so returns each hit once a pod).  A DTensor never reaches
a beam or a kernel.

Sentinels are the beam's: a pool slot never filled holds id ``cap`` (the
padded capacity) at distance +inf, and its payload is -1; a slot the beam
deduplicated keeps its id at +inf, so its payload comes back at +inf, as
in the reference.  With no payload the probe returns, as the reference
does, ``adjacency[:, :, 0]`` of each hit: the hit's first neighbour, not
its id.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.vamana import _Beam
from repro_torch.kernels.device_cache import concrete_device, device_lock, resolve_device
from repro_torch.models.sharding import NamedSharding, PartitionSpec, mesh_shape, place


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
    # this index placed on a mesh, by (mesh, shard axes); a placed index's
    # local block
    _placed: dict = field(default_factory=dict, repr=False, compare=False)
    _local: Optional["DeviceAnnIndex"] = field(default=None, repr=False, compare=False)

    @property
    def n_shards(self) -> int:
        return self.vectors.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def shardings(self, mesh, shard_axes: Tuple[str, ...] = ("data",)) -> "DeviceAnnIndex":
        """Every field's :class:`NamedSharding`: the shard dim split over
        ``shard_axes`` (the reference's ``P(shard_axes)``)."""
        spec = PartitionSpec(shard_axes if len(shard_axes) > 1 else shard_axes[0])
        s = NamedSharding(mesh, spec)
        return DeviceAnnIndex(
            vectors=s, adjacency=s, medoids=s, counts=s,
            payload=s if self.payload is not None else None,
        )

    def placed(self, mesh, shard_axes: Tuple[str, ...] = ("data",)) -> "DeviceAnnIndex":
        """This index as DTensors on ``mesh`` (each rank keeps its block of
        shards), kept across calls so its beams are too."""
        key = (id(mesh), tuple(shard_axes))
        held = self._placed.get(key)
        if held is None:
            sh = self.shardings(mesh, shard_axes)
            held = self._placed[key] = DeviceAnnIndex(
                vectors=place(self.vectors, sh.vectors),
                adjacency=place(self.adjacency, sh.adjacency),
                medoids=place(self.medoids, sh.medoids),
                counts=place(self.counts, sh.counts),
                payload=None if self.payload is None else place(self.payload, sh.payload),
            )
        return held

    def local(self) -> "DeviceAnnIndex":
        """This rank's block of a placed index (itself when not placed)."""
        from torch.distributed.tensor import DTensor

        if not isinstance(self.vectors, DTensor):
            return self
        if self._local is None:
            self._local = DeviceAnnIndex(
                vectors=self.vectors.to_local(),
                adjacency=self.adjacency.to_local(),
                medoids=self.medoids.to_local(),
                counts=self.counts.to_local(),
                payload=None if self.payload is None else self.payload.to_local(),
            )
        return self._local

    @staticmethod
    def abstract(n_shards: int, cap: int, dim: int, R: int, dtype=torch.bfloat16,
                 with_payload: bool = True) -> "DeviceAnnIndex":
        """Shape-only (``meta``) tensors for a dry-run, in the dtypes the
        port holds (int64 ids: 8 bytes an adjacency entry)."""
        meta = torch.device("meta")
        return DeviceAnnIndex(
            vectors=torch.empty((n_shards, cap, dim), dtype=dtype, device=meta),
            adjacency=torch.empty((n_shards, cap, R), dtype=torch.int64, device=meta),
            medoids=torch.empty((n_shards,), dtype=torch.int64, device=meta),
            counts=torch.empty((n_shards,), dtype=torch.int64, device=meta),
            payload=torch.empty((n_shards, cap), dtype=torch.int64, device=meta) if with_payload else None,
        )

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


def _probe_shards(index: "DeviceAnnIndex", q: torch.Tensor, *, k_local: int, L: int,
                  max_iters: int, metric: str):
    """Stage A on every shard of ``index`` (plain tensors): each shard's
    ``k_local`` best (ascending, stable) and their payloads, concatenated
    shard after shard: ``(dists (B, S * k_local), payload (B, S * k_local))``."""
    dev = index.device
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
    return torch.cat(dists, dim=1), torch.cat(pls, dim=1)


def _merge(all_d: torch.Tensor, all_p: torch.Tensor, k: int):
    """Stage C: the stable global top-k of the gathered candidates."""
    order = torch.sort(all_d, dim=1, stable=True).indices[:, :k]
    return all_d.gather(1, order), all_p.gather(1, order)


def make_probe_fn(mesh=None, *, k: int, L: int = 32, metric: str = "l2", oversample: int = 2,
                  shard_axes: Tuple[str, ...] = ("data",), device="cuda"):
    """Build the Stage-A + C probe.

    Returned fn: ``(index, queries (B, D)) -> (dists (B, k), payload (B,
    k))``, globally merged, ascending; queries may be numpy or a tensor.
    Per shard: the full-precision beam (``max_iters = int(1.3 L) + 8``), its
    ``min(k * oversample, L)`` best, each mapped to its payload (-1 for an
    empty slot).  Ties keep the lower position, as ``lax.top_k`` does.

    With ``mesh=None`` the probe runs every shard on one device (the
    index's, which must be ``device``) and returns plain tensors.  With a
    mesh, ``shard_axes`` says which mesh axes split the shards: ``("data",)``
    gives each data slice its block of shards (replicated over ``model``);
    ``("data", "model")`` gives every device its own, so a 10^9-vector index
    holds one ~3.9M-vector shard per device.  The index is placed on the
    mesh at the first call (kept for the next), queries are replicated, and
    the result is a pair of replicated DTensors."""
    dev = concrete_device(device)
    max_iters = int(1.3 * L) + 8
    k_local = min(k * oversample, L)

    def as_queries(queries):
        if not torch.is_tensor(queries):
            queries = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
        return queries.to(device=dev, dtype=torch.float32).contiguous()

    if mesh is None:
        def probe(index: DeviceAnnIndex, queries):
            if index.device != dev:
                raise ValueError(f"index lives on {index.device}, the probe on {dev}")
            all_d, all_p = _probe_shards(index, as_queries(queries), k_local=k_local, L=L,
                                         max_iters=max_iters, metric=metric)
            return _merge(all_d, all_p, k)

        return probe

    from torch.distributed.tensor import DTensor, Replicate

    # the candidates are gathered over the axes that split the shards; the
    # reference gathers over ``pod`` too, where the shards are replicated,
    # and so returns each hit once a pod
    gather_axes = tuple(shard_axes)
    replicated = [Replicate()] * mesh.ndim

    def probe(index: DeviceAnnIndex, queries):
        if isinstance(queries, DTensor):
            queries = queries.redistribute(mesh, replicated).to_local()
        q = as_queries(queries)
        local = index.placed(mesh, shard_axes).local()
        if local.device != dev:
            raise ValueError(f"index lives on {local.device}, the probe on {dev}")
        all_d, all_p = _probe_shards(local, q, k_local=k_local, L=L, max_iters=max_iters,
                                     metric=metric)
        all_d, all_p = _gather(all_d, mesh, gather_axes), _gather(all_p, mesh, gather_axes)
        d, p = _merge(all_d, all_p, k)
        return (DTensor.from_local(d, mesh, replicated, run_check=False),
                DTensor.from_local(p, mesh, replicated, run_check=False))

    return probe


def _gather(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` gathered along dim 1 over each mesh axis in turn (the
    reference's ``all_gather(..., axis=1, tiled=True)``)."""
    import torch.distributed._functional_collectives as funcol

    # ``all_gather_single`` is the newer name of ``all_gather_tensor``
    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    sizes = mesh_shape(mesh)
    for ax in axes:
        if sizes[ax] > 1:
            x = gather(x, 1, mesh.get_group(ax))
            x = x.wait() if hasattr(x, "wait") else x
    return x
