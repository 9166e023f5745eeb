"""Vamana / DiskANN graph index (paper §2.2, §5–§7) — PyTorch port.

Port of ``repro/core/vamana.py``.  The graph keeps the
reference's layout: a dense padded adjacency ``(cap, R)`` (-1 pad), host
numpy arrays as the state of record, invalid ids == ``cap`` inside the
search.  The jitted jnp primitives become batched torch code on
``graph.device``:

- :func:`_beam_search` — the ``lax.while_loop`` becomes a Python loop (see
  its note on how often the frontier is checked);
- :class:`_MaskedBeam` — the same traversal buffering every neighbour it
  evaluates, for the single admit pass of the masked search;
- :func:`_robust_prune` — the vectorized α-RNG prune;
- the reverse-edge scatter (the reference's per-edge Python loop) is
  vectorized to the same result, see :func:`_reverse_edge_scatter`, and
  :func:`_link_reverse` adds it to the re-prune of overflowing nodes (the
  build's and the insert's shared last step).

Every sort the reference takes with ``jnp.argsort`` (stable) is a stable
``torch.sort``.  Ids are int64 inside (torch indexes with int64) and int32
at the graph arrays.

Entry points: :func:`build_vamana`, :meth:`VamanaGraph.search`,
:meth:`VamanaGraph.search_pq` (PQ traversal + exact rerank of pool ∪
visited through the ``gather_rerank`` kernel), :meth:`VamanaGraph.tombstone`,
:func:`graph_from_arrays` (carry a reference graph into the port),
:meth:`VamanaGraph.search_masked` (the predicate-aware traversal of
filtered probes), :meth:`VamanaGraph.insert_batch` (the refresh's greedy
insert), :func:`brute_force_topk`, :func:`recall_at_k`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pq import PQCodebook, build_luts, encode
from repro_torch.kernels import device_cache, ops
from repro_torch.kernels.device_cache import resolve_device, to_device

INF = float("inf")

# how often the beam search asks the device whether any row still has a
# frontier (each check is a host sync)
FRONTIER_CHECK_EVERY = 8


@dataclass
class VamanaParams:
    R: int = 64  # max degree
    L: int = 100  # beam width / pool size
    alpha: float = 1.2  # RNG pruning slack
    metric: str = "l2"  # l2 | ip

    def to_props(self) -> dict:
        return {"R": str(self.R), "L": str(self.L), "alpha": str(self.alpha), "metric": self.metric}


# ---------------------------------------------------------------------------
# batched primitives (device tensors; ``n_valid`` bounds real ids)
# ---------------------------------------------------------------------------


def _pair_dist(q: torch.Tensor, v: torch.Tensor, metric: str) -> torch.Tensor:
    """q: (..., D), v: (..., D) -> (...)"""
    if metric == "ip":
        return -torch.sum(q * v, dim=-1)
    diff = q - v
    return torch.sum(diff * diff, dim=-1)


def _dup_mask(sorted_ids: torch.Tensor) -> torch.Tensor:
    """True where an id repeats its left neighbour (input sorted by id)."""
    dup = torch.zeros_like(sorted_ids, dtype=torch.bool)
    dup[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
    return dup


class _Beam:
    """Batched greedy beam search over static-shape state.

    The pool is kept as packed keys ``id * 2 + (1 - expanded)`` — the
    reference's dedupe key — beside its distances; visited slots are
    written at a device-side iteration counter.  Every step updates the
    state in place, so on a card a chunk of ``FRONTIER_CHECK_EVERY`` steps
    is captured once as a CUDA graph and replayed (a step is some forty
    small kernels; replaying them removes the per-launch host cost).  On
    the CPU the steps run eagerly.  Both run the same operations.

    The reference's ``lax.while_loop`` stops as soon as no row has a
    frontier.  Here the loop asks only every ``FRONTIER_CHECK_EVERY``
    iterations (each ask is a host sync), so it may run up to that many
    extra iterations, never past ``max_iters``.  They change nothing: a row
    without a frontier is inactive, so its pool keeps the same (id, dist)
    entries in the same order, and its visited slot for the iteration gets
    (cap, +inf), which the reference leaves there too.  The reference runs
    exactly such iterations for every row that finishes before the slowest
    one.
    """

    def __init__(
        self,
        vectors: torch.Tensor,  # (cap, D) f32   (or PQ codes (cap, m) int64 if use_pq)
        adjacency: torch.Tensor,  # (cap, R) int64, -1 pad
        n_valid: int,
        entry: int,
        q_shape: Tuple[int, ...],  # (B, D)      (or LUTs (B, m, K) if use_pq)
        L: int,
        max_iters: int,
        metric: str,
        use_pq: bool,
    ):
        dev = vectors.device
        self.vectors, self.adjacency = vectors, adjacency
        self.cap = vectors.shape[0]
        self.n_valid, self.L, self.max_iters = n_valid, L, max_iters
        self.metric, self.use_pq = metric, use_pq
        B = q_shape[0]
        R = adjacency.shape[1]
        # multi-entry seeding: the medoid plus three strided nodes
        self.n_seeds = min(4, L)
        seeds = [entry] + [
            (s * (n_valid // self.n_seeds)) % max(n_valid, 1) for s in range(1, self.n_seeds)
        ]
        self.seeds = torch.tensor(seeds, dtype=torch.int64, device=dev)
        self.q = torch.zeros(q_shape, dtype=torch.float32, device=dev)
        self.keys = torch.empty((B, L), dtype=torch.int64, device=dev)
        self.dists = torch.empty((B, L), dtype=torch.float32, device=dev)
        self.vis_ids = torch.empty((B, max_iters), dtype=torch.int64, device=dev)
        self.vis_dists = torch.empty((B, max_iters), dtype=torch.float32, device=dev)
        self.it = torch.zeros((B, 1), dtype=torch.int64, device=dev)
        self.dup = torch.zeros((B, L + R), dtype=torch.bool, device=dev)
        self.graph = None
        if dev.type == "cuda":
            self._capture()

    def dist_to(self, ids: torch.Tensor) -> torch.Tensor:  # ids (B, K) -> (B, K)
        safe = ids.clamp(0, self.cap - 1)
        if self.use_pq:
            codes = self.vectors[safe]  # (B, K, m)
            # luts (B, m, Kcode); gather -> (B, m, K)
            d = torch.sum(torch.gather(self.q, 2, codes.transpose(1, 2)), dim=1)
        else:
            d = _pair_dist(self.q[:, None, :], self.vectors[safe], self.metric)
        return torch.where(ids < self.n_valid, d, INF)

    def _reset(self) -> None:
        ns, cap = self.n_seeds, self.cap
        self.keys.fill_(cap * 2)  # invalid id, expanded
        self.keys[:, :ns] = self.seeds * 2 + 1  # seeds start unexpanded
        self.dists.fill_(INF)
        self.dists[:, :ns] = self.dist_to(self.seeds.expand(self.q.shape[0], ns))
        self.vis_ids.fill_(cap)
        self.vis_dists.fill_(INF)
        self.it.zero_()

    def _frontier(self) -> torch.Tensor:
        return torch.where(((self.keys & 1) == 1) & torch.isfinite(self.dists), self.dists, INF)

    def _step(self) -> None:
        cap = self.cap
        frontier = self._frontier()
        best = torch.argmin(frontier, dim=1, keepdim=True)  # (B, 1)
        best_key = self.keys.gather(1, best)
        best_dist = self.dists.gather(1, best)
        active = torch.isfinite(frontier.gather(1, best))  # row still has frontier
        best_id = best_key >> 1
        self.keys.scatter_(1, best, best_key & ~1)  # mark expanded
        self.vis_ids.scatter_(1, self.it, torch.where(active, best_id, cap))
        self.vis_dists.scatter_(1, self.it, torch.where(active, best_dist, INF))
        self.it += 1
        nbrs = self.adjacency[best_id[:, 0].clamp(0, cap - 1)]  # (B, R)
        nbrs = torch.where((nbrs >= 0) & active, nbrs, cap)
        nd = self.dist_to(nbrs)
        self._offer(nbrs, nd)
        # merge pool + neighbors; sort by key (id asc, expanded first) to
        # dedupe, then keep the top-L by distance (both sorts stable)
        cat_keys, order = torch.sort(
            torch.cat([self.keys, nbrs * 2 + 1], dim=1), dim=1, stable=True
        )
        cat_d = torch.cat([self.dists, nd], dim=1).gather(1, order)
        cat_ids = cat_keys >> 1
        self.dup[:, 1:] = cat_ids[:, 1:] == cat_ids[:, :-1]
        cat_d = torch.where(self.dup, INF, cat_d)
        cat_keys = torch.where(self.dup, cat_keys & ~1, cat_keys)  # never expand a dup
        order = torch.sort(cat_d, dim=1, stable=True).indices[:, : self.L]
        self.keys.copy_(cat_keys.gather(1, order))
        self.dists.copy_(cat_d.gather(1, order))

    def _offer(self, nbrs: torch.Tensor, nd: torch.Tensor) -> None:
        """Hook for every (B, R) neighbour slab a step evaluates."""

    def _capture(self) -> None:
        """Record ``FRONTIER_CHECK_EVERY`` steps as one CUDA graph (after a
        warm-up step on a side stream, as graph capture requires)."""
        side = torch.cuda.Stream(device=self.q.device)
        side.wait_stream(torch.cuda.current_stream(self.q.device))
        with torch.cuda.stream(side):
            self._reset()
            self._step()
        torch.cuda.current_stream(self.q.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            for _ in range(FRONTIER_CHECK_EVERY):
                self._step()

    def run(self, queries: torch.Tensor):
        """Returns (pool_ids (B,L), pool_dists (B,L), visited_ids
        (B,max_iters), visited_dists (B,max_iters)), ids int64.  Invalid
        slots: id == cap, dist == +inf."""
        self.q.copy_(queries)
        self._reset()
        self._search()
        return (
            self.keys >> 1,
            self.dists.clone(),
            self.vis_ids.clone(),
            self.vis_dists.clone(),
        )

    def _search(self) -> None:
        """Steps until no row has a frontier left or ``max_iters`` are
        taken, testing the frontier every ``FRONTIER_CHECK_EVERY`` steps."""
        it = 0
        while it < self.max_iters:
            if not bool(torch.isfinite(self._frontier()).any()):
                break
            chunk = min(FRONTIER_CHECK_EVERY, self.max_iters - it)
            if self.graph is not None and chunk == FRONTIER_CHECK_EVERY:
                self.graph.replay()
            else:
                for _ in range(chunk):
                    self._step()
            it += chunk


class _MaskedBeam(_Beam):
    """:class:`_Beam` that also buffers every (id, dist) the traversal
    evaluates, one (B, R) slab per iteration written at the device-side
    iteration counter, for the single admit pass after the loop (the
    reference's ``_masked_beam_search``).  The traversal itself is the
    unmasked one: masked nodes expand and steer the pool.  The extra
    iterations past the last frontier (see :class:`_Beam`) write their slab
    of an inactive row as (cap, +inf), which is what the reference's buffer
    holds there.  On a card the slab writes are part of the captured graph.
    """

    def __init__(self, vectors, adjacency, n_valid, entry, q_shape, L, max_iters, metric, use_pq):
        B, R = q_shape[0], adjacency.shape[1]
        dev = vectors.device
        self.cand_ids = torch.empty((B, max_iters, R), dtype=torch.int64, device=dev)
        self.cand_dists = torch.empty((B, max_iters, R), dtype=torch.float32, device=dev)
        super().__init__(vectors, adjacency, n_valid, entry, q_shape, L, max_iters, metric, use_pq)

    def _reset(self) -> None:
        super()._reset()
        self.cand_ids.fill_(self.cap)
        self.cand_dists.fill_(INF)

    def _offer(self, nbrs: torch.Tensor, nd: torch.Tensor) -> None:
        # the step has already advanced ``it``: this slab is iteration it - 1
        at = (self.it - 1)[:, :, None].expand(-1, 1, nbrs.shape[1])
        self.cand_ids.scatter_(1, at, nbrs[:, None, :])
        self.cand_dists.scatter_(1, at, nd[:, None, :])

    def run_masked(self, queries: torch.Tensor, masks: torch.Tensor, mask_idx: torch.Tensor, k_res: int):
        """Traverse, then admit: seeds and every buffered offer, gated by
        the query's mask row (``masks`` (m, cap) bool, ``mask_idx`` (B,)),
        deduped by id, top-``k_res`` by distance (stable sorts, as the
        reference).  Returns (res_ids (B, k_res), res_dists (B, k_res),
        vis_ids (B, max_iters)); unfilled slots hold (cap, +inf)."""
        _ids, _dists, vis_ids, _vd = self.run(queries)
        cap = self.cap
        B = self.q.shape[0]
        seeds = self.seeds.expand(B, self.n_seeds)
        all_ids = torch.cat([seeds, self.cand_ids.reshape(B, -1)], dim=1)
        all_d = torch.cat([self.dist_to(seeds), self.cand_dists.reshape(B, -1)], dim=1)
        if all_ids.shape[1] < k_res:  # keep the output width at k_res
            pad = k_res - all_ids.shape[1]
            all_ids = torch.nn.functional.pad(all_ids, (0, pad), value=cap)
            all_d = torch.nn.functional.pad(all_d, (0, pad), value=INF)
        safe = all_ids.clamp(0, cap - 1)
        ok = masks[mask_idx[:, None], safe] & (all_ids < self.n_valid)
        all_ids = torch.where(ok, all_ids, cap)
        all_d = torch.where(ok, all_d, INF)
        s_ids, order = torch.sort(all_ids, dim=1, stable=True)
        s_d = torch.where(_dup_mask(s_ids), INF, all_d.gather(1, order))
        order = torch.sort(s_d, dim=1, stable=True).indices[:, :k_res]
        return s_ids.gather(1, order), s_d.gather(1, order), vis_ids


def _beam_search(
    vectors: torch.Tensor,
    adjacency: torch.Tensor,
    n_valid: int,
    entry: int,
    queries: torch.Tensor,
    L: int,
    max_iters: int,
    metric: str,
    use_pq: bool,
):
    """One-shot :class:`_Beam` search (the reference's function form)."""
    beam = _Beam(
        vectors, adjacency, n_valid, entry, tuple(queries.shape), L, max_iters, metric, use_pq
    )
    return beam.run(queries)


# the prune asks whether any candidate is still alive this often (host sync)
PRUNE_CHECK_EVERY = 8


def _robust_prune(
    vectors: torch.Tensor,  # (cap, D)
    p_vecs: torch.Tensor,  # (B, D) the points being pruned
    cand_ids: torch.Tensor,  # (B, C) candidate ids (cap = invalid)
    n_valid: int,
    R: int,
    alpha: float,
    metric: str,
) -> torch.Tensor:
    """Vectorized α-RNG robust prune.  Returns (B, R) int64, -1 padded.

    Stops early once no row has a live candidate: every later step would
    write -1, which the result already holds."""
    cap = vectors.shape[0]
    B, C = cand_ids.shape
    dev = cand_ids.device
    cand_ids = cand_ids.to(torch.int64)
    # dedupe identical ids: sort by id (stable), invalidate repeats; the
    # gather of the candidate rows happens once, already in sorted order
    s_ids = torch.sort(cand_ids, dim=1, stable=True).values
    s_vecs = vectors[s_ids.clamp(0, cap - 1)]  # (B, C, D)
    valid = s_ids < n_valid
    s_dp = torch.where(valid, _pair_dist(p_vecs[:, None, :], s_vecs, metric), INF)
    s_dp = torch.where(_dup_mask(s_ids), INF, s_dp)
    alive = torch.isfinite(s_dp)

    result = torch.full((B, R), -1, dtype=torch.int64, device=dev)
    row = torch.arange(B, device=dev)
    for step in range(R):
        if step % PRUNE_CHECK_EVERY == 0 and not bool(alive.any()):
            break
        masked = torch.where(alive, s_dp, INF)
        pick = torch.argmin(masked, dim=1)  # (B,)
        ok = torch.isfinite(masked[row, pick])
        pick_id = s_ids[row, pick]
        result[:, step] = torch.where(ok, pick_id, -1)
        pvec = s_vecs[row, pick]  # (B, D)
        d_star = _pair_dist(pvec[:, None, :], s_vecs, metric)  # (B, C)
        kill = alpha * d_star <= s_dp  # removes pick itself (d_star=0)
        alive = alive & ~kill & ok[:, None]
    return result


def _group_ranks(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Rank of each entry within its run of equal keys (input sorted)."""
    n = sorted_keys.shape[0]
    pos = torch.arange(n, device=sorted_keys.device)
    start = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    if n > 1:
        start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    first = torch.cummax(torch.where(start, pos, 0), dim=0).values
    return pos - first


def _reverse_edge_scatter(
    adjacency: torch.Tensor, src_ids: torch.Tensor, nbrs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Add the reverse edges ``nbr -> src`` for every ``src`` and each of its
    new neighbours, in place on ``adjacency``; return the edges that found no
    free slot as (targets, sources), sorted by target, in arrival order.

    Same result as the reference's loop (``VamanaGraph._add_reverse_edges``),
    which walks the sources in order and each row left to right: an edge is
    skipped when its source is already in the target's row, takes the
    target's first free slot if there is one, and else overflows.  Edges
    into one target never touch another target's row, and within a target
    the earlier edge takes the earlier free slot, so: flatten the edges in
    arrival order, drop those already present, sort stably by target, give
    the r-th surviving edge of a target its r-th free slot, and send the
    rest to overflow in the same order."""
    R = adjacency.shape[1]
    tgt = nbrs.reshape(-1).to(torch.int64)
    src = src_ids.to(torch.int64).repeat_interleave(nbrs.shape[1])
    keep = tgt >= 0
    tgt, src = tgt[keep], src[keep]
    rows = adjacency[tgt]
    present = (rows == src[:, None]).any(dim=1)
    tgt, src = tgt[~present], src[~present]
    tgt, order = torch.sort(tgt, stable=True)
    src = src[order]
    rank = _group_ranks(tgt)
    rows = adjacency[tgt]  # (E, R)
    free = rows < 0
    # positions of each row's free slots in ascending order (R = none left)
    slot_pos = torch.arange(R, device=adjacency.device).expand_as(rows)
    free_pos = torch.sort(torch.where(free, slot_pos, R), dim=1).values
    n_free = free.sum(dim=1)
    fits = rank < n_free
    slot = free_pos[fits, rank[fits]]
    adjacency[tgt[fits], slot] = src[fits]
    return tgt[~fits], src[~fits]


# rows repruned per call: bounds the (rows, C, D) candidate gather
REPRUNE_CHUNK = 16384


def _reprune(
    vectors: torch.Tensor,
    adjacency: torch.Tensor,
    tgt: torch.Tensor,
    src: torch.Tensor,
    n: int,
    params: VamanaParams,
) -> None:
    """Robust-prune every node that overflowed, over its current row plus
    its overflow sources (``tgt`` sorted, arrival order within a target),
    and write the pruned rows back in place.  Same candidates and validity
    bound as the reference's ``_reprune_nodes``; its shape bucketing (which
    only pads with invalid candidates and rows) has no counterpart."""
    if tgt.numel() == 0:
        return
    cap, R = adjacency.shape
    nodes, counts = torch.unique_consecutive(tgt, return_counts=True)
    rank = _group_ranks(tgt)
    node_of = torch.repeat_interleave(torch.arange(nodes.shape[0], device=tgt.device), counts)
    max_id = max(int(nodes.max()), int(src.max()), int(adjacency[nodes].max()))
    n_valid = max(n, max_id + 1)
    for s in range(0, nodes.shape[0], REPRUNE_CHUNK):
        e = min(s + REPRUNE_CHUNK, nodes.shape[0])
        chunk = nodes[s:e]
        sel = (node_of >= s) & (node_of < e)
        extra = int(counts[s:e].max())
        cand = torch.full((e - s, R + extra), cap, dtype=torch.int64, device=tgt.device)
        cur = adjacency[chunk]
        cand[:, :R] = torch.where(cur >= 0, cur, cap)
        cand[node_of[sel] - s, R + rank[sel]] = src[sel]
        pruned = _robust_prune(
            vectors, vectors[chunk], cand, n_valid, params.R, params.alpha, params.metric
        )
        adjacency[chunk] = pruned


# ---------------------------------------------------------------------------
# Graph object (host arrays of record; device copies via device_cache)
# ---------------------------------------------------------------------------


def _link_reverse(
    vectors: torch.Tensor,
    adjacency: torch.Tensor,
    src_ids: torch.Tensor,
    nbrs: torch.Tensor,
    n: int,
    params: VamanaParams,
) -> None:
    """Add the reverse edges of a batch whose rows ``src_ids`` got
    ``nbrs``, then robust-prune every node that overflowed (the reference's
    ``_add_reverse_edges`` with its ``_reprune_nodes``), in place on the
    device arrays."""
    tgt, src = _reverse_edge_scatter(adjacency, src_ids, nbrs)
    _reprune(vectors, adjacency, tgt, src, n, params)


def _round_capacity(n: int) -> int:
    cap = 1024
    while cap < n:
        cap *= 2
    return cap


@dataclass
class VamanaGraph:
    vectors: np.ndarray  # (cap, D) f32; rows >= n are padding
    adjacency: np.ndarray  # (cap, R) int32, -1 pad
    n: int
    medoid: int
    params: VamanaParams
    tombstones: np.ndarray = field(default=None)  # (cap,) bool
    pq: Optional[PQCodebook] = None
    pq_codes: Optional[np.ndarray] = None  # (cap, m) uint8
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.tombstones is None:
            self.tombstones = np.zeros(self.vectors.shape[0], dtype=bool)

    # -- stats ---------------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def num_live(self) -> int:
        return int(self.n - self.tombstones[: self.n].sum())

    @property
    def tombstone_ratio(self) -> float:
        return float(self.tombstones[: self.n].sum() / max(self.n, 1))

    def degrees(self) -> np.ndarray:
        return (self.adjacency[: self.n] >= 0).sum(axis=1)

    # -- search ---------------------------------------------------------------
    def _batches(self, queries: np.ndarray, batch: int):
        """(start, count, padded device batch) per query batch; padding rows
        are zeros, as the reference pads."""
        q_all = to_device(queries, self.device)
        for s in range(0, q_all.shape[0], batch):
            q = q_all[s : s + batch]
            pad = batch - q.shape[0]
            qb = torch.nn.functional.pad(q, (0, 0, 0, pad)) if pad else q
            yield s, q.shape[0], qb.contiguous()

    def search(
        self,
        queries: np.ndarray,
        k: int,
        L: Optional[int] = None,
        batch: int = 64,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Full-precision beam search.  Returns (dists (Q,k), ids (Q,k));
        tombstoned nodes traversed but filtered (paper §7.3)."""
        L = max(L or self.params.L, k)
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        out_d = np.empty((queries.shape[0], k), np.float32)
        out_i = np.empty((queries.shape[0], k), np.int64)
        max_iters = int(1.3 * L) + 8
        vecs = device_cache.device_padded_vectors(self)
        adj = device_cache.device_adjacency(self)
        for s, cnt, qb in self._batches(queries, batch):
            with device_cache.device_lock(self.device):
                beam = self._beam(vecs, adj, tuple(qb.shape), L, max_iters, False)
                ids, dists, _, _ = beam.run(qb)
                ids_np = ids.cpu().numpy()
                dists_np = dists.cpu().numpy()
            # lazy-tombstone filter
            ts = self.tombstones[np.clip(ids_np, 0, self.vectors.shape[0] - 1)]
            dists_np = np.where(ts | (ids_np >= self.n), np.inf, dists_np)
            order = np.argsort(dists_np, axis=1)[:, :k]
            out_d[s : s + cnt] = np.take_along_axis(dists_np, order, axis=1)[:cnt]
            out_i[s : s + cnt] = np.take_along_axis(ids_np, order, axis=1)[:cnt]
        return out_d, out_i

    def search_pq(
        self,
        queries: np.ndarray,
        k: int,
        L: Optional[int] = None,
        rerank: bool = True,
        batch: int = 64,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Stage-A probe: PQ-approximate traversal + full-precision rerank of
        the candidate pool (paper §6)."""
        if self.pq is None or self.pq_codes is None:
            raise ValueError("graph has no PQ data; call attach_pq()")
        L = max(L or self.params.L, k)
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        out_d = np.empty((queries.shape[0], k), np.float32)
        out_i = np.empty((queries.shape[0], k), np.int64)
        max_iters = int(1.3 * L) + 8
        codes = device_cache.device_codes(self)
        adj = device_cache.device_adjacency(self)
        cap = self.vectors.shape[0]
        for s, cnt, qb in self._batches(queries, batch):
            with device_cache.device_lock(self.device):
                luts = build_luts(self.pq, qb, device=self.device)  # (B, m, K)
                beam = self._beam(codes, adj, tuple(luts.shape), L, max_iters, True)
                ids, dists, vis_ids, _ = beam.run(luts)
                if rerank:
                    # DiskANN-style rerank over pool ∪ visited (every visited
                    # node's full vector was paged in during traversal).
                    # Duplicates, out-of-range ids and tombstones fold to the
                    # pid=-1 sentinel; the gather-rerank kernel scores the rest.
                    cand = torch.cat([ids, vis_ids], dim=1)
                    sorted_ids = torch.sort(cand, dim=1, stable=True).values
                    safe = sorted_ids.clamp(0, cap - 1)
                    bad = (
                        _dup_mask(sorted_ids)
                        | (sorted_ids >= self.n)
                        | device_cache.device_tombstones(self)[safe]
                    )
                    pids = torch.where(bad, -1, sorted_ids).to(torch.int32)
                    rd, ri = ops.gather_rerank(
                        qb,
                        device_cache.device_vectors(self),
                        pids,
                        k,
                        metric=self.params.metric,
                        backend="auto",
                    )
                    out_d[s : s + cnt] = rd.cpu().numpy()[:cnt]
                    out_i[s : s + cnt] = ri.cpu().numpy().astype(np.int64)[:cnt]
                    continue
                ids_np = ids.cpu().numpy()
                dists_np = dists.cpu().numpy()
                ts = self.tombstones[np.clip(ids_np, 0, cap - 1)]
                dists_np = np.where(ts | (ids_np >= self.n), np.inf, dists_np)
                order = np.argsort(dists_np, axis=1)[:, :k]
                out_d[s : s + cnt] = np.take_along_axis(dists_np, order, axis=1)[:cnt]
                out_i[s : s + cnt] = np.take_along_axis(ids_np, order, axis=1)[:cnt]
        return out_d, out_i

    def _beam(self, data, adj, q_shape, L, max_iters, use_pq, masked=False) -> "_Beam":
        """The graph's beam-search runner for these shapes, kept across
        calls (on a card it holds the captured CUDA graph); rebuilt when the
        device copies it reads were replaced."""
        beams = self.__dict__.setdefault("_beams", {})
        # a runner holds the row count and entry it was built for
        key = (masked, use_pq, q_shape, L, max_iters, self.n, self.medoid)
        beam = beams.get(key)
        if beam is None or beam.vectors is not data or beam.adjacency is not adj:
            beam = (_MaskedBeam if masked else _Beam)(
                data, adj, self.n, self.medoid, q_shape, L, max_iters, self.params.metric, use_pq
            )
            beams[key] = beam
        return beam

    def search_masked(
        self,
        queries: np.ndarray,
        k: int,
        unique_masks,
        mask_idx: Optional[np.ndarray] = None,
        L: Optional[int] = None,
        batch: int = 64,
        use_pq: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Predicate-aware beam search (the filtered-DiskANN traversal).

        The traversal expands *through* masked nodes, but only admissible
        nodes are admitted to the returned top-``k``.  ``unique_masks`` is
        ``(m, n)`` bool over graph ids (numpy, or a tensor already on the
        graph's device; the caller folds tombstones in); ``mask_idx`` maps
        each query to its row (default: all share row 0).  With ``use_pq``
        the traversal runs on ADC distances and the admitted pool ∪ the
        admissible visited nodes go through the ``gather_rerank`` kernel.

        ``L`` is NOT floored at ``k``: the admitted set is built from every
        neighbour the traversal evaluates, so a wide admit target rides a
        beam of ordinary depth.

        Returns (dists (Q, k), ids (Q, k)), each row ascending; slots the
        traversal could not fill hold ``(+inf, -1)``."""
        k = int(k)
        L = int(L) if L is not None else self.params.L
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        Q = queries.shape[0]
        cap = self.vectors.shape[0]
        masks = torch.as_tensor(unique_masks).to(self.device, torch.bool)
        if masks.dim() == 1:
            masks = masks[None, :]
        mask_pad = torch.zeros((masks.shape[0], cap), dtype=torch.bool, device=self.device)
        width = min(masks.shape[1], cap)
        mask_pad[:, :width] = masks[:, :width]
        idx_all = torch.zeros(Q, dtype=torch.int64, device=self.device)
        if mask_idx is not None:
            idx_all = torch.as_tensor(np.asarray(mask_idx, np.int64)).to(self.device)
        out_d = np.full((Q, k), np.inf, np.float32)
        out_i = np.full((Q, k), -1, np.int64)
        max_iters = int(1.3 * L) + 8
        if use_pq:
            if self.pq is None or self.pq_codes is None:
                raise ValueError("graph has no PQ data; call attach_pq()")
            data = device_cache.device_codes(self)
        else:
            data = device_cache.device_padded_vectors(self)
        adj = device_cache.device_adjacency(self)
        for s, cnt, qb in self._batches(queries, batch):
            ib = idx_all[s : s + batch]
            if ib.shape[0] < batch:
                ib = torch.nn.functional.pad(ib, (0, batch - ib.shape[0]))
            with device_cache.device_lock(self.device):
                if use_pq:
                    luts = build_luts(self.pq, qb, device=self.device)
                    beam = self._beam(data, adj, tuple(luts.shape), L, max_iters, True, masked=True)
                    res_i, _res_d, vis_i = beam.run_masked(luts, mask_pad, ib, k)
                    # exact rerank over admitted pool ∪ admissible visited
                    # nodes: inadmissible and duplicate ids fold to pid -1
                    s_ids = torch.sort(torch.cat([res_i, vis_i], dim=1), dim=1, stable=True).values
                    adm = (
                        mask_pad[ib[:, None], s_ids.clamp(0, cap - 1)]
                        & (s_ids < self.n)
                        & ~_dup_mask(s_ids)
                    )
                    pids = torch.where(adm, s_ids, -1).to(torch.int32)
                    dists, ids = ops.gather_rerank(
                        qb,
                        device_cache.device_vectors(self),
                        pids,
                        k,
                        metric=self.params.metric,
                        backend="auto",
                    )
                else:
                    beam = self._beam(data, adj, tuple(qb.shape), L, max_iters, False, masked=True)
                    ids, dists, _vis = beam.run_masked(qb, mask_pad, ib, k)
                ids = torch.where(torch.isfinite(dists), ids.to(torch.int64), -1)
                out_d[s : s + cnt] = dists.cpu().numpy()[:cnt]
                out_i[s : s + cnt] = ids.cpu().numpy()[:cnt]
        return out_d, out_i

    # -- mutation -----------------------------------------------------------------
    def _ensure_capacity(self, extra: int) -> None:
        """Grow the padded arrays (to the next power-of-two capacity) so
        ``extra`` more rows fit.  The new arrays are new objects, so every
        cached device copy and beam runner is rebuilt from them."""
        need = self.n + extra
        cap = self.vectors.shape[0]
        if need <= cap:
            return
        grow = _round_capacity(need) - cap
        self.vectors = np.concatenate([self.vectors, np.zeros((grow, self.dim), np.float32)])
        self.adjacency = np.concatenate(
            [self.adjacency, np.full((grow, self.params.R), -1, np.int32)]
        )
        self.tombstones = np.concatenate([self.tombstones, np.zeros(grow, bool)])
        if self.pq_codes is not None:
            self.pq_codes = np.concatenate([self.pq_codes, np.zeros((grow, self.pq.m), np.uint8)])

    def insert_batch(self, new_vectors: np.ndarray, batch: int = 64) -> np.ndarray:
        """Greedy insert (paper §7.2), as the reference: for each batch of
        ``batch`` new points, a full-precision beam search from the medoid,
        a robust prune into the points' rows, then the reverse edges with a
        re-prune of the nodes that overflow.  ``n`` keeps its pre-insert
        value until the end, so the new points are invisible to the searches
        and to the forward prunes.  Returns the assigned ids.

        One device copy of the adjacency serves the whole insert (the beam
        runner reads it in place) and the host array is written once at the
        end, instead of a round trip of the (cap, R) array per batch."""
        new_vectors = np.ascontiguousarray(new_vectors, dtype=np.float32)
        count = new_vectors.shape[0]
        self._ensure_capacity(count)
        n0, p = self.n, self.params
        ids = np.arange(n0, n0 + count, dtype=np.int64)
        self.vectors[n0 : n0 + count] = new_vectors
        if self.pq is not None:
            self.pq_codes[n0 : n0 + count] = encode(self.pq, new_vectors, device=self.device)
        # the f32 copy cached at this n lacks the new rows, which the
        # re-prune reads (it may keep a new point as a reverse neighbour)
        device_cache.drop_cached(self, "_device_vectors_f32")
        vec_t = device_cache.device_padded_vectors(self)
        adj_t = torch.as_tensor(self.adjacency).to(self.device, torch.int64)
        ids_t = torch.as_tensor(ids, device=self.device)
        max_iters = int(1.3 * p.L) + 8
        for s, cnt, qb in self._batches(new_vectors, batch):
            with device_cache.device_lock(self.device):
                beam = self._beam(vec_t, adj_t, tuple(qb.shape), p.L, max_iters, False)
                pool_ids, _pd, vis_ids, _vd = beam.run(qb)
                cand = torch.cat([pool_ids, vis_ids], dim=1)
                nbrs = _robust_prune(vec_t, qb, cand, n0, p.R, p.alpha, p.metric)[:cnt]
                sel = ids_t[s : s + cnt]
                adj_t[sel] = nbrs
                _link_reverse(vec_t, adj_t, sel, nbrs, n0, p)
        self.adjacency[:] = adj_t.cpu().numpy()
        device_cache.drop_cached(self, "_device_adjacency")
        self.n = n0 + count
        return ids

    def tombstone(self, ids: np.ndarray) -> None:
        self.tombstones[np.asarray(ids, dtype=np.int64)] = True
        device_cache.drop_cached(self, "_device_tombstones")

    def attach_pq(self, pq: PQCodebook, codes: Optional[np.ndarray] = None) -> None:
        self.pq = pq
        if codes is None:
            codes = encode(pq, self.vectors[: self.n], device=self.device)
        full = np.zeros((self.vectors.shape[0], pq.m), np.uint8)
        full[: self.n] = codes[: self.n]
        self.pq_codes = full
        device_cache.drop_cached(self, "_device_codes")
        device_cache.drop_cached(self, "_device_codes_u8")


def graph_from_arrays(
    vectors: np.ndarray,
    adjacency: np.ndarray,
    n: int,
    medoid: int,
    params: VamanaParams,
    pq_codebook=None,
    pq_codes: Optional[np.ndarray] = None,
    *,
    tombstones: Optional[np.ndarray] = None,
    device="cuda",
) -> VamanaGraph:
    """Build the port's graph from another engine's arrays (the reference's
    ``VamanaGraph`` fields, or any (vectors, adjacency) pair): rows are
    padded to the capacity :func:`_round_capacity` gives, ``pq_codebook``
    is a ``(m, K, dsub)`` array or any object with ``.codebook``, and
    ``pq_codes`` covers at least the first ``n`` rows."""
    vectors = np.asarray(vectors, np.float32)
    adjacency = np.asarray(adjacency, np.int32)
    d = vectors.shape[1]
    cap = max(_round_capacity(n), vectors.shape[0])
    vec = np.zeros((cap, d), np.float32)
    vec[: vectors.shape[0]] = vectors
    adj = np.full((cap, params.R), -1, np.int32)
    adj[: adjacency.shape[0], : adjacency.shape[1]] = adjacency
    ts = np.zeros(cap, bool)
    if tombstones is not None:
        ts[: len(tombstones)] = np.asarray(tombstones, bool)
    params = VamanaParams(R=params.R, L=params.L, alpha=params.alpha, metric=params.metric)
    graph = VamanaGraph(
        vectors=vec, adjacency=adj, n=int(n), medoid=int(medoid), params=params,
        tombstones=ts, device=device,
    )
    if pq_codebook is not None:
        book = np.asarray(getattr(pq_codebook, "codebook", pq_codebook), np.float32)
        graph.attach_pq(
            PQCodebook(book.copy(), params.metric),
            None if pq_codes is None else np.asarray(pq_codes, np.uint8),
        )
    return graph


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _medoid(vectors: np.ndarray) -> int:
    mean = vectors.mean(axis=0, keepdims=True)
    d = np.sum((vectors - mean) ** 2, axis=1)
    return int(np.argmin(d))


def build_vamana(
    vectors: np.ndarray,
    params: VamanaParams = VamanaParams(),
    *,
    seed: int = 0,
    passes: int = 2,
    batch: int = 64,
    with_pq: bool = False,
    pq_m: Optional[int] = None,
    pq_nbits: int = 8,
    device="cuda",
) -> VamanaGraph:
    """Batch-parallel Vamana build.

    1. random R-regular init (host, the reference's RNG stream);
    2. ``passes`` refinement sweeps (first at α=1.0, last at α=params.alpha,
       per the DiskANN two-pass schedule): for every point, beam-search the
       current graph, robust-prune the visited set into its new neighbor
       list, then scatter reverse edges.

    Vectors and adjacency stay on the device for the whole build: each
    batch writes only the rows it changed, and the host adjacency is
    synced once at the end.  The build is held to the reference by recall
    and degree statistics, not bit for bit: distance sums run in another
    order, so near-ties in the stable sorts can resolve differently.
    """
    dev = resolve_device(device)
    vectors = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = vectors.shape
    if n == 0:
        raise ValueError("empty build")
    rng = np.random.default_rng(seed)
    cap = _round_capacity(n)
    padded = np.zeros((cap, d), np.float32)
    padded[:n] = vectors
    adjacency = np.full((cap, params.R), -1, np.int32)
    if n > 1:
        for i in range(n):  # random init, self-loop free
            deg = min(params.R, n - 1)
            choices = rng.choice(n - 1, size=deg, replace=False)
            choices = choices + (choices >= i)
            adjacency[i, :deg] = choices
    graph = VamanaGraph(
        vectors=padded,
        adjacency=adjacency,
        n=n,
        medoid=_medoid(vectors),
        params=params,
        device=dev,
    )
    vec_t = device_cache.device_padded_vectors(graph)
    adj_t = torch.as_tensor(adjacency).to(dev, torch.int64)
    max_iters = int(1.3 * params.L) + 8
    order = rng.permutation(n)
    order_t = torch.as_tensor(order, dtype=torch.int64).to(dev)
    beam = None
    for p_idx in range(passes):
        alpha = 1.0 if p_idx < passes - 1 else params.alpha
        for s in range(0, n, batch):
            # one thread drives the device at a time (executors share it)
            with device_cache.device_lock(dev):
                if beam is None:  # reads vec_t / adj_t in place across batches
                    beam = _Beam(
                        vec_t, adj_t, n, graph.medoid, (batch, d), params.L, max_iters,
                        params.metric, False,
                    )
                sel = order_t[s : s + batch]
                pad = batch - sel.shape[0]
                qb = vec_t[sel]
                sel_pad = sel
                if pad:
                    qb = torch.nn.functional.pad(qb, (0, 0, 0, pad))
                    sel_pad = torch.nn.functional.pad(sel, (0, pad))
                pool_ids, _pd, vis_ids, _vd = beam.run(qb)
                cand = torch.cat([pool_ids, vis_ids], dim=1)
                # a point must not select itself
                cand = torch.where(cand == sel_pad[:, None], cap, cand)
                nbrs = _robust_prune(
                    vec_t, qb, cand, n, params.R, alpha, params.metric
                )[: sel.shape[0]]
                adj_t[sel] = nbrs
                _link_reverse(vec_t, adj_t, sel, nbrs, n, params)
    graph.adjacency[:] = adj_t.cpu().numpy()
    if with_pq:
        m = pq_m if pq_m is not None else max(1, d // 16)
        from repro_torch.core.pq import train_pq

        pq = train_pq(vectors, m=m, nbits=pq_nbits, device=dev)
        graph.attach_pq(pq)
    return graph


def brute_force_topk(
    vectors: np.ndarray, queries: np.ndarray, k: int, metric: str = "l2", *, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact ground truth for recall measurements."""
    dev = resolve_device(device)
    d, i = ops.exact_topk(
        to_device(queries, dev),
        to_device(vectors, dev),
        k,
        metric=metric,
        backend="auto",
    )
    return d.cpu().numpy(), i.cpu().numpy()


def recall_at_k(result_ids: np.ndarray, truth_ids: np.ndarray) -> float:
    hits = 0
    for r, t in zip(result_ids, truth_ids):
        hits += len(set(int(x) for x in r) & set(int(x) for x in t))
    return hits / truth_ids.size
