"""Identity-keyed device copies of host graph arrays, one per device.

As ``repro/kernels/device_cache.py``: an entry ``(host_array, n,
device_tensor)`` stays valid only while the host array is the same object
and the graph's row count is unchanged, so a refresh that swaps in a new
array of the same length is never served a stale copy.  Holding the host
array makes the identity test sound (a held object cannot be collected and
its ``id`` recycled).  The attribute name carries the device, so copies on
two devices never alias.

Also :func:`resolve_device`, the device rule of every entry point: CUDA is
the default, and asking for it where it is absent raises.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.kernels import ref


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises ``RuntimeError`` for CUDA without a
    card — nothing falls back to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def concrete_device(device) -> torch.device:
    """:func:`resolve_device`, a CUDA device given the current card's index,
    so it compares equal to the ``.device`` of the tensors made on it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(array, device, dtype=torch.float32) -> torch.Tensor:
    """A numpy array as a contiguous tensor of ``dtype`` on ``device`` (a
    read-only array, e.g. a view of a decoded blob, is copied first)."""
    a = np.ascontiguousarray(array)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device=device, dtype=dtype)


_LOCKS: dict = {}
_LOCKS_GUARD = threading.Lock()


def device_lock(device) -> threading.Lock:
    """One lock per device.  Executors run on threads that share a card;
    the loops of small launches (beam search, prune) take the lock so one
    thread at a time drives the device, instead of every thread trading the
    interpreter lock on each launch."""
    key = str(torch.device(device))
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(key, threading.Lock())


def cached_device_array(host_obj, attr: str, array, n: int, convert, device):
    """Return ``convert(array)`` on ``device``, cached on
    ``host_obj.<attr>@<device>`` and revalidated by array identity + ``n``."""
    key = f"{attr}@{torch.device(device)}"
    entry = host_obj.__dict__.get(key)
    if entry is not None:
        src, src_n, dev = entry
        if src is array and src_n == n:
            return dev
    dev = convert(array)
    host_obj.__dict__[key] = (array, n, dev)
    return dev


def drop_cached(host_obj, attr: str) -> None:
    """Forget every device copy cached under ``attr`` (after an in-place
    edit of the host array)."""
    for key in [k for k in host_obj.__dict__ if k.startswith(f"{attr}@")]:
        del host_obj.__dict__[key]


def _to(device, dtype):
    return lambda a: to_device(a, device, dtype)


def device_padded_vectors(graph) -> torch.Tensor:
    """f32 device copy of the whole ``(cap, D)`` vector array."""
    return cached_device_array(
        graph, "_device_vectors_f32", graph.vectors, graph.n,
        _to(graph.device, torch.float32), graph.device,
    )


def device_vectors(graph) -> torch.Tensor:
    """f32 device copy of ``graph.vectors[:graph.n]`` (a view of the padded
    copy, so search and rerank share one upload)."""
    return device_padded_vectors(graph)[: graph.n]


def device_adjacency(graph) -> torch.Tensor:
    """int64 device copy of the ``(cap, R)`` adjacency (-1 padded)."""
    return cached_device_array(
        graph, "_device_adjacency", graph.adjacency, graph.n,
        _to(graph.device, torch.int64), graph.device,
    )


def device_vectors_quant(graph, dtype: str):
    """Quantized device copy of ``graph.vectors[:graph.n]`` for the reduced-
    precision scans: ``(stored, x_scale)`` per :func:`ref.quantize_points`
    (bf16, or int8 with its per-tensor scale), quantized on the device once
    per (graph, dtype, rows), not once per probe."""
    return cached_device_array(
        graph, f"_device_vectors_{dtype}", graph.vectors, graph.n,
        lambda a: ref.quantize_points(to_device(a[: graph.n], graph.device), dtype),
        graph.device,
    )


def device_codes(graph) -> torch.Tensor:
    """int64 device copy of the ``(cap, m)`` PQ codes."""
    return cached_device_array(
        graph, "_device_codes", graph.pq_codes, graph.n,
        _to(graph.device, torch.int64), graph.device,
    )


def device_codes_u8(graph) -> torch.Tensor:
    """uint8 device copy of ``graph.pq_codes[:graph.n]`` for the masked ADC
    kernels (one byte per code; the beam search gathers from the int64
    copy)."""
    return cached_device_array(
        graph, "_device_codes_u8", graph.pq_codes, graph.n,
        lambda a: to_device(a[: graph.n], graph.device, torch.uint8), graph.device,
    )


def device_tombstones(graph) -> torch.Tensor:
    """bool device copy of the ``(cap,)`` tombstone bitmap."""
    return cached_device_array(
        graph, "_device_tombstones", graph.tombstones, graph.n,
        _to(graph.device, torch.bool), graph.device,
    )
