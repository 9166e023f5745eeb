"""Mesh factories on ``torch.distributed``.

Port of ``repro/launch/mesh.py``.  Functions, not module-level constants, so
importing this module never starts a process group.  Shapes: one pod =
(data=16, model=16) = 256 devices; two pods = (pod=2, data=16, model=16) =
512 devices.  ``pod`` is the axis that crosses nodes; ``data`` / ``model``
stay inside the NVLink / InfiniBand fabric (``analysis/roofline.py`` says
which axis it charges to which link).

- :func:`make_production_mesh` builds the mesh over the process group that
  is already running and raises when its world size is not the mesh's;
- :func:`make_debug_mesh` builds a (data, model) mesh over the running
  group, or, for a 1 x 1 mesh with no group yet, starts a one-rank group
  itself (NCCL on the card, gloo on the CPU) from an in-process store;
- :func:`launch_mesh` is the launchers' choice between them;
- :func:`init_fake_world` starts a fake group of ``world_size`` ranks in
  this process, so a dry-run can trace a production-size mesh with shape-
  only tensors.  It stands where the reference's dry-runs set
  ``XLA_FLAGS=--xla_force_host_platform_device_count=512`` before importing
  jax: call it before anything else touches ``torch.distributed``.  The
  fake group's collectives move no data, so nothing numeric that a fake
  mesh computes is ever compared: only shapes, FLOPs and bytes come from
  it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(
            f"mesh {shape} needs a process group of {need} ranks, found {have} — "
            "the dry-run launchers call repro_torch.launch.mesh.init_fake_world first"
        )
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(data: int = 1, model: int = 1, device="cuda"):
    """A (data, model) mesh.  With no process group running, a 1 x 1 mesh
    starts a one-rank group (NCCL for a CUDA device, which must exist; gloo
    for the CPU); a larger mesh needs the caller's group of ``data *
    model`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_debug_mesh(device='cuda') needs a card; pass device='cpu'")
    need = data * model
    if not dist.is_initialized():
        if need != 1:
            raise RuntimeError(f"a ({data}, {model}) mesh needs a process group of {need} ranks")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None else torch.cuda.current_device())
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif dist.get_world_size() != need:
        raise RuntimeError(f"a ({data}, {model}) mesh needs {need} ranks, "
                           f"the group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=("data", "model"))


def launch_mesh(reduced: bool, device="cuda"):
    """The serve and train launchers' mesh.  The reference's choice: a
    reduced config on a 1 x 1 debug mesh, the published one on the
    production mesh.  A published config launched as one process (no group
    of more than one rank) gets ``None`` instead: it runs on its one card
    with no mesh, and the launcher checks that it fits there."""
    if reduced:
        return make_debug_mesh(1, 1, device=device)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return make_production_mesh(device_type=torch.device(device).type)


def init_fake_world(world_size: int = 512) -> None:
    """Start a fake process group of ``world_size`` ranks in this process
    (this is rank 0), for shape-only dry-runs; a no-op when one is running
    with that size, and a fake group of another size is replaced."""
    if dist.is_initialized():
        if dist.get_backend() == "fake":
            if dist.get_world_size() == world_size:
                return
            dist.destroy_process_group()
        else:
            raise RuntimeError("a process group is already running; the dry-run needs its own "
                               "process (start it before anything else uses torch.distributed)")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def destroy() -> None:
    """Tear down the process group this module started, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()
