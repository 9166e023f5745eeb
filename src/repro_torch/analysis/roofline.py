"""Roofline terms for the NVIDIA H100 SXM5 80 GB.

Port of ``repro/analysis/roofline.py`` with the reference's dataclass and
formula and the H100's constants (NVIDIA H100 Tensor Core GPU datasheet,
SXM5 column; NVIDIA ConnectX-7 / Quantum-2 NDR for the network):

    compute    = FLOPs / (chips × 989e12)                  [dense bf16 peak, or ``peak_flops``]
    memory     = bytes / (chips × 3.35e12)                 [HBM3]
    collective = coll_bytes / (chips × 1 × 450e9)          [NVLink 4, one direction]
                 + dcn_bytes / (chips × 50e9)              [InfiniBand NDR 400 Gb/s]

The reference's two collective terms are its ICI (inside a pod) and DCN
(across pods) shares; here they are the share that stays inside one node
of ``NODE_GPUS`` GPUs on NVLink, and the share that crosses nodes on each
GPU's own 400 Gb/s InfiniBand NIC.  A mesh's devices are numbered major to
minor, eight to a node, so a mesh axis stays on NVLink only when its
groups fit inside one node (:func:`axis_links`).  On the production meshes
no axis does:

- (data=16, model=16): a ``model`` group is 16 consecutive GPUs, two nodes;
  a ``data`` group strides 16 GPUs, sixteen nodes.  Both go to InfiniBand.
- (pod=2, data=16, model=16): the same, and ``pod`` strides 256 GPUs.

So every collective of the production dry-runs is charged to InfiniBand; a
mesh whose ``model`` axis is 8 or less would keep it on NVLink.

FLOPs come from the traced FLOP counter (:mod:`repro_torch.analysis.flops`);
bytes from an analytic traffic model (params read once per step plus
activation and cache traffic); collective bytes from the traced collective
counter (:mod:`repro_torch.analysis.hlo`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

PEAK_FLOPS = 989e12  # dense bf16 (and fp16) tensor-core FLOP/s, H100 SXM5
PEAK_FLOPS_F32 = 67e12  # f32 FLOP/s on the CUDA cores, H100 SXM5
PEAK_FLOPS_INT8 = 1979e12  # dense int8 tensor-core OP/s, H100 SXM5
HBM_BW = 3.35e12  # bytes/s, HBM3
NVLINK_BW = 450e9  # bytes/s a direction a GPU, NVLink 4 (900 GB/s both ways)
NVLINK_LINKS = 1  # the 450 GB/s is already the sum over a GPU's 18 links
IB_BW = 50e9  # bytes/s a GPU across nodes: one 400 Gb/s NDR NIC a GPU
NODE_GPUS = 8  # GPUs a node on one NVLink switch fabric (HGX H100 8-GPU)


def axis_links(mesh_shape: Dict[str, int]) -> Dict[str, str]:
    """``{axis: "nvlink" | "ib"}`` for a mesh of ``{axis: size}`` (dim
    order, devices numbered major to minor, ``NODE_GPUS`` to a node): an
    axis is NVLink when each of its groups lies inside one node."""
    out = {}
    stride = 1
    for axis, size in reversed(list(mesh_shape.items())):
        # the axis and every axis minor to it tile whole nodes' worth of ids
        out[axis] = "nvlink" if size == 1 or NODE_GPUS % (stride * size) == 0 else "ib"
        stride *= size
    return out


def split_by_link(by_axis: Dict[str, int], mesh_shape: Dict[str, int]) -> Dict[str, float]:
    """Global collective bytes per link (``nvlink`` / ``ib``) from the
    counter's per-axis bytes."""
    links = axis_links(mesh_shape)
    out = {"nvlink": 0.0, "ib": 0.0}
    for axis, b in by_axis.items():
        out[links.get(axis, "ib")] += float(b)
    return out


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    # inputs
    hlo_flops_raw: float  # the traced count as dispatched (no HLO cost analysis here)
    hlo_bytes_raw: float
    jaxpr_flops: float  # the traced FLOP count (the reference's trip-corrected jaxpr count)
    model_bytes: float  # analytic traffic model
    coll_bytes_raw: float
    coll_bytes: float  # global bytes on NVLink (inside a node)
    dcn_bytes: float = 0.0  # global bytes on InfiniBand (across nodes)
    model_flops: float = 0.0  # 6·N_active·D or 2·N_active per token
    peak_flops: float = PEAK_FLOPS  # the peak the traced FLOPs run at (f32 work: PEAK_FLOPS_F32)
    # derived (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0  # MODEL_FLOPS / jaxpr_flops
    roofline_fraction: float = 0.0  # max-term bound vs pure-compute bound
    extra: Dict[str, float] = field(default_factory=dict)

    def finalize(self) -> "RooflineTerms":
        self.t_compute = self.jaxpr_flops / (self.chips * self.peak_flops)
        self.t_memory = self.model_bytes / (self.chips * HBM_BW)
        t_nvlink = self.coll_bytes / (self.chips * NVLINK_LINKS * NVLINK_BW)
        t_ib = self.dcn_bytes / (self.chips * IB_BW)
        self.t_collective = t_nvlink + t_ib
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        self.bottleneck = max(terms, key=terms.get)
        self.useful_ratio = (
            self.model_flops / self.jaxpr_flops if self.jaxpr_flops else 0.0
        )
        # fraction of the pure-compute roofline this step could achieve if
        # perfectly overlapped: useful_compute_time / max(all terms)
        t_useful = self.model_flops / (self.chips * self.peak_flops)
        bound = max(terms.values())
        self.roofline_fraction = t_useful / bound if bound > 0 else 0.0
        return self


def compute_roofline(**kw) -> RooflineTerms:
    return RooflineTerms(**kw).finalize()
