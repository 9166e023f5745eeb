"""Kernels (kernels/ops.py -> csrc/rerank.cu): ``gather_rerank``'s share of its
roofline over the traced part of the window: the least time its calls
could take (each call's operations and bytes from its shapes, against the
H100's peaks) over the device time of its kernel."""

from harness import trace


def read(obs):
    if obs.recorder is None or obs.profile is None:
        return None
    bound = obs.recorder.family_bound_s("gather_rerank")
    dev = trace.family_device_s(obs.profile, "gather_rerank")
    if not bound or dev <= 0:
        return None
    return 100.0 * bound / dev
