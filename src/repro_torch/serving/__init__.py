"""Serving tier: metrics, shard leases, caches, admission control, the probe
micro-batcher and the device-resident ANN probe.

The micro-batcher imports the coordinator, which imports this package's
caches, so it (and the device index) load lazily.  Still to come with the
port of the LLM substrate: ``make_serve_fns`` and ``ServeConfig``
(prefill/decode with kNN-LM retrieval), and, with ``launch/``,
``DeviceAnnIndex.abstract`` / ``shardings``.
"""

from repro_torch.serving.admission import (  # noqa: F401
    AdmissionController,
    AdmissionRejected,
    DeadlineExceeded,
    DegradationPolicy,
    TenantPolicy,
)
from repro_torch.serving.cache import SemanticResultCache, ShardProbeCache  # noqa: F401
from repro_torch.serving.leases import LeaseTable  # noqa: F401
from repro_torch.serving.metrics import MetricsRegistry  # noqa: F401

_LAZY = {
    "ProbeMicroBatcher": ("repro_torch.serving.serve_loop", "ProbeMicroBatcher"),
    "MicroBatchStats": ("repro_torch.serving.serve_loop", "MicroBatchStats"),
    "DeviceAnnIndex": ("repro_torch.serving.device_index", "DeviceAnnIndex"),
    "make_probe_fn": ("repro_torch.serving.device_index", "make_probe_fn"),
}


def __getattr__(name: str):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)
