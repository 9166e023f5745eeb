"""Serving-tier pieces the runtime needs: metrics, shard leases, caches.

The micro-batcher, admission control, device index and model serving
arrive with later slices of the port.
"""

from repro_torch.serving.cache import SemanticResultCache, ShardProbeCache  # noqa: F401
from repro_torch.serving.leases import LeaseTable  # noqa: F401
from repro_torch.serving.metrics import MetricsRegistry  # noqa: F401
