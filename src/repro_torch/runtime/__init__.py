"""Distributed runtime: coordinator, executor fleet, cache-aware scheduler.

In-process simulation of the paper's FlockDB deployment shape: one
coordinator, N stateless executors with local SSD caches, a shared object
store, and an Iceberg REST catalog as the source of truth.  Executors run on
their own threads and share one device.
"""

from repro_torch.runtime.fragments import (  # noqa: F401
    IndexBuildResult,
    IndexBuildTaskInfo,
    ProbeResult,
    ProbeTaskInfo,
    RefreshResult,
    RefreshTaskInfo,
    RerankResult,
    RerankTaskInfo,
)
from repro_torch.runtime.executor import Executor, ExecutorDead  # noqa: F401
from repro_torch.runtime.scheduler import ExecutorPool, Scheduler  # noqa: F401
from repro_torch.runtime.coordinator import Coordinator, IndexConfig  # noqa: F401
from repro_torch.runtime.predicates import (  # noqa: F401
    And,
    Eq,
    In,
    Or,
    Predicate,
    Range,
    parse_predicate,
)
