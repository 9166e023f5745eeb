"""Local cluster factory: object store + catalog + executor fleet + coordinator.

The in-process analogue of deploying FlockDB: one object store ("S3"), one
REST catalog, N executors each with an SSD-cache directory, one coordinator.
Used by examples, benchmarks, and integration tests.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List

import torch

from repro_torch.iceberg.catalog import RestCatalog
from repro_torch.kernels.device_cache import resolve_device
from repro_torch.lakehouse.objectstore import ObjectStore
from repro_torch.runtime.coordinator import Coordinator
from repro_torch.runtime.executor import Executor
from repro_torch.runtime.scheduler import ExecutorPool


@dataclass
class LocalCluster:
    root: str
    store: ObjectStore
    catalog: RestCatalog
    executors: List[Executor]
    pool: ExecutorPool
    coordinator: Coordinator
    device: torch.device

    def add_executor(self) -> Executor:
        """Elastic scale-out: a brand new, empty-cache executor."""
        eid = f"ex-{len(self.executors)}"
        ex = Executor(
            eid,
            self.store,
            os.path.join(self.root, "cache", eid),
            device=self.device,
        )
        self.executors.append(ex)
        self.pool.add(ex)
        return ex

    def remove_executor(self, executor_id: str) -> None:
        """Elastic scale-in (the executor's cache is disposable state)."""
        self.pool.remove(executor_id)


def make_local_cluster(
    root: str,
    num_executors: int = 4,
    *,
    enable_speculation: bool = False,
    max_attempts: int = 4,
    lease_ttl: float | None = None,
    probe_cache=None,
    device="cuda",
) -> LocalCluster:
    """``device`` is where every executor's kernels and the coordinator's
    Stage-0 training run: CUDA by default (raises without a card),
    ``"cpu"`` for the plain PyTorch path."""
    dev = resolve_device(device)
    store = ObjectStore(os.path.join(root, "s3"))
    catalog = RestCatalog(store)
    executors = [
        Executor(f"ex-{i}", store, os.path.join(root, "cache", f"ex-{i}"), device=dev)
        for i in range(num_executors)
    ]
    pool = ExecutorPool(executors)
    coordinator = Coordinator(
        catalog,
        pool,
        enable_speculation=enable_speculation,
        max_attempts=max_attempts,
        # optional serving-tier ShardProbeCache — None keeps every probe
        # fully computed (the default for tests and benches)
        probe_cache=probe_cache,
        device=dev,
    )
    if lease_ttl is not None:
        # chaos / failover tests shrink the shard-lease TTL so a silent
        # executor ages out of its leases within the test's patience
        coordinator.scheduler.leases.ttl = float(lease_ttl)
    return LocalCluster(
        root=root,
        store=store,
        catalog=catalog,
        executors=executors,
        pool=pool,
        coordinator=coordinator,
        device=dev,
    )
