"""The port's chaos suite: ``tests/test_chaos.py`` run against the port's
runtime and serving tier.

Killing an executor while it holds fragments (heartbeat dark mid-wave),
before a wave, through the micro-batcher, or with a warm shard-probe cache
loses no query: every query returns hits at parity with a healthy run,
because the scheduler's lease monitor re-dispatches the held fragments.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.chaos

# ``built_cluster``: the port's twin of conftest's (table "emb", index
# "idx").  Nothing joins the attempts a kill leaves asleep: they may
# outlive their wave and this module (``test_exit_with_held_attempt_alive``).
from _torch_cpu import built_cluster  # noqa: E402,F401


def _locs(hits):
    return [(h.file_path, h.row_group, h.row_offset) for h in hits]


def _dists(hits):
    return np.array([h.distance for h in hits])


def _assert_parity(healthy_hits, chaos_hits):
    assert len(healthy_hits) == len(chaos_hits)
    for a, b in zip(healthy_hits, chaos_hits):
        assert _locs(a) == _locs(b)
        np.testing.assert_allclose(_dists(a), _dists(b), rtol=1e-5, atol=1e-3)


def test_kill_executor_mid_wave_loses_no_queries(built_cluster):
    """Heartbeat dies while fragments are in flight; nothing is lost.

    ``kill_next(hold_s=...)`` makes the executor accept a fragment, go
    heartbeat-dead while holding it, and then drop the result.  The
    scheduler's mid-wave monitor must expire its leases and re-dispatch the
    held fragment to a survivor — the batch completes at exact parity with a
    healthy run and the re-dispatch is visible in scheduler stats."""
    c, t, X, centers, rep = built_cluster
    Q = X[:8]

    healthy = c.coordinator.probe_batch("emb", Q, 5, strategy="diskann")
    base_redispatch = c.coordinator.scheduler.stats.redispatches

    doomed = c.executors[1]
    try:
        doomed.kill_next(1, hold_s=0.05)
        chaos = c.coordinator.probe_batch("emb", Q, 5, strategy="diskann")
    finally:
        doomed.revive()

    _assert_parity(healthy.hits, chaos.hits)
    assert len(chaos.hits) == len(Q)
    assert c.coordinator.scheduler.stats.redispatches > base_redispatch
    # the dead executor held (and lost) its only task: it served nothing
    assert chaos.served_by, "probe report must carry placement provenance"
    assert all(not e.endswith(f"@{doomed.executor_id}") for e in chaos.served_by)


def test_held_fragment_is_redispatched_once(built_cluster):
    """One death mid-wave re-dispatches its fragment once: the lease monitor
    and the held attempt's own ``ExecutorDead`` both see it, and only the
    first requeues (the second used to start a third attempt that was still
    computing when the wave returned)."""
    c, t, X, centers, rep = built_cluster
    stats = c.coordinator.scheduler.stats
    healthy = c.coordinator.probe_batch("emb", X[16:24], 5, strategy="diskann")
    doomed = c.executors[1]
    base = stats.redispatches
    try:
        doomed.kill_next(1, hold_s=0.05)
        chaos = c.coordinator.probe_batch("emb", X[16:24], 5, strategy="diskann")
    finally:
        doomed.revive()
    _assert_parity(healthy.hits, chaos.hits)
    assert stats.redispatches - base == 1


def test_kill_executor_mid_wave_through_micro_batcher(built_cluster):
    """The full serving path (submit → batch → wave) survives a mid-wave kill."""
    from repro_torch.serving.serve_loop import ProbeMicroBatcher

    c, t, X, centers, rep = built_cluster
    Q = X[64:70]
    healthy = c.coordinator.probe_batch("emb", Q, 5, strategy="diskann")

    doomed = c.executors[2]
    try:
        doomed.kill_next(1, hold_s=0.05)
        with ProbeMicroBatcher(
            c.coordinator, "emb", max_batch=16, max_wait_s=0.02
        ) as mb:
            got = mb.probe_many([q for q in Q], k=5)
    finally:
        doomed.revive()

    _assert_parity(healthy.hits, got)


def test_kill_executor_between_waves_loses_no_queries(built_cluster):
    """An executor dead BEFORE the wave starts is simply never scheduled."""
    c, t, X, centers, rep = built_cluster
    Q = X[128:136]

    healthy = c.coordinator.probe_batch("emb", Q, 5, strategy="diskann")

    doomed = c.executors[0]
    try:
        doomed.kill()
        chaos = c.coordinator.probe_batch("emb", Q, 5, strategy="diskann")
    finally:
        doomed.revive()

    _assert_parity(healthy.hits, chaos.hits)
    assert all(not e.endswith(f"@{doomed.executor_id}") for e in chaos.served_by)


@pytest.mark.cache
def test_kill_executor_mid_wave_with_warm_shard_cache(built_cluster):
    """Chaos × cache: a mid-wave kill with a warm shard-probe cache.

    The cache is warmed with a SUBSET of the batch (so the chaos probe
    still dispatches live fragments that the doomed executor can hold and
    lose).  The re-dispatched wave may consult the cache freely — results
    must stay at exact parity with a healthy cache-off run, and no cache
    entry written during the chaos wave may attribute ``served_by`` to the
    dead executor (its held fragments were lost, never answered)."""
    from repro_torch.serving.cache import ShardProbeCache

    c, t, X, centers, rep = built_cluster
    Q = X[200:208]

    healthy = c.coordinator.probe_batch("emb", Q, 5, strategy="diskann")

    cache = ShardProbeCache(max_bytes=8 << 20)
    doomed = c.executors[1]
    try:
        c.coordinator.probe_cache = cache
        # warm phase (healthy): only the first half of the batch
        c.coordinator.probe_batch("emb", Q[:4], 5, strategy="diskann")
        warm_keys = {k for k, _ in cache.entries_snapshot()}
        assert warm_keys, "warm phase must populate the cache"

        doomed.kill_next(1, hold_s=0.05)
        chaos = c.coordinator.probe_batch("emb", Q, 5, strategy="diskann")
    finally:
        doomed.revive()
        c.coordinator.probe_cache = None

    _assert_parity(healthy.hits, chaos.hits)
    # the warmed half was served from cache, the rest re-dispatched live
    assert chaos.shard_cache_hits > 0
    assert chaos.cache == "shard"
    assert all(not e.endswith(f"@{doomed.executor_id}") for e in chaos.served_by)
    # entries ADDED by the chaos wave came from the re-dispatch survivors,
    # never from the executor that died holding its fragment
    for key, entry in cache.entries_snapshot():
        if key not in warm_keys:
            assert entry.served_by != doomed.executor_id


# One wave on the chaos cluster with ``executors[1].kill_next(1, hold_s)``,
# then exit without waiting for the held attempt.  Its thread wakes while
# the interpreter finalizes.  The port once requeued that fragment a second
# time when the held attempt raised ``ExecutorDead`` (the lease monitor had
# already re-dispatched it), so a third attempt was still running torch ops
# at exit; a torch op's tensor release takes the GIL in a ``noexcept``
# destructor, the finalizing interpreter answers with ``pthread_exit``, and
# the process aborted: "terminate called without an active exception".
_EXIT_SCRIPT = """
import sys, tempfile
import numpy as np
sys.path[:0] = [{tests!r}, {src!r}]
from conftest import BUILT_CFG, clustered_vectors
from {pkg}.lakehouse.table import LakehouseTable
from {pkg}.runtime.cluster import make_local_cluster
from {pkg}.runtime.coordinator import IndexConfig
rng = np.random.default_rng(0)
c = make_local_cluster(tempfile.mkdtemp(dir="."), num_executors=3{device})
t = LakehouseTable(c.catalog, "emb")
t.create(dim=32)
X, _ = clustered_vectors(rng, n_clusters=24, per_cluster=80, dim=32)
t.append_vectors(X, num_files=9, rows_per_group=128)
c.coordinator.create_index("emb", IndexConfig(name="idx", **BUILT_CFG))
c.executors[1].kill_next(1, hold_s={hold_s})
pr = c.coordinator.probe_batch("emb", X[:8], 5, strategy="diskann")
assert len(pr.hits) == 8
c.executors[1].revive()
"""

EXIT_CASES = [("repro_torch", 0.02), ("repro_torch", 0.05), ("repro_torch", 0.1), ("repro", 0.05)]


@pytest.fixture(scope="module")
def exit_runs(tmp_path_factory):
    """Every case of ``test_exit_with_held_attempt_alive``, its subprocess
    started at once (each builds its own cluster, ~7 s)."""
    here = Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {}
    for pkg, hold_s in EXIT_CASES:
        code = _EXIT_SCRIPT.format(
            tests=str(here), src=str(here.parent / "src"), pkg=pkg, hold_s=hold_s,
            device=', device="cpu"' if pkg == "repro_torch" else "")
        procs[pkg, hold_s] = subprocess.Popen(
            [sys.executable, "-c", code], env=env, cwd=str(tmp_path_factory.mktemp("exit")),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    runs = {}
    for key, p in procs.items():
        out, err = p.communicate(timeout=300)
        runs[key] = (p.returncode, err)
    return runs


@pytest.mark.parametrize("pkg,hold_s", EXIT_CASES)
def test_exit_with_held_attempt_alive(exit_runs, pkg, hold_s):
    """The process exits cleanly while a chaos-held attempt thread is alive,
    in the port as in the reference (``repro``, the parity case)."""
    rc, err = exit_runs[pkg, hold_s]
    assert "terminate called" not in err, err[-2000:]
    assert rc == 0, err[-2000:]
