"""Runtime (runtime/coordinator.py -> executor.py -> core/vamana.py): Stage A
(the shards' beam searches) per query, from ``ProbeReport.stage_a_seconds``
of every ``probe_batch`` the batcher drained in the traced run."""


def read(obs):
    reps = obs.recorder.kept.get("probe") if obs.recorder else None
    queries = sum(r.batch_size for r in reps or ())
    if not queries:
        return None
    return 1e3 * sum(r.stage_a_seconds for r in reps) / queries
