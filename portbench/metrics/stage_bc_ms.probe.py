"""Runtime: Stage B (the exact rerank of the merged candidates, rows read from
the table) and Stage C (the merge) per query, from ``ProbeReport``'s
``stage_b_seconds + stage_c_seconds`` of every drained ``probe_batch``."""


def read(obs):
    reps = obs.recorder.kept.get("probe") if obs.recorder else None
    queries = sum(r.batch_size for r in reps or ())
    if not queries:
        return None
    return 1e3 * sum(r.stage_b_seconds + r.stage_c_seconds for r in reps) / queries
