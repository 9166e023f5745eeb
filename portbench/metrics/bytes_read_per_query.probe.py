"""Storage (lakehouse/objectstore.py, iceberg/puffin.py): bytes the object
store served per query, from ``ProbeReport.bytes_read`` of every drained
``probe_batch``."""


def read(obs):
    reps = obs.recorder.kept.get("probe") if obs.recorder else None
    queries = sum(r.batch_size for r in reps or ())
    if not queries:
        return None
    return sum(r.bytes_read for r in reps) / queries
