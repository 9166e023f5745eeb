"""Serving tier (serving/serve_loop.py): how full the micro-batcher's drained
batches were over the window, as a share of ``max_batch`` (its own counters,
``MicroBatchStats.queries / batches``)."""


def read(obs):
    st = obs.batch_stats
    if st is None or not st.batches:
        return None
    return 100.0 * st.queries / (st.batches * obs.traffic["max_batch"])
