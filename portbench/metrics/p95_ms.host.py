"""Serving tier, on the host's clock: the 95th percentile of every query's
time from submit to answer in the window (a failed query counts as never
answered), where the card is idle most of the time, so the tail is the
host's."""

import numpy as np


def read(obs):
    w = obs.window
    if w is None or not len(w.answers):
        return None
    return float(np.percentile(w.latencies_ms(), 95))
