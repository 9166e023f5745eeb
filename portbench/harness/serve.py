"""Probe traffic: queries sent through the serving tier's micro-batcher.

One general generator reads a traffic file's parameters:

- ``clients``: closed-loop clients; each keeps one query in flight and sends
  its next one when the answer comes (the closed-loop client of
  ``chip_smoke.py``'s ``_wave``, with one query a client in flight);
- ``max_batch``, ``max_wait_s``: the ``ProbeMicroBatcher``'s settings;
- ``max_qps``: the queries drawn a second of window (the most the window
  can use; each query is sent once).

The queries come from the configuration's mixture, drawn from ``--seed``,
all distinct, unfiltered, with no cache in the serving tier.
"""

from __future__ import annotations

import queue
import time
from dataclasses import dataclass, field
from functools import partial

import numpy as np

from harness import data


def make_queries(cfg: dict, traffic: dict, seed: int, seconds: float,
                 tag: int = data.QUERIES) -> np.ndarray:
    """The queries a window may send, in order: ``max_qps`` a second, and
    one a client more."""
    n = int(traffic["max_qps"] * seconds) + traffic["clients"]
    return data.Mixture.from_config(cfg).sample(n, data.stream(seed, tag))


def batcher(coordinator, table: str, traffic: dict):
    """The serving tier as the traffic file sets it up (not started)."""
    from repro_torch.serving.serve_loop import ProbeMicroBatcher

    return ProbeMicroBatcher(coordinator, table, max_batch=traffic["max_batch"],
                             max_wait_s=traffic["max_wait_s"])


@dataclass
class Window:
    start: float  # perf_counter at the window's open
    seconds: float
    submitted: np.ndarray  # perf_counter at each submission (queries sent in the window)
    done: np.ndarray  # perf_counter at each answer (nan: none came)
    answers: list  # per query: its hit list, or None
    errors: dict = field(default_factory=dict)  # query index -> exception
    exhausted: bool = False  # every drawn query was sent before the close

    def rate(self) -> float:
        """Queries answered a second: every query the window sent and got an
        answer to, those answered after the close included, over the time
        from the open to the last answer.  The serving tier answers a batch
        at once, so this is the rate of whole batches, and a stall anywhere
        in the window, its end included, lowers it."""
        ok = np.array([a is not None for a in self.answers], bool)
        if not ok.any():
            return 0.0
        return int(ok.sum()) / (float(self.done[ok].max()) - self.start)

    def latencies_ms(self) -> np.ndarray:
        """Submit to answer, every query sent; a failed one counts as +inf."""
        lat = (self.done - self.submitted) * 1e3
        failed = np.array([a is None for a in self.answers], bool)
        return np.where(failed | np.isnan(lat), np.inf, lat)


WAIT_S = 60.0  # how long past the close the queries in flight are waited for


def closed_loop(mb, queries: np.ndarray, k: int, clients: int, seconds: float) -> Window:
    """``clients`` closed-loop clients over ``queries`` for ``seconds``: each
    sends its next query when its answer comes, until the window closes;
    then the queries in flight are waited for (up to ``WAIT_S`` past the
    close)."""
    n = len(queries)
    submitted = np.full(n, np.nan)
    done = np.full(n, np.nan)
    answers: list = [None] * n
    errors: dict = {}
    ready: "queue.SimpleQueue[int]" = queue.SimpleQueue()

    def finished(i, fut):
        done[i] = time.perf_counter()
        try:
            answers[i] = fut.result()
        except Exception as exc:  # noqa: BLE001 - a failed query is counted, not raised
            errors[i] = exc
        ready.put(i)

    sent = 0

    def send():
        nonlocal sent
        i = sent
        sent += 1
        submitted[i] = time.perf_counter()
        try:
            fut = mb.submit(queries[i], k)
        except Exception as exc:  # noqa: BLE001 - refused at the door: counted as failed
            errors[i] = exc
            done[i] = submitted[i]
            ready.put(i)
            return
        fut.add_done_callback(partial(finished, i))

    start = time.perf_counter()
    end = start + seconds
    for _ in range(min(clients, n)):
        send()
    in_flight = min(clients, n)
    while in_flight:
        try:
            ready.get(timeout=max(1.0, end + WAIT_S - time.perf_counter()))
        except queue.Empty:
            break  # what is still in flight never came: counted as failed
        in_flight -= 1
        if time.perf_counter() < end and sent < n:
            send()
            in_flight += 1
    return Window(start, seconds, submitted[:sent], done[:sent], answers[:sent], errors,
                  exhausted=sent == n)
