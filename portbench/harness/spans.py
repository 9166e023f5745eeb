"""The program's own span log over a window (``repro_torch.serving.metrics``).

The port records its spans itself once ``metrics.enable()`` is called:
``batcher.flush`` (attrs ``queries``, ``wait_s``), ``probe.*``,
``scheduler.*``, ``shard.*``, ``device.lock_wait``, ``beam.*``,
``rerank.*``, generation-2 ``gc.collect``, and the counter ``gc.pause_s``.
``metrics.drain()`` hands them over as a ``Drained`` (``.spans``,
``.counters``).  The four readers below take that object, or None where the
program has no span log (a tree before it) or the log was not on, and
return None then; :func:`as_host_spans` puts the program's spans beside the
harness's for ``trace.idle_by_host``.  These are what the four metric files
and the idle breakdown will call once ``cell.py`` turns the log on.

"Per query" divides by the queries of the window's ``batcher.flush`` spans.
Lock waits and row reads run on several executor threads at once, so their
sums are thread-seconds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

NEVER_CHARGED = ("device.lock_wait",)  # a thread waiting for the card's lock leaves it idle to another


def _queries(drained) -> int:
    if drained is None:
        return 0
    return sum(int(s.attrs.get("queries", 0)) for s in drained.spans if s.name == "batcher.flush")


def seconds_by_name(drained) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s in drained.spans if drained is not None else ():
        out[s.name] = out.get(s.name, 0.0) + s.seconds
    return out


def _per_query_ms(drained, seconds: float) -> Optional[float]:
    n = _queries(drained)
    return 1e3 * seconds / n if n else None


def queue_wait_ms(drained) -> Optional[float]:
    """Serving tier: the batcher's queue wait (submit to the flush's start),
    summed over the window's flushes, per query."""
    if not _queries(drained):
        return None
    wait = sum(float(s.attrs.get("wait_s", 0.0)) for s in drained.spans
               if s.name == "batcher.flush")
    return _per_query_ms(drained, wait)


def lock_wait_ms(drained) -> Optional[float]:
    """Runtime: thread-seconds spent acquiring the card's lock
    (``device.lock_wait``), per query."""
    return _per_query_ms(drained, seconds_by_name(drained).get("device.lock_wait", 0.0))


def row_read_ms(drained) -> Optional[float]:
    """Storage: thread-seconds of Stage B's row reads (``rerank.read``), per
    query."""
    return _per_query_ms(drained, seconds_by_name(drained).get("rerank.read", 0.0))


def gc_pause_ms(drained) -> Optional[float]:
    """Host runtime: the collector's pauses of every generation in the
    window (``gc.pause_s``), per query."""
    if not _queries(drained):
        return None
    return _per_query_ms(drained, float(drained.counters.get("gc.pause_s", 0.0)))


def as_host_spans(drained) -> List[Tuple[str, int, int, int]]:
    """The program's spans as ``trace.Recorder.spans`` holds the harness's
    (name, t0, t1, thread), the never-charged ones left out.  Beside the
    harness's spans in ``trace.idle_by_host``, each idle piece goes to the
    innermost (latest opened) span open over it, so ``rerank.read`` takes
    it from ``_rerank``."""
    if drained is None:
        return []
    return [(s.name, s.t0, s.t1, s.thread) for s in drained.spans
            if s.name not in NEVER_CHARGED]

