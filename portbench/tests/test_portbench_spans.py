"""The readers of the program's span log (``harness/spans.py``) on a
synthetic log, the idle breakdown with the program's spans, and
``spans.py``'s measurement on the tiny cell on the CPU."""

from __future__ import annotations

import time

import pytest

import spans as tool
from harness import serve, spec, trace
from harness import spans as program
from repro_torch.serving import metrics

READERS = tool.readers()

MS = 1_000_000  # ns


def _span(name, t0_ms, t1_ms, thread=1, **attrs):
    s = metrics.Span(name, record=False)
    s.t0, s.t1, s.thread, s.attrs = int(t0_ms * MS), int(t1_ms * MS), thread, attrs
    return s


def _log():
    spans = [
        _span("batcher.flush", 0, 100, queries=3, wait_s=0.006),
        _span("batcher.flush", 100, 200, queries=1, wait_s=0.002),
        _span("device.lock_wait", 10, 14, thread=2),
        _span("device.lock_wait", 11, 19, thread=3),
        _span("rerank.read", 50, 70, thread=2),
        _span("rerank.read", 52, 60, thread=3),
        _span("gc.collect", 80, 81, generation=2),
    ]
    return metrics.Drained(spans, {"gc.pause_s": 0.004})


def test_readers_per_query():
    d = _log()
    assert program.queue_wait_ms(d) == pytest.approx(1e3 * 0.008 / 4)
    assert program.lock_wait_ms(d) == pytest.approx(12 / 4)  # thread-ms: two waits at once
    assert program.row_read_ms(d) == pytest.approx(28 / 4)
    assert program.gc_pause_ms(d) == pytest.approx(4 / 4)
    assert tool.counts_by_name(d)["device.lock_wait"] == 2
    assert program.seconds_by_name(d)["rerank.read"] == pytest.approx(0.028)


@pytest.mark.parametrize("name", sorted(READERS))
def test_readers_read_nothing_without_a_log_or_a_flush(name):
    read = READERS[name]
    assert read(None) is None  # a program with no span log, or the log off
    no_flush = metrics.Drained([_span("rerank.read", 0, 5)], {"gc.pause_s": 0.1})
    assert read(no_flush) is None


def test_a_window_without_waits_or_collections_reads_zero():
    d = metrics.Drained([_span("batcher.flush", 0, 10, queries=2, wait_s=0.0)], {})
    assert [READERS[n](d) for n in sorted(READERS)] == [0.0, 0.0, 0.0, 0.0]


def _profile(gaps_ms):
    gaps = [(a / 1e3, b / 1e3) for a, b in gaps_ms]
    return trace.Profile(window_s=1.0, busy_s=0.5, kernels={}, gaps=gaps)


def test_idle_gap_under_a_lock_wait_and_a_beam_goes_to_the_beam():
    prof = _profile([(20, 30)])
    host = [("_probe_shard_batch", 0, 100 * MS, 2), ("_probe_shard_batch", 0, 100 * MS, 3)]
    d = metrics.Drained([_span("beam.run", 15, 40, thread=2),
                         _span("device.lock_wait", 18, 40, thread=3)], {})
    got = dict(trace.idle_by_host(prof, host + program.as_host_spans(d)))
    assert got == {"beam.run": pytest.approx(0.010)}
    assert dict(trace.idle_by_host(prof, host)) == {"_probe_shard_batch": pytest.approx(0.010)}


def test_idle_gap_goes_to_the_program_span_inside_the_harness_wrapper():
    prof = _profile([(10, 30), (60, 70)])
    host = [("_rerank", 5 * MS, 65 * MS, 2)]
    d = metrics.Drained([_span("rerank.read", 8, 25, thread=2),
                         _span("rerank.score", 25, 28, thread=2)], {})
    got = dict(trace.idle_by_host(prof, host + program.as_host_spans(d)))
    assert got["rerank.read"] == pytest.approx(0.015)
    assert got["rerank.score"] == pytest.approx(0.003)
    assert got["_rerank"] == pytest.approx(0.002 + 0.005)  # 28-30 ms and 60-65 ms
    assert got["client/batcher"] == pytest.approx(0.005)


def test_measure_on_the_tiny_cell(tiny):
    c = spec.load("sift1m.probe", bench_path=tiny["bench"], traffic=tiny["traffic"])
    closed_loop = serve.closed_loop
    out = tool.measure(c, 2**31 + 9, 1.0, 1, "cpu", lambda m: None, time.perf_counter(),
                       cache=tiny["cache"])
    assert serve.closed_loop is closed_loop and trace.TOP == 10 and not metrics.tracing
    t = out["traced"]
    assert t["correct"]
    for name in READERS:
        assert t["program"][name] is not None and t["program"][name] >= 0
    assert t["program"]["row_read_ms.probe"] > 0 and t["program"]["lock_wait_ms.probe"] > 0
    labels = {k for k, _ in t["idle_by_all_spans"]}
    assert "device.lock_wait" not in labels and labels & {"rerank.read", "beam.run", "shard.load"}
    assert t["span_counts"]["batcher.flush"] >= 1
    (pair,) = out["pairs"]
    assert pair["off"]["qps"] > 0 and pair["on"]["qps"] > 0 and pair["on"]["spans"] > 0
    assert "spans" not in pair["off"]
