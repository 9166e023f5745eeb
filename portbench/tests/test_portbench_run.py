"""Whole runs of the tiny cell on the CPU: the result line, the module guard,
and the check's failing readings (the control, and faults planted in the
timed path)."""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import pytest
from conftest import HERE, ROOT

from harness import cell, spec

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _cell(tiny, workload):
    return spec.load(workload, bench_path=tiny["bench"], traffic=tiny["traffic"])


def _run(tiny, workload, traced=False, seconds=1.5, seed=2**31 + 5):
    return cell.run(_cell(tiny, workload), seed, seconds, traced, "cpu", time.perf_counter(),
                    lambda m: None, cache=tiny["cache"])


@pytest.mark.parametrize("traced", [False, True])
def test_probe_run_prints_the_contracts_keys(tiny, traced):
    out = _run(tiny, "sift1m.probe", traced)
    assert KEYS <= set(out) and out["correct"] and out["failed"] == 0
    assert list(out)[-2:] == ["checks", "_check_lines"]  # the compared numbers come last
    c = _cell(tiny, "sift1m.probe")
    want = [m.name for m in (c.per_layer if traced else c.end_to_end)]
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"batch_fill.probe", "stage_a_ms.probe"} <= set(out["metrics"])
    else:
        assert list(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0


def test_no_jax_or_reference_package_after_importing_the_harness():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import run; from harness import cell, check, data, serve, spec, trace, "
            "warehouse; from configs import reference; import control; "
            "print(run.forbidden_modules())") % (str(HERE), str(ROOT / "src"))
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip() == "[]"


def test_run_refuses_without_a_card_and_prints_nothing(no_cuda):
    got = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "sift1m.probe",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert got.returncode != 0 and got.stdout == ""


def test_run_refuses_in_a_directory_of_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns(".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    got = subprocess.run([sys.executable, "portbench/run.py", "--workload", "sift1m.probe",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert got.returncode != 0 and got.stdout == ""


# -- the check fails what it has to fail -------------------------------------------

def _session(tiny, workload):
    s = cell.Session(_cell(tiny, workload), "cpu", lambda m: None, cache=tiny["cache"])
    s.warm(11)
    return s


def _judged(s, seed=12, seconds=1.0):
    r = s.window(seed, seconds, False)
    return {c.name: c for c in s.judge(r)}


def test_the_control_fails_the_distance_gap(tiny):
    s = _session(tiny, "sift1m.probe")
    try:
        r = s.window(13, 1.0, False)
        own = {c.name: c for c in s.judge(r)}
        ctl = {c.name: c for c in s.judge(r, control=True)}
    finally:
        s.close()
    assert all(c.ok for c in own.values())
    assert not ctl["dist_gap"].ok


def _plant(coordinator, fn):
    orig = coordinator.probe_batch

    def broken(*a, **kw):
        rep = orig(*a, **kw)
        fn(rep)
        return rep

    coordinator.probe_batch = broken


def test_an_answer_altered_where_it_is_produced_fails(tiny):
    s = _session(tiny, "sift1m.probe")

    def alter(rep):
        for hits in rep.hits[:1]:
            hits[0].row_offset = (hits[0].row_offset + 1) % 256  # another row, the same distance

    try:
        _plant(s.cluster.coordinator, alter)
        got = _judged(s)
    finally:
        s.close()
    assert not all(c.ok for c in got.values())


def test_half_the_batch_left_out_fails(tiny):
    s = _session(tiny, "sift1m.probe")

    def drop(rep):
        half = len(rep.hits) // 2
        rep.hits[half:] = [[] for _ in rep.hits[half:]]

    try:
        _plant(s.cluster.coordinator, drop)
        got = _judged(s)
    finally:
        s.close()
    assert not got["malformed"].ok


def test_rate_counts_answers_after_the_close_and_a_stall_lowers_it():
    from harness import serve

    sub = np.zeros(4)
    ans = [[1]] * 4
    steady = serve.Window(0.0, 2.0, sub, np.array([0.5, 1.0, 1.5, 2.5]), ans)
    assert steady.rate() == pytest.approx(4 / 2.5)  # the last answer came after the close
    stalled = serve.Window(0.0, 2.0, sub, np.array([0.5, 1.0, 1.5, 6.0]), ans)
    assert stalled.rate() == pytest.approx(4 / 6.0)
    lost = serve.Window(0.0, 2.0, sub, np.array([0.5, 1.0, 1.5, np.nan]), ans[:3] + [None])
    assert lost.rate() == pytest.approx(3 / 1.5)
    assert np.isinf(lost.latencies_ms()[3])


def test_result_line_stays_json_when_a_latency_is_infinite():
    import json

    import run

    line = json.dumps(run.finite({"host": {"p95_ms": float("inf")}, "v": [1.0, float("nan")]}),
                      allow_nan=False)
    assert json.loads(line) == {"host": {"p95_ms": None}, "v": [1.0, None]}
