"""The harness's pieces at tiny sizes: traffic, the reference, the roofline
counts, the check's arithmetic."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from conftest import HERE

from configs import reference
from harness import check, data, serve, trace

CFG = json.loads((HERE / "configs" / "sift1m.json").read_text())
TINY = dict(CFG, rows=800, dim=8, data=dict(CFG["data"], components=8, rank=2))


def _traffic(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def test_traffic_is_deterministic_by_seed():
    t = _traffic("probe")
    a = serve.make_queries(TINY, t, 2**31 + 77, 0.5)
    b = serve.make_queries(TINY, t, 2**31 + 77, 0.5)
    c = serve.make_queries(TINY, t, 2**31 + 78, 0.5)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert len(a) == len(c) == int(t["max_qps"] * 0.5) + t["clients"]


def test_corpus_and_queries_share_the_mixture_but_not_the_draws():
    x, attrs = data.corpus(TINY)
    x2, _ = data.corpus(TINY)
    assert np.array_equal(x, x2) and attrs["price"].min() >= 0 and attrs["price"].max() < 10000
    q = data.Mixture.from_config(TINY).sample(50, data.stream(3, data.QUERIES))
    assert not np.isin(q, x).all()
    assert q.shape == (50, 8) and q.dtype == np.float32


def _brute(x, q, k):
    d = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(x.shape[0]), d.shape), d), axis=1)[:, :k]
    return np.take_along_axis(d, order, 1), order


@pytest.mark.parametrize("k, x_block", [(10, 256), (25, 64)])
def test_reference_matches_numpy_brute_force(k, x_block):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(700, 12)).astype(np.float32)
    q = rng.normal(size=(37, 12)).astype(np.float32)
    d, i = reference.topk(x, q, k, "cpu", q_block=8, x_block=x_block)
    bd, bi = _brute(x, q, k)
    assert np.array_equal(i, bi)
    assert np.allclose(d, bd, rtol=1e-12)
    assert np.allclose(reference.pair_distances(x, q, i, "cpu"), d)


def test_control_reads_the_distance_gap_the_reference_does_not():
    x, _ = data.corpus(TINY)
    q = data.Mixture.from_config(TINY).sample(64, data.stream(9, data.QUERIES))
    d, i = reference.topk(x, q, 10, "cpu", precision="tf32")
    exact = check.judge(reference, x, q, i, d, 10, "cpu")
    same = reference.topk(x, q, 10, "cpu")
    own = check.judge(reference, x, q, same[1], same[0], 10, "cpu")
    assert own["dist_gap"] < 1e-9 and exact["dist_gap"] > 100 * 1e-6


def test_tf32_rounding_keeps_ten_mantissa_bits():
    t = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 3.14159265])
    r = reference.tf32_round(t)
    assert r[0] == 1.0 + 2**-10
    assert r[1] == 1.0 + 2**-10  # rounds up past the half
    assert abs(float(r[2]) - 3.14159265) < 2**-9


def test_gather_rerank_counts_against_hand_worked_shapes():
    q = torch.zeros(2, 4)
    x = torch.zeros(10, 4)
    pids = torch.tensor([[0, 3, 3, -1], [3, 9, 12, 5]], dtype=torch.int32)
    ops, nbytes, peak = trace._gather_counts(q, x, pids, 3)
    # live slots: 0, 3, 3 | 3, 9, 5 = 6; distinct live rows: 0, 3, 5, 9 = 4
    assert int(ops) == 3 * 4 * 6
    assert int(nbytes) == 4 * 4 * 4 + 4 * 2 * 4 + 4 * 8 + 8 * 2 * 3
    assert peak == trace.peaks.F32_FLOPS


def test_calls_are_counted_after_the_window_not_during_it():
    rec = trace.Recorder()
    q, x = torch.zeros(2, 4), torch.zeros(10, 4)
    pids = torch.tensor([[0, 3, 3, -1], [3, 9, 12, 5]], dtype=torch.int32)
    wrapped = rec._counted("gather_rerank", "gather_rerank", lambda *a, **kw: None)
    rec.counting = True
    wrapped(q, x, pids, 3)
    name, args, _ = rec.calls["gather_rerank"][0]
    assert name == "gather_rerank" and args[2] is pids  # a reference, nothing computed
    rec.count()
    assert rec.calls["gather_rerank"][0] == trace._gather_counts(q, x, pids, 3)
    assert rec.family_bound_s("gather_rerank") > 0


def test_roofline_bound_takes_the_larger_term():
    assert trace.peaks.bound_s(67e12, 0) == pytest.approx(1.0)
    assert trace.peaks.bound_s(1, 3.35e12) == pytest.approx(1.0)


def test_layout_reads_hits_back_to_rows_and_flags_malformed_answers():
    from dataclasses import dataclass

    @dataclass
    class Hit:
        file_path: str
        row_group: int
        row_offset: int
        distance: float

    lay = check.Layout([("a", 300), ("b", 200)], 256)
    ok = [Hit("a", 1, 3, 0.5), Hit("b", 0, 7, 0.6)]
    rows, dists, bad = lay.rows([ok, ok[::-1], [Hit("c", 0, 0, 1.0)] * 2, None], 2)
    assert rows[0].tolist() == [259, 307] and not bad[0]
    assert bad[1] and bad[2] and bad[3]  # not ascending; unknown file; never came


def test_idle_gaps_are_charged_to_the_innermost_open_span():
    prof = trace.Profile(window_s=1.0, busy_s=0.5, kernels={}, gaps=[(0.0, 0.4), (0.5, 0.50001)])
    spans = [("outer", 0, int(0.3e9), 1), ("inner", int(0.1e9), int(0.2e9), 2)]
    got = dict(trace.idle_by_host(prof, spans))
    assert got["outer"] == pytest.approx(0.2)
    assert got["inner"] == pytest.approx(0.1)
    assert got["client/batcher"] == pytest.approx(0.1)
    assert got["between launches (< 20 us)"] == pytest.approx(1e-5)
