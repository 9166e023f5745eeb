"""On the card: the reference's CUDA path against its CPU path, and the TF32
control at the configuration's width (skipped without a CUDA device)."""

from __future__ import annotations

import json

import numpy as np
from conftest import HERE

from configs import reference
from harness import check, data


def test_card_reference_matches_the_cpu_and_the_control_fails(cuda):
    for name in ("sift1m",):
        cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
        cfg = dict(cfg, rows=20000)
        x, _ = data.corpus(cfg)
        q = data.Mixture.from_config(cfg).sample(256, data.stream(1, data.QUERIES))
        d_gpu, i_gpu = reference.topk(x, q, 10, cuda)
        d_cpu, i_cpu = reference.topk(x, q, 10, "cpu")
        assert np.array_equal(i_gpu, i_cpu) and np.allclose(d_gpu, d_cpu, rtol=1e-12)
        d_ctl, i_ctl = reference.topk(x, q, 10, cuda, precision="tf32")
        got = check.judge(reference, x, q, i_ctl, d_ctl, 10, cuda)
        assert got["dist_gap"] > cfg["checks"]["dist_gap_max"], (name, got["dist_gap"])
