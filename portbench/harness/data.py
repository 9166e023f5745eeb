"""The data a cell runs on, drawn from seeds.

A configuration's corpus is one fixed dataset, as the public file it stands
for is one file: its rows and attributes come from the ``data.seed`` written
in the configuration.  What a run varies, its queries, comes from the run's
``--seed``, drawn from the same mixture as the corpus.

The mixture is the one ``chip_smoke.py`` draws as its stand-in for SIFT:
``components`` Gaussian components with centres N(0, center_scale^2) per
coordinate, each with a rank-``rank`` covariance (a random loading, N(0, 1)
factors) plus isotropic N(0, noise^2) noise.  It is copied here so that the
yardstick does not move when the program's smoke changes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# stream tags: a run's streams are seeded by (seed, tag), so a new stream
# never shifts an old one
QUERIES, WARMUP = 1, 5


@dataclass(frozen=True)
class Mixture:
    centers: np.ndarray  # (components, d)
    loads: np.ndarray  # (components, rank, d)
    noise: float

    @classmethod
    def from_config(cls, cfg: dict) -> "Mixture":
        spec = cfg["data"]
        rng = np.random.default_rng(spec["seed"])
        c, r, d = spec["components"], spec["rank"], cfg["dim"]
        centers = rng.normal(size=(c, d)).astype(np.float32) * spec["center_scale"]
        loads = rng.normal(size=(c, r, d)).astype(np.float32) / np.sqrt(r)
        return cls(centers, loads, float(spec["noise"]))

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """``n`` rows: component ids, factors and noise drawn from ``rng``."""
        components, rank, d = self.loads.shape
        comp = rng.integers(0, components, size=n)
        z = rng.normal(size=(n, rank)).astype(np.float32)
        x = self.centers[comp] + rng.normal(size=(n, d)).astype(np.float32) * self.noise
        order = np.argsort(comp, kind="stable")
        bounds = np.searchsorted(comp[order], np.arange(components + 1))
        for c in range(components):
            rows = order[bounds[c] : bounds[c + 1]]
            x[rows] += z[rows] @ self.loads[c]
        return x


def attributes(cfg: dict, n: int, rng: np.random.Generator) -> dict:
    """Per-row attribute columns: each ``{"dtype": "int64", "uniform": [lo, hi)}``."""
    out = {}
    for name, spec in cfg["attributes"].items():
        lo, hi = spec["uniform"]
        out[name] = rng.integers(lo, hi, size=n).astype(spec["dtype"])
    return out


def corpus(cfg: dict) -> tuple:
    """(rows (N, d) f32, attribute columns) of the configuration's dataset."""
    mix = Mixture.from_config(cfg)
    rng = np.random.default_rng([cfg["data"]["seed"], 0])
    x = mix.sample(cfg["rows"], rng)
    return x, attributes(cfg, cfg["rows"], rng)


def stream(seed: int, tag: int) -> np.random.Generator:
    """The run's generator for one purpose (``QUERIES``, ``WARMUP``)."""
    return np.random.default_rng([int(seed) % (1 << 64), tag])
