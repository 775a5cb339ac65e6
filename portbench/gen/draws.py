"""Seeded draws shared by the generators.

Sizes and gaps are drawn in blocks: each block holds the distribution's
quantiles at the midpoints of ``block`` equal strata, in an order the seed
shuffles.  Every seed then offers the same set of sizes and arrivals per
block, in another order, so the work a run does is fixed by the traffic
file and the seed changes which request gets which size (and the token
ids), not how much there is."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

# independent streams of one seed
STREAM_SIZES, STREAM_TOKENS, STREAM_GAPS, STREAM_NEW = 1, 2, 3, 4


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def inverse_cdf(dist: Dict, u: np.ndarray) -> np.ndarray:
    """The distribution's quantiles at ``u`` in (0, 1).  ``uniform``: whole
    numbers ``min`` .. ``max``; ``lognormal``: ``median`` and ``sigma`` of
    the log, rounded and clipped to [``min``, ``max``]; ``exponential``:
    ``mean``."""
    kind = dist["dist"]
    if kind == "uniform":
        lo, hi = int(dist["min"]), int(dist["max"])
        return np.minimum(lo + np.floor(u * (hi - lo + 1)), hi).astype(np.int64)
    if kind == "lognormal":
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        v = np.rint(float(dist["median"]) * np.exp(float(dist["sigma"]) * z))
        return np.clip(v, int(dist["min"]), int(dist["max"])).astype(np.int64)
    if kind == "exponential":
        return -float(dist["mean"]) * np.log1p(-u)
    raise ValueError(f"unknown distribution {kind!r}")


class Stratified:
    """Endless draws from ``dist``: blocks of its ``block`` stratum
    midpoints, each block in an order drawn from ``gen``."""

    def __init__(self, dist: Dict, block: int, gen: np.random.Generator):
        self.values = inverse_cdf(dist, (np.arange(block) + 0.5) / block)
        self.gen = gen
        self.buf = []

    def __call__(self):
        if not self.buf:
            self.buf = list(self.values[self.gen.permutation(len(self.values))])
        return self.buf.pop()


def length_range(dist: Dict) -> tuple:
    """(shortest, longest) value the distribution can give."""
    if dist["dist"] in ("uniform", "lognormal"):
        return int(dist["min"]), int(dist["max"])
    return 0, math.inf
