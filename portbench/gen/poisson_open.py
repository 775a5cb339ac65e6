"""An open loop: independent users whose requests arrive as a Poisson
process at ``rate_per_s``, sent when due whatever the server is doing.
Traffic file::

    {"kind": "poisson_open", "rate_per_s": 2000.0, "block": 256,
     "length": {"dist": "lognormal", "median": 40, "sigma": 0.6, "min": 8, "max": 128}}

The gaps are exponential with mean 1 / rate (drawn by strata, as the
lengths: ``gen/draws.py``)."""
from __future__ import annotations

from portbench.gen import closed_loop, draws


class Traffic(closed_loop.Traffic):
    open_loop = True

    def __init__(self, traffic: dict, seed: int, vocab: int):
        super().__init__(dict(traffic, clients=0), seed, vocab)
        self.rate_per_s = float(traffic["rate_per_s"])
        self.gap = draws.Stratified({"dist": "exponential", "mean": 1.0 / self.rate_per_s},
                                    int(traffic.get("block", 256)), draws.rng(seed, draws.STREAM_GAPS))

    def next_gap_s(self) -> float:
        return float(self.gap())


def make(traffic: dict, seed: int, vocab: int) -> Traffic:
    return Traffic(traffic, seed, vocab)
