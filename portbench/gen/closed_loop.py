"""A closed loop: ``clients`` callers, each sending its next request as
soon as the last one completes.  Traffic file::

    {"kind": "closed_loop", "clients": 256, "block": 256,
     "length": {"dist": "uniform", "min": 96, "max": 128},
     "new_tokens": {"dist": "uniform", "min": 128, "max": 384}, "ramp_s": 8.0}

``new_tokens`` (decoders) sets each request's ``max_new_tokens``;
``ramp_s`` (default 0) is served before the window opens."""
from __future__ import annotations

from portbench.gen import draws


class Traffic:
    open_loop = False

    def __init__(self, traffic: dict, seed: int, vocab: int):
        block = int(traffic.get("block", 256))
        self.clients = int(traffic["clients"])
        self.vocab = vocab
        self.length = draws.Stratified(traffic["length"], block, draws.rng(seed, draws.STREAM_SIZES))
        self.tokens = draws.rng(seed, draws.STREAM_TOKENS)
        self.new = (draws.Stratified(traffic["new_tokens"], block, draws.rng(seed, draws.STREAM_NEW))
                    if "new_tokens" in traffic else None)
        self.lengths = draws.length_range(traffic["length"])
        self.rate_per_s = None
        # seconds of serving before the window opens (a closed loop's clients
        # all start together: the ramp lets their first loads pass)
        self.ramp_s = float(traffic.get("ramp_s", 0.0))

    def next_request(self) -> dict:
        n = int(self.length())
        spec = {"tokens": self.tokens.integers(3, self.vocab, n).astype("int32")}
        if self.new is not None:
            spec["max_new_tokens"] = int(self.new())
        return spec


def make(traffic: dict, seed: int, vocab: int) -> Traffic:
    return Traffic(traffic, seed, vocab)
