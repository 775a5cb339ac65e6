"""Traffic generators: ``gen/<kind>.py`` reads a traffic file whose
``kind`` names it and returns a ``Traffic`` (``make(traffic, seed, vocab)``)."""
from __future__ import annotations

import importlib


def make(traffic: dict, seed: int, vocab: int):
    """The generator that ``traffic["kind"]`` names, set up from the file's
    parameters and the run's seed."""
    return importlib.import_module(f"portbench.gen.{traffic['kind']}").make(traffic, seed, vocab)
