"""Deterministic synthetic data, the ``SyntheticLM`` and ``SyntheticCLS`` of
the JAX package's ``data/synthetic.py`` (batches in numpy only, so the copies are
exact).

* SyntheticLM — Zipf-distributed tokens plus induction patterns
  (``A B ... A B``): the decoder's prompts.
* SyntheticCLS — sentence classification with planted structure: class c
  plants tokens from a class-specific vocabulary band at random positions,
  with the CLS token at position 0.  ``signal_ratio`` (the fraction of
  planted positions) sets the difficulty, so easy sentences exit early and
  hard ones late.

Batches are deterministic in (seed, step) and host-shardable:
``shard=(host_index, host_count)`` slices the global batch.

``make_batch_specs`` gives one global batch's inputs as meta tensors (shapes
and dtypes, nothing allocated): the dry run's inputs, as the JAX package's
``make_batch_specs`` gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard: Tuple[int, int] = (0, 1)
    zipf_a: float = 1.2
    induction_period: int = 64

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        host, n_hosts = self.shard
        assert self.global_batch % n_hosts == 0
        local = self.global_batch // n_hosts
        rng = np.random.default_rng((self.seed, step, host))
        # zipf body (clipped to vocab)
        toks = rng.zipf(self.zipf_a, size=(local, self.seq_len)).astype(np.int64)
        toks = np.minimum(toks, self.vocab_size - 1)
        # plant induction: repeat the first half-period later in the sequence
        p = self.induction_period
        if self.seq_len >= 2 * p:
            n_rep = self.seq_len // (2 * p)
            for i in range(n_rep):
                src = slice(2 * p * i, 2 * p * i + p)
                dst = slice(2 * p * i + p, 2 * p * (i + 1))
                toks[:, dst] = toks[:, src]
        return {"tokens": toks.astype(np.int32)}


@dataclass
class SyntheticCLS:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_classes: int = 3
    seed: int = 0
    shard: Tuple[int, int] = (0, 1)
    signal_ratio_range: Tuple[float, float] = (0.05, 0.4)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        host, n_hosts = self.shard
        local = self.global_batch // n_hosts
        rng = np.random.default_rng((self.seed + 1, step, host))
        labels = rng.integers(0, self.num_classes, size=(local,))
        toks = rng.integers(4, self.vocab_size, size=(local, self.seq_len))
        # class-c signal band: tokens in [band_c, band_c + band), planted at a
        # per-sentence signal ratio (easy/hard spread for early exit)
        band = max((self.vocab_size - 4) // (4 * self.num_classes), 2)
        ratios = rng.uniform(*self.signal_ratio_range, size=(local,))
        for i in range(local):
            n_sig = max(int(self.seq_len * ratios[i]), 1)
            pos = rng.choice(np.arange(1, self.seq_len), size=n_sig, replace=False)
            base = 4 + int(labels[i]) * band
            toks[i, pos] = rng.integers(base, base + band, size=n_sig)
        toks[:, 0] = 1  # CLS
        return {
            "tokens": toks.astype(np.int32),
            "labels": labels.astype(np.int32),
            "signal_ratio": ratios.astype(np.float32),
        }


def make_batch_specs(cfg: ModelConfig, shape: ShapeConfig, dtype: torch.dtype = torch.int32) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for one global batch: ``tokens`` [B, S] (train,
    prefill) or [B, 1] (decode: the cache of length S is supplied
    separately), ``labels`` [B] when training a classifier, ``enc_input``
    [B, enc_seq_len, d] for encdec and ``image_embeds`` [B, n_image_tokens,
    d] for vlm (train and prefill), in the JAX package's dtypes."""
    from repro_torch.models.model import _DTYPES

    B, S = shape.global_batch, shape.seq_len
    act = _DTYPES[cfg.dtype]

    def meta(*dims, dt=dtype):
        return torch.empty(dims, dtype=dt, device="meta")

    if shape.kind == "decode":
        return {"tokens": meta(B, 1)}
    specs = {"tokens": meta(B, S)}
    if shape.kind == "train" and cfg.num_classes:
        specs["labels"] = meta(B)
    if cfg.family == "encdec":
        specs["enc_input"] = meta(B, cfg.enc_seq_len, cfg.d_model, dt=act)
    if cfg.family == "vlm":
        specs["image_embeds"] = meta(B, cfg.n_image_tokens, cfg.d_model, dt=act)
    return specs
