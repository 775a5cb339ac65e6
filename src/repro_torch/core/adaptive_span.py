"""Deployment-time adaptive attention spans (paper §III-B, Table I).

At deployment the learned spans are frozen to integers: a head with span 0
is skipped entirely (its context vector is zero) and the surviving heads
attend over a window of ``span`` tokens, which the span-attention kernel
uses to bound its kv-tile loop.  Host-side numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def hard_spans(z, threshold: float = 0.5) -> np.ndarray:
    """Deployment-time integer spans. z < threshold -> head off."""
    z = np.asarray(z)
    s = np.ceil(z).astype(np.int32)
    s[z < threshold] = 0
    return s


def active_head_indices(spans: Sequence[int]) -> Tuple[np.ndarray, int]:
    """Indices of heads with span > 0 and the max surviving span (window)."""
    spans = np.asarray(spans)
    idx = np.nonzero(spans > 0)[0]
    window = int(spans[idx].max()) if idx.size else 0
    return idx, window
