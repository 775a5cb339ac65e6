"""Adaptive attention spans (paper §III-B, Table I; Sukhbaatar et al.).

During fine-tuning and in the serving step each head's learned span z
modulates attention through a soft ramp,

    m_z(d) = clamp((ramp + z - d) / ramp, 0, 1),    d = token distance

(``distance_matrix``, ``span_soft_mask``).  At deployment the spans are
frozen to integers: a head with span 0 is skipped entirely (its context
vector is zero) and the surviving heads attend over a window of ``span``
tokens, which the span-attention kernel uses to bound its kv-tile loop
(``hard_spans``, ``active_head_indices``: host-side numpy, as in the JAX
package).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def distance_matrix(q_len: int, k_len: int, causal: bool, q_offset: int = 0, device=None) -> torch.Tensor:
    """d[i, j] = distance from query i to key j; causal keeps the sign
    (negative = a future key, masked by attention)."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(k_len, device=device)[None, :]
    d = qi - kj
    return d if causal else d.abs()


def span_soft_mask(
    z: torch.Tensor,           # [n_heads] learned spans
    q_len: int,
    k_len: int,
    ramp: int,
    causal: bool,
    q_offset: int = 0,
) -> torch.Tensor:
    """[n_heads, q_len, k_len] soft mask in [0, 1]."""
    d = distance_matrix(q_len, k_len, causal, q_offset, device=z.device).float()
    m = ((ramp + z.float()[:, None, None] - d[None]) / float(ramp)).clamp(0.0, 1.0)
    if causal:
        m = torch.where(d[None] < 0, torch.zeros_like(m), m)
    return m


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
