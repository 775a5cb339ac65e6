"""Numerically stable entropy of a categorical distribution from logits.

    H = ln(sum e^z) - sum(z * e^z) / sum(e^z),   z = x - max(x)

the paper's Eq. 4 in its correct algebra (see the JAX package's
``core/entropy.py``), clamped at 0 against rounding residue.
"""
from __future__ import annotations

import torch


def entropy_from_logits(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Shannon entropy (nats) of softmax(logits) along ``dim``, float32."""
    x = logits.float()
    m = x.amax(dim=dim, keepdim=True)
    z = x - m
    e = torch.exp(z)
    s = e.sum(dim=dim, keepdim=True)
    h = torch.log(s) - (z * e).sum(dim=dim, keepdim=True) / s
    return h.squeeze(dim).clamp_min(0.0)
