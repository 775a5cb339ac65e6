"""AdaptivFloat quantize-dequantize (Tambe et al.; EdgeBERT §III-E), plain.

An n-bit float of 1 sign, ``n_exp`` exponent and ``n_bits - 1 - n_exp``
mantissa bits whose exponent bias follows the data: with ``amax`` the
largest magnitude of the group, ``e_max = floor(log2(amax))`` and ``e_min =
e_max - (2**n_exp - 1)``.  A value rounds (half to even) to the nearest
``2**e * (1 + m / 2**n_mant)`` with ``e`` in [e_min, e_max], saturates at
the top value, becomes 0 below half the smallest normal and the smallest
normal up to it.  ``floor(log2(x))`` is taken as ``floor(log(x) / ln 2)``
with the logarithm in float64 rounded to float32 and the product with
1 / ln 2 in float32, the format's definition in the EdgeBERT reproduction
this benchmark measures (it decides the binade of values next to a power
of two)."""
from __future__ import annotations

import math

import torch

_INV_LN2 = float(torch.tensor(1.0 / math.log(2.0), dtype=torch.float32))


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.log(x.double()).float() * _INV_LN2)


def quantize(x: torch.Tensor, n_bits: int, n_exp: int, amax: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) on the AdaptivFloat grid of the bias that ``amax``
    (broadcast against ``x``: one value per group) gives."""
    n_mant = n_bits - 1 - n_exp
    m_scale = float(2 ** n_mant)
    e_min = (floor_log2(amax.float().clamp_min(1e-30)) - (2 ** n_exp - 1)).clamp(-120.0, 120.0)
    e_max = e_min + (2 ** n_exp - 1)
    a = x.abs()
    e = torch.minimum(torch.maximum(floor_log2(a.clamp_min(1e-38)), e_min), e_max)
    scale = torch.ldexp(torch.ones_like(e), e.int())
    val = torch.round(a / scale * m_scale) / m_scale * scale
    val = torch.minimum(val, (2.0 - 1.0 / m_scale) * torch.ldexp(torch.ones_like(e_max), e_max.int()))
    min_pos = torch.ldexp(torch.ones_like(e_min), e_min.int()) * (1.0 + 1.0 / m_scale)
    val = torch.where(a < 0.5 * min_pos, torch.zeros_like(val), torch.maximum(val, min_pos))
    return torch.sign(x) * val
