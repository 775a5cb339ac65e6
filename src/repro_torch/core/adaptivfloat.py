"""AdaptivFloat quantization (paper §III-E; Tambe et al. [52]) in PyTorch.

An n-bit floating-point format (1 sign, ``n_exp`` exponent, rest mantissa)
whose exponent *bias* adapts per tensor to its dynamic range:

    e_max = floor(log2(amax));  e_min = e_max - (2**n_exp - 1)
    normals: +/- 2^e * (1 + m / 2^n_mant),  e in [e_min, e_max]

Zero is the all-zero exponent+mantissa code; ``af_quantize`` equals
``af_decode(af_encode(x))``.  The algebra is that of the JAX package's
``core/adaptivfloat.py``, and the results are bit-identical to it:

* ``floor(log2(.))`` is taken as ``floor(log(x) * f32(1/ln 2))``.  That is
  how XLA lowers ``log2`` on the CPU, and it rounds differently from a
  correctly rounded ``log2`` at exact powers of two (``log2(2**13)`` comes
  out as 12.999999).  The per-tensor bias ``e_min`` comes from it, so
  matching the reference there keeps every code identical.
* powers of two are built exactly from the exponent bits.  The reference's
  ``exp2`` agrees with them bit for bit for integer exponents in [-12, 12]
  (every weight tensor of the ALBERT configs lands there); outside that
  range XLA's CPU ``exp2`` (``exp(x * ln 2)``) is mostly inexact and the
  port keeps the exact AF grid.

The encode and decode of weights are meant to run on the CPU (deploy time);
the per-tile decode on the card lives in ``csrc/af_matmul.cu``.  The static
codec (``af_encode_static`` / ``af_decode_static``) of the AF8 KV cache runs
where the cache lives.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Union

import torch

from repro_torch.common.util import tree_map_with_path

_INV_LN2 = float(torch.tensor(1.0 / math.log(2.0), dtype=torch.float32))


@dataclass(frozen=True)
class AFFormat:
    n_bits: int = 8
    n_exp: int = 3

    @property
    def n_mant(self) -> int:
        return self.n_bits - 1 - self.n_exp

    @property
    def n_levels_exp(self) -> int:
        return 2 ** self.n_exp

    def __post_init__(self):
        assert 1 <= self.n_exp <= 5
        assert self.n_bits - 1 - self.n_exp >= 0, "need >=0 mantissa bits"
        assert self.n_bits <= 8, "codes stored as uint8"


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) as the reference computes it (see module docstring).

    On the card the float32 log is taken as ``(float)log((double)x)``:
    CUDA's ``logf`` is not correctly rounded, and near a power of two a
    last-ulp difference moves the floor into the other binade.  The double
    form gives the same floor as the CPU's float32 log on every float32
    within 64 ulp of 2**k, k in [-126, 127] (``csrc/af_quantize.cu`` does
    the same per element)."""
    if x.device.type == "cuda":
        return torch.floor(torch.log(x.double()).float() * _INV_LN2)
    return torch.floor(torch.log(x) * _INV_LN2)


def exact_pow2(e: torch.Tensor) -> torch.Tensor:
    """2**e as float32 for integer-valued e in [-126, 127], built from bits."""
    bits = (e.to(torch.int32) + 127) << 23
    return bits.view(torch.float32)


def exp_bias_from_amax(amax: torch.Tensor, fmt: AFFormat) -> torch.Tensor:
    """e_min (the adaptive bias) chosen so the top binade covers amax.

    Clamped to +/-120 so 2**e_min never underflows."""
    amax = torch.as_tensor(amax).float().clamp_min(1e-30)
    bias = floor_log2(amax) - (fmt.n_levels_exp - 1)
    return bias.clamp(-120.0, 120.0).to(torch.int32)


def af_quantize(
    x: torch.Tensor, fmt: AFFormat = AFFormat(), amax: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Quantize-dequantize x to the AdaptivFloat grid (per-tensor bias)."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().max()
    e_min = exp_bias_from_amax(amax, fmt).to(xf.device)
    e_max = e_min + fmt.n_levels_exp - 1
    n_mant_scale = float(2 ** fmt.n_mant)

    a = xf.abs()
    sign = torch.sign(xf)
    safe_a = a.clamp_min(1e-38)
    e = torch.clamp(floor_log2(safe_a), e_min.float(), e_max.float())
    scale = exact_pow2(e)
    # round half to even, as jnp.round; rounding to 2.0 carries a binade
    mant = torch.round(a / scale * n_mant_scale) / n_mant_scale
    val = mant * scale
    max_val = (2.0 - 1.0 / n_mant_scale) * exact_pow2(e_max)
    val = torch.minimum(val, max_val)
    min_pos = exact_pow2(e_min) * (1.0 + 1.0 / n_mant_scale)
    val = torch.where(a < 0.5 * min_pos, torch.zeros_like(val), torch.maximum(val, min_pos))
    return (sign * val).to(x.dtype)


def fake_quant(
    x: torch.Tensor, fmt: AFFormat, enabled: bool = True, amax: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Activation fake-quant as the reference writes it: ``x + (q - x)``
    (a straight-through estimator under autodiff).  ``amax`` broadcast
    against ``x`` gives one bias per slice (the serving step's lanes)."""
    if not enabled:
        return x
    with torch.no_grad():          # q carries no gradient: no graph for the codec
        q = af_quantize(x, fmt, amax)
    return x + (q - x.detach())


def af_encode(
    x: torch.Tensor, fmt: AFFormat = AFFormat(), amax: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode to (codes: uint8, e_min: int32 scalar). Bit layout [s|e|m]."""
    xf = x.float()
    if amax is None:
        amax = xf.abs().max()
    e_min = exp_bias_from_amax(amax, fmt).to(xf.device)
    e_max = e_min + fmt.n_levels_exp - 1
    n_mant_scale = float(2 ** fmt.n_mant)

    a = xf.abs()
    sign = (xf < 0).to(torch.uint8)
    safe_a = a.clamp_min(1e-38)
    e = torch.clamp(floor_log2(safe_a), e_min.float(), e_max.float())
    scale = exact_pow2(e)
    # significand = round(a/scale * 2^nm) in [2^nm .. 2^(nm+1)] for normals
    sig = torch.round(a / scale * n_mant_scale)
    m = sig - n_mant_scale                  # mantissa field, may hit 2^nm (carry)
    carry = m >= n_mant_scale
    e = torch.where(carry, e + 1, e)
    m = torch.where(carry, torch.zeros_like(m), m)
    # saturate anything past the top representable value
    max_val = (2.0 - 1.0 / n_mant_scale) * exact_pow2(e_max)
    sat = (a > max_val) | (e > e_max.float())
    e = torch.where(sat, e_max.float().expand_as(e), e)
    m = torch.where(sat, torch.full_like(m, n_mant_scale - 1), m)
    m = m.clamp(0.0, n_mant_scale - 1)      # sub-min garbage overridden below

    e_field = (e - e_min.float()).to(torch.uint8)
    m_field = m.to(torch.uint8)
    sign_bits = sign << (fmt.n_bits - 1)
    code = sign_bits | (e_field << fmt.n_mant) | m_field
    # zero: |x| below half of min positive -> all-zero exp+mant (sign bit 0)
    min_pos = exact_pow2(e_min) * (1.0 + 1.0 / n_mant_scale)
    is_zero = a < 0.5 * min_pos
    # sub-min values round up to min_pos (code e=0, m=1)
    sub = ~is_zero & (a < min_pos)
    code = torch.where(sub, sign_bits | 1, code)
    code = torch.where(is_zero, torch.zeros_like(code), code)
    return code, e_min


def af_decode(
    codes: torch.Tensor,
    e_min: Union[int, torch.Tensor],
    fmt: AFFormat = AFFormat(),
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Decode uint8 codes back to floats."""
    c = codes.to(torch.int32)
    sign_bit = (c >> (fmt.n_bits - 1)) & 1
    e_field = (c >> fmt.n_mant) & (fmt.n_levels_exp - 1)
    m_field = c & ((1 << fmt.n_mant) - 1)
    e_min = torch.as_tensor(e_min, dtype=torch.int32, device=codes.device)
    n_mant_scale = float(2 ** fmt.n_mant)
    val = exact_pow2(e_field + e_min) * (1.0 + m_field.float() / n_mant_scale)
    val = torch.where((e_field == 0) & (m_field == 0), torch.zeros_like(val), val)
    val = torch.where(sign_bit == 1, -val, val)
    return val.to(dtype)


def af_encode_static(x: torch.Tensor, e_min: int, fmt: AFFormat = AFFormat()) -> torch.Tensor:
    """Encode with a STATIC exponent bias (no per-tensor scale stored): the
    AF8 KV cache, whose dynamic range the config fixes (``kv_af8_e_min``)
    instead of a bias per written column."""
    amax = torch.tensor(2.0 ** (e_min + fmt.n_levels_exp - 1), dtype=torch.float32)
    codes, _ = af_encode(x, fmt, amax=amax * 1.5)   # amax inside the top binade
    return codes


def af_decode_static(codes: torch.Tensor, e_min: int, fmt: AFFormat = AFFormat(),
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return af_decode(codes, e_min, fmt, dtype)


def quantize_pytree(params: Any, fmt: AFFormat = AFFormat(),
                    predicate: Optional[Callable[[str, Any], bool]] = None) -> Any:
    """Quantize-dequantize every float leaf of a tree (a bias per leaf).

    ``predicate(path, leaf) -> bool`` can exclude leaves (e.g. layernorm
    params); ``path`` is the leaf's keystr path, ``"['layer']['norm1']['scale']"``.
    The result is plain tensors (no autograd history)."""
    def q(path, leaf):
        if torch.is_tensor(leaf) and leaf.is_floating_point() and (predicate is None or predicate(path, leaf)):
            return af_quantize(leaf.detach(), fmt)
        return leaf

    return tree_map_with_path(q, params)


def encode_pytree(params: Any, fmt: AFFormat = AFFormat()) -> Any:
    """Every float leaf to ``(codes, e_min)``: the on-eNVM storage form."""
    return tree_map_with_path(
        lambda _, leaf: af_encode(leaf.detach(), fmt)
        if torch.is_tensor(leaf) and leaf.is_floating_point() else leaf,
        params)
