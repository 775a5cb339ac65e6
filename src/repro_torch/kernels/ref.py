"""Plain PyTorch versions of the port's six kernels.

These repeat the JAX package's oracles (``repro/kernels/ref.py``) and, for
``quantize``, the body of its Pallas kernel, op for op; ``offramp_head`` is
the off-ramp the paths run around ``softmax_entropy`` (pooler, classifier,
softmax and entropy, retire).  Each kernel wrapper takes its plain version
for a CPU tensor; on the card ``chip_smoke.py`` and the CUDA tests hold
each kernel against these.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.adaptivfloat import AFFormat, af_decode, exact_pow2, floor_log2
from repro_torch.core.early_exit import OfframpParams, offramp_logits


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6):
    """Row LayerNorm, variance as E[X^2]-E[X]^2 (paper Eq. 5), fp32 math."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def softmax_entropy(
    logits: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row softmax (mask multiplied into the probs, not renormalised) and the
    entropy of the unmasked distribution, clamped at 0."""
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True)
    z = x - m
    e = torch.exp(z)
    s = e.sum(dim=-1, keepdim=True)
    probs = e / s
    ent = torch.log(s[..., 0]) - (z * e).sum(dim=-1) / s[..., 0]
    if mask is not None:
        probs = probs * mask.float()
    return probs.to(logits.dtype), ent.clamp_min(0.0)


def offramp_head(
    h: torch.Tensor,                # [B, S, D]; the CLS rows h[:, 0, :] are read
    pooler_w: torch.Tensor,         # [D, D] fp32, or uint8 AF codes
    pooler_b: torch.Tensor,         # [D]
    cls_w: torch.Tensor,            # [D, C] fp32, or uint8 AF codes
    cls_b: torch.Tensor,            # [C]
    active: Optional[torch.Tensor] = None,   # [B] bool; None = all active
    threshold: float = 0.0,
    e_min: Optional[Tuple[int, int]] = None,  # (pooler, cls) biases of AF codes
    fmt: AFFormat = AFFormat(),
) -> torch.Tensor:
    """The off-ramp after a layer: ``offramp_logits``, then
    ``softmax_entropy``, then retire = active & (entropy < threshold),
    packed into [B, C + 2] fp32 rows [logits | entropy | retire as 1.0 /
    0.0].  With ``e_min`` the weights are AF codes, decoded first."""
    if e_min is not None:
        pooler_w = af_decode(pooler_w, e_min[0], fmt, dtype=torch.float32)
        cls_w = af_decode(cls_w, e_min[1], fmt, dtype=torch.float32)
    lg = offramp_logits(h, OfframpParams(pooler_w, pooler_b, cls_w, cls_b))
    _, ent = softmax_entropy(lg)
    retire = ent < threshold
    if active is not None:
        retire = active & retire
    return torch.cat([lg.float(), ent[:, None], retire[:, None].float()], dim=1)


def af_matmul(
    x: torch.Tensor,          # [M, K] float
    w_codes: torch.Tensor,    # [K, N] uint8 AF codes
    e_min: int,
    fmt: AFFormat = AFFormat(),
) -> torch.Tensor:
    """x @ decode(codes): fp32 accumulate, fp32 out."""
    w = af_decode(w_codes, e_min, fmt, dtype=torch.float32)
    return x.float() @ w


def quantize(
    x: torch.Tensor,                # [rows, d]
    e_min: torch.Tensor,            # [groups] int32 per-group exponent bias
    rows_per_group: int,
    fmt: AFFormat = AFFormat(),
) -> torch.Tensor:
    """AdaptivFloat quantize-dequantize with one bias per group of
    ``rows_per_group`` rows: the algebra of the Pallas kernel's
    ``_quant_body`` (``floor(log2)`` in XLA's ``log(x) * f32(1/ln 2)`` form,
    exact powers of two, round half to even)."""
    rows, d = x.shape
    xf = x.float()
    n_mant_scale = float(2 ** fmt.n_mant)
    e_lo = e_min.to(xf.device, torch.float32).repeat_interleave(rows_per_group)[:rows, None]
    e_hi = e_lo + (fmt.n_levels_exp - 1)
    a = xf.abs()
    sign = torch.sign(xf)
    safe_a = a.clamp_min(1e-38)
    e = torch.minimum(torch.maximum(floor_log2(safe_a), e_lo), e_hi)
    scale = exact_pow2(e)
    mant = torch.round(a / scale * n_mant_scale) / n_mant_scale
    val = mant * scale
    max_val = (2.0 - 1.0 / n_mant_scale) * exact_pow2(e_hi)
    val = torch.minimum(val, max_val)
    min_pos = exact_pow2(e_lo) * (1.0 + 1.0 / n_mant_scale)
    val = torch.where(a < 0.5 * min_pos, torch.zeros_like(val), torch.maximum(val, min_pos))
    return (sign * val).to(x.dtype)


def block_sparse_matmul(
    x: torch.Tensor,                # [M, K]
    w: torch.Tensor,                # [K, N], zero outside occupied blocks
    block_mask,                     # [K // bk, N // bn] bool occupancy
    bk: int,
    bn: int,
) -> torch.Tensor:
    """x @ (w restricted to its occupied blocks), fp32 out."""
    mask = torch.as_tensor(block_mask, device=w.device)
    mask = mask.repeat_interleave(bk, dim=0).repeat_interleave(bn, dim=1)
    w_masked = w * mask[: w.shape[0], : w.shape[1]].to(w.dtype)
    return x.float() @ w_masked.float()


def span_attention(
    q: torch.Tensor,          # [B, H, Sq, dh]
    k: torch.Tensor,          # [B, KV, Sk, dh]
    v: torch.Tensor,          # [B, KV, Sk, dh]
    spans: torch.Tensor,      # [H] int; 0 = head fully off
    *,
    causal: bool,
    kv_lens: Optional[torch.Tensor] = None,   # [B, H] (or broadcastable)
                                              # valid keys per row
) -> torch.Tensor:
    """Hard-span attention: key j is visible to query i when
    ``0 <= i-j < span`` (causal) or ``|i-j| < span`` (bidirectional), and
    ``j < kv_len``.  A row with no visible key returns zeros."""
    B, H, Sq, dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(dh)
    kk = k.repeat_interleave(G, dim=1).float()
    vv = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kk)
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    d = qi - kj
    if not causal:
        d = d.abs()
    sp = spans.to(q.device).long()[:, None, None]
    ok = d[None] < sp
    if causal:
        ok = ok & (d[None] >= 0)
    ok = ok[None]                                             # [1, H, Sq, Sk]
    if kv_lens is not None:
        kvl = torch.as_tensor(kv_lens, device=q.device).long()
        ok = ok & (kj[None, None] < kvl.reshape(-1, H)[..., None, None])
    s = torch.where(ok, s, float("-inf"))
    row_any = ok.any(dim=-1)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l.clamp_min(1e-20), vv)
    o = torch.where(row_any[..., None], o, torch.zeros_like(o))
    return o.to(q.dtype)
