"""The layers' building blocks, the port of the parts of
``repro/models/layers.py`` that the albert classifier and the dense and MoE
decoders run: LayerNorm and RMS norm, rotary positions, span-aware
attention (chunked online softmax, with the qkv biases where the tree has
them) with or without a KV cache (float32 or AF8 codes), and the GELU and
SwiGLU MLPs.

``use_kernels=True`` routes the eligible ops to the hand-written kernels
through ``kernels.dispatch`` under the JAX package's eligibility rules;
``False`` keeps the reference ops, which repeat the JAX package's op for op.
RMS norm has no kernel in either package, and KV-cache decode attention
stays on the reference ops (the JAX package fuses the cache update and the
AF8 codec with it).  The other activations and cross-attention come with
the slices that need them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.adaptive_span import clip01
from repro_torch.core.adaptivfloat import af_decode_static, af_encode_static
from repro_torch.kernels import dispatch

Params = Dict[str, Any]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Norms (paper §V-D3 computes LN as E[X^2]-E[X]^2 running moments)
# ---------------------------------------------------------------------------


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-6,
               use_kernels: bool = False, kind: str = "layernorm") -> torch.Tensor:
    """LayerNorm with E[X^2] - E[X]^2 variance (the albert family's norm),
    or with ``kind="rms"`` RMS norm (the dense decoder's; no kernel, as in
    the JAX package, so ``use_kernels`` does not apply to it)."""
    if kind == "rms":
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)
    if use_kernels:
        return dispatch.layernorm(x, p["scale"], p["norm_bias"], eps=eps)
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["norm_bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, S, n, head_dim]; positions: [S], or [B, S] (one row of
    positions per lane)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # [hd/2]
    angles = positions.to(x.device, torch.float32)[..., :, None] * freqs   # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                         # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, soft span, chunked online softmax)
# ---------------------------------------------------------------------------


def _soft_span_block_mask(z: torch.Tensor, ramp: int, q_pos: torch.Tensor,
                          k_pos: torch.Tensor, causal: bool) -> torch.Tensor:
    """[H, qb, kb] soft span mask for one (q block, kv block) pair (clipped
    with ``jnp.clip``'s gradient at the bounds: ``clip01``)."""
    d = q_pos[:, None] - k_pos[None, :]
    if not causal:
        d = d.abs()
    return clip01((ramp + z.float()[:, None, None] - d[None].float()) / float(ramp))


def _key_mask(k_pos: torch.Tensor, kv_len: Optional[torch.Tensor], Sk: int) -> torch.Tensor:
    """[B or 1, 1, kb] keys below each row's valid length."""
    if kv_len is None:
        return (k_pos < Sk)[None, None, :]
    return k_pos[None, None, :] < kv_len.reshape(-1, 1, 1)


def attention(
    q: torch.Tensor,              # [B, Sq, H, hd]
    k: torch.Tensor,              # [B, Sk, KV, hd]
    v: torch.Tensor,              # [B, Sk, KV, hd]
    *,
    causal: bool,
    span_z: Optional[torch.Tensor] = None,    # [H] soft spans
    span_ramp: int = 32,
    q_block: int = 512,
    kv_block: int = 1024,
    kv_len: Optional[Any] = None,             # [B] (or scalar) valid keys per row
    q_offset: Any = 0,                        # [B] (or scalar) position of q[:, 0]
) -> torch.Tensor:
    """Chunked online-softmax attention (the reference twin of the span
    kernel).  Returns [B, Sq, H, hd].  ``kv_len`` and ``q_offset`` (the
    decode step's cache position) are per batch row: the JAX package
    ``vmap``s a one-lane body with scalars, the port writes the lane axis
    out."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    kvl = None if kv_len is None else torch.as_tensor(kv_len, device=dev).reshape(-1)
    q_off = torch.as_tensor(q_offset, device=dev).reshape(-1, 1)      # [B or 1, 1]
    if span_z is not None and q_off.shape[0] > 1:
        raise NotImplementedError("soft spans with a query offset per lane are not ported")
    qf = (q.float() * scale).reshape(B, Sq, KV, G, hd)
    kf, vf = k.float(), v.float()

    if Sq <= 16:
        # short fast path: one masked softmax over the whole key range
        s = torch.einsum("bqkgd,bskd->bqkgs", qf, kf)
        q_pos = q_off + torch.arange(Sq, device=dev)                   # [B or 1, Sq]
        k_pos = torch.arange(Sk, device=dev)
        valid = _key_mask(k_pos, kvl, Sk)
        if causal:
            valid = valid & (q_pos[:, :, None] >= k_pos[None, None, :])
        valid = valid.expand(B, Sq, Sk)
        s = torch.where(valid[:, :, None, None, :], s, float("-inf"))
        if span_z is not None:
            sm = _soft_span_block_mask(span_z, span_ramp, q_pos[0], k_pos, causal)
            sm = sm.reshape(KV, G, Sq, Sk).permute(2, 0, 1, 3)
            s = s + torch.log(sm.clamp_min(1e-20))[None]
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        l = p.sum(dim=-1, keepdim=True)
        p = p / l.clamp_min(1e-20)
        out = torch.einsum("bqkgs,bskd->bqkgd", p, vf)
        return out.reshape(B, Sq, H, hd).to(q.dtype)

    q_block, kv_block = min(q_block, Sq), min(kv_block, Sk)
    n_qb, n_kb = _ceil_div(Sq, q_block), _ceil_div(Sk, kv_block)
    qf = F.pad(qf, (0, 0, 0, 0, 0, 0, 0, n_qb * q_block - Sq))
    kf = F.pad(kf, (0, 0, 0, 0, 0, n_kb * kv_block - Sk))
    vf = F.pad(vf, (0, 0, 0, 0, 0, n_kb * kv_block - Sk))
    outs = []
    for qb in range(n_qb):
        q_tile = qf[:, qb * q_block:(qb + 1) * q_block]
        q_pos = q_off + qb * q_block + torch.arange(q_block, device=dev)   # [B or 1, qb]
        m_run = torch.full((B, q_block, KV, G), float("-inf"), device=dev)
        l_run = torch.zeros((B, q_block, KV, G), device=dev)
        acc = torch.zeros((B, q_block, KV, G, hd), device=dev)
        for kb in range(n_kb):
            k_tile = kf[:, kb * kv_block:(kb + 1) * kv_block]
            v_tile = vf[:, kb * kv_block:(kb + 1) * kv_block]
            k_pos = kb * kv_block + torch.arange(kv_block, device=dev)
            s = torch.einsum("bqkgd,bskd->bqkgs", q_tile, k_tile)
            mask = _key_mask(k_pos, kvl, Sk)
            if causal:
                mask = mask & (q_pos[:, :, None] >= k_pos[None, None, :])
            mask = mask.expand(B, q_block, kv_block)
            s = torch.where(mask[:, :, None, None, :], s, float("-inf"))
            if span_z is not None:
                sm = _soft_span_block_mask(span_z, span_ramp, q_pos[0], k_pos, causal)
                sm = sm.reshape(KV, G, q_block, kv_block).permute(2, 0, 1, 3)
                # the span modulates probabilities: log(mask) before the softmax
                s = s + torch.log(sm.clamp_min(1e-20))[None]
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
            run_ok = torch.isfinite(m_run)
            corr = torch.exp(torch.where(run_ok, m_run - m_safe, torch.full_like(m_run, float("-inf"))))
            corr = torch.where(run_ok, corr, torch.zeros_like(corr))
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bqkgs,bskd->bqkgd", p, v_tile)
            m_run = m_new
        outs.append(acc / l_run.clamp_min(1e-20)[..., None])
    out = torch.cat(outs, dim=1).reshape(B, n_qb * q_block, H, hd)
    return out[:, :Sq].to(q.dtype)


def attention_layer(
    p: Params,
    x: torch.Tensor,              # [B, S, d]
    cfg,
    *,
    causal: bool,
    positions: Optional[torch.Tensor] = None,  # [S] or [B, S] (rope)
    span_z: Optional[torch.Tensor] = None,
    span_ramp: int = 32,
    kv_len: Optional[Any] = None,            # [B] valid key length (right padding)
    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,   # (k, v) [B, Smax, KV, hd]
    cache_pos: Any = None,                   # [B] (or scalar) write position per lane
    use_kernels: bool = False,
) -> torch.Tensor:
    """Self-attention with the output projection.

    Cache-free (the classifier): with ``use_kernels`` and no soft spans,
    attention goes to the span kernel (full window, per-row kv_len) as in
    the JAX package (its ``attention_layer`` eligibility test); soft spans
    keep the reference.

    With ``cache`` (decode and prefill): the new keys and values are written
    into the cache tensors IN PLACE at each lane's ``cache_pos`` (the JAX
    package returns an updated copy; the port saves the copy of a cache
    that is the decoder's largest state), as float or, for a uint8 cache,
    AF8 codes with the config's static bias (``kv_af8_e_min``), the whole
    cache then decoded for the attention.  The queries sit at ``cache_pos``
    and see ``cache_pos + S`` keys.  Like the JAX package's
    ``dynamic_update_slice``, a write that would run past the cache's end is
    moved back to end there.  Cache attention stays on the reference ops."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:                 # qkv_bias (qwen2-moe): added before RoPE
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.pos == "rope":
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        if use_kernels and span_z is None:
            out = dispatch.dense_attention(q, k, v, causal=causal, kv_len=kv_len)
        else:
            out = attention(q, k, v, causal=causal, span_z=span_z, span_ramp=span_ramp, kv_len=kv_len)
        return out.reshape(B, S, H * hd) @ p["wo"]

    if kv_len is not None:
        raise ValueError("kv_len is derived from the cache")
    ck, cv = cache
    pos = torch.as_tensor(cache_pos, device=x.device).reshape(-1)     # [B] or [1]
    start = pos.expand(B).clamp(0, ck.shape[1] - S)
    cols = start[:, None] + torch.arange(S, device=x.device)          # [B, S]
    rows = torch.arange(B, device=x.device)[:, None]
    if ck.dtype == torch.uint8:
        e_min = cfg.kv_af8_e_min
        ck[rows, cols] = af_encode_static(k.float(), e_min)
        cv[rows, cols] = af_encode_static(v.float(), e_min)
        k = af_decode_static(ck, e_min, dtype=x.dtype)
        v = af_decode_static(cv, e_min, dtype=x.dtype)
    else:
        ck[rows, cols] = k.to(ck.dtype)
        cv[rows, cols] = v.to(cv.dtype)
        k, v = ck, cv
    out = attention(q, k, v, causal=causal, span_z=span_z, span_ramp=span_ramp,
                    kv_len=pos + S, q_offset=pos)
    return out.reshape(B, S, H * hd) @ p["wo"]


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def apply_mlp(
    p: Params, x: torch.Tensor,
    use_kernels: bool = False,
    block_masks: Optional[Dict[str, Any]] = None,   # dispatch.mlp_block_masks
    act: str = "gelu",
) -> torch.Tensor:
    """w_up -> gelu (tanh form, jax.nn.gelu's default) -> w_down, or with
    ``act="swiglu"`` silu(x @ w_gate) * (x @ w_up) -> w_down; with
    ``use_kernels`` a block-pruned weight goes to the block-sparse kernel."""
    def mm(h_, name):
        if use_kernels and block_masks and block_masks.get(name) is not None:
            return dispatch.sparse_matmul(h_, p[name], block_masks[name])
        return h_ @ p[name]

    if act == "swiglu":
        h = F.silu(mm(x, "w_gate").float()).to(x.dtype) * mm(x, "w_up")
    elif act == "gelu":
        h = F.gelu(mm(x, "w_up").float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(f"activation {act!r} is not ported")
    return mm(h, "w_down")
