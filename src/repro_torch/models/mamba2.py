"""Mamba2 (SSD, state-space duality) block, the port of
``repro/models/mamba2.py``.

Recurrence per head h with state S_t in R^{P x N} (P the head dim, N
``ssm_state``):

    S_t = exp(a_h dt_t) S_{t-1} + dt_t x_t B_t^T
    y_t[p] = sum_n S_t[p, n] C_t[n]
    out = y + D x

The one-token recurrence (``_ssd_step``) is the decode path; the chunked
form (``_ssd_chunked``: a causal [Q, Q] decay within each chunk, its
upper triangle's exponent set to -inf before the ``exp``, and the states
carried between chunks in float32) is what ``Model.prefill`` and the
training forward run, with the JAX package's zero padding to a multiple of
the chunk.  The JAX block exponentiates first and masks after, which gives
the same forward but NaN gradients wherever the upper triangle's ``exp``
overflows; the port's order keeps them finite.

No Pallas kernel runs in the JAX block, so everything here stays torch ops.
``a_log``, ``dt_bias`` and ``d_skip`` are float32 whatever the config's
dtype, as in the JAX tree; the SSM state leaves a call in the activation
dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.models.rwkv6 import _dense   # the JAX package's dense_init draw, with leading dims

Params = Dict[str, Any]

CONV_K = 4  # depthwise causal conv width (mamba default)


def d_inner(cfg) -> int:
    return 2 * cfg.d_model


def n_ssm_heads(cfg) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def init_mamba2(cfg, gen: torch.Generator, device, dtype: torch.dtype, lead: Sequence[int] = ()) -> Params:
    """The JAX package's ``init_mamba2`` tree, each leaf with the leading dims
    ``lead`` (``(n_layers,)`` for the stacked blocks): ``w_in`` [d, 2 di +
    2 N + H] (z, x, B, C, dt), ``conv_w`` [4, di + 2 N] at scale 0.5, ``a_log``
    = log(linspace(1, 16, H)), ``dt_bias`` 0 and ``d_skip`` 1 (the last three
    float32), ``w_out`` [di, d]."""
    d, di, H, N = cfg.d_model, d_inner(cfg), n_ssm_heads(cfg), cfg.ssm_state
    lead = tuple(lead)
    f32 = torch.float32
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=f32)).to(device)
    return {
        "w_in": _dense(gen, lead, (d, 2 * di + 2 * N + H), device, dtype),
        "conv_w": _dense(gen, lead, (CONV_K, di + 2 * N), device, dtype, scale=0.5),
        "a_log": a_log.expand(lead + (H,)).clone(),
        "dt_bias": torch.zeros(lead + (H,), dtype=f32, device=device),
        "d_skip": torch.ones(lead + (H,), dtype=f32, device=device),
        "w_out": _dense(gen, lead, (di, d), device, dtype),
    }


def _ssd_chunked(x, dt, a, Bm, Cm, chunk: int, init_state: Optional[torch.Tensor] = None):
    """Chunked SSD.  x [B, S, H, P], dt [B, S, H] (softplus'd, > 0), a [H]
    (negative decay rates), Bm and Cm [B, S, N], init_state [B, H, P, N] or
    None (zeros).  Returns (y [B, S, H, P], final state [B, H, P, N]), both
    in x's dtype."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm))
    nc, Q = (S + pad) // chunk, chunk
    xs = x.reshape(B, nc, Q, H, P)
    dts = dt.reshape(B, nc, Q, H)
    Bs, Cs = Bm.reshape(B, nc, Q, N), Cm.reshape(B, nc, Q, N)

    # log-decay per step and its within-chunk cumulative sum (<= 0)
    cum = torch.cumsum(a * dts, dim=2)                               # [B, nc, Q, H]
    chunk_total = cum[:, :, -1]                                      # [B, nc, H]

    # intra-chunk: y[q] = sum_{s <= q} C_q.B_s exp(cum_q - cum_s) dt_s x_s
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]              # [B, nc, Q(q), Q(s), H]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # masked before exp: exp(-inf) is exactly 0, and no overflowing exp
    # meets a zero cotangent in the backward (0 * inf = NaN)
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg, float("-inf")))
    cb = torch.einsum("bcqn,bcsn->bcqs", Cs, Bs)
    w = cb[..., None] * decay * dts[:, :, None, :, :]                # [B, nc, Q, Q, H]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", w, xs)

    # chunk-end states: S_c = sum_s exp(cum_Q - cum_s) dt_s x_s B_s^T
    state_decay = torch.exp(chunk_total[:, :, None, :] - cum)        # [B, nc, Q, H]
    su = torch.einsum("bcqh,bcqhp,bcqn->bchpn", state_decay * dts, xs, Bs)

    # the scan over chunks in float32, keeping the state BEFORE each chunk
    prev = (torch.zeros((B, H, P, N), dtype=x.dtype, device=x.device) if init_state is None
            else init_state).float()
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = prev * torch.exp(chunk_total[:, c])[:, :, None, None] + su[:, c].float()
    prev_states = torch.stack(prevs, dim=1)                          # [B, nc, H, P, N]

    # inter-chunk: y[q] += C_q (exp(cum_q) S_prev)^T
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cs, prev_states, torch.exp(cum))
    y = (y_intra + y_inter).reshape(B, nc * Q, H, P)[:, :S]
    return y.to(x.dtype), prev.to(x.dtype)


def _ssd_step(state, x, dt, a, Bm, Cm):
    """The one-token recurrence (decode): state [B, H, P, N], x [B, H, P],
    dt [B, H], a [H], Bm and Cm [B, N] -> (state, y [B, H, P])."""
    decay = torch.exp(a[None, :] * dt)                                # [B, H]
    state = state * decay[:, :, None, None] + (dt[:, :, None] * x)[..., None] * Bm[:, None, None, :]
    return state, torch.einsum("bhpn,bn->bhp", state, Cm)


def apply_mamba2(
    p: Params,
    u: torch.Tensor,                              # [B, S, d]
    cfg,
    *,
    conv_state: Optional[torch.Tensor] = None,    # [B, CONV_K - 1, di + 2 N] (decode)
    ssm_state: Optional[torch.Tensor] = None,     # [B, H, P, N]
    decode: bool = False,
):
    """The mixer.  Returns (out [B, S, d], (new_conv_state, new_ssm_state)).
    In decode the conv runs over the state's 3 rows and the new rows, and
    the new conv state is the window's last 3 rows; otherwise the input is
    zero-padded and the new conv state is the last 3 raw ``xbc`` rows (None
    for fewer than 3 tokens, as in the JAX package).  One decode token takes
    the recurrence, longer inputs the chunked form from ``ssm_state`` (zeros
    when None)."""
    B, S, _ = u.shape
    di, H, N, P = d_inner(cfg), n_ssm_heads(cfg), cfg.ssm_state, cfg.ssm_head_dim
    proj = u @ p["w_in"]
    # split: z [0:di] | xbc [di : 2di+2N] | dt [2di+2N :]
    z = proj[..., :di]
    xbc = proj[..., di:2 * di + 2 * N]
    dt_raw = proj[..., 2 * di + 2 * N:]

    # depthwise causal conv over xbc, in float32: out[t] = sum_k w[k] in[t + k]
    if decode:
        if conv_state is None:
            raise ValueError("decode needs the conv state")
        conv_in = torch.cat([conv_state, xbc], dim=1)                 # [B, K-1+S, di+2N]
        new_conv = conv_in[:, -(CONV_K - 1):]
    else:
        conv_in = F.pad(xbc, (0, 0, CONV_K - 1, 0))
        new_conv = xbc[:, -(CONV_K - 1):] if S >= CONV_K - 1 else None
    cw = p["conv_w"].float()
    n_out = conv_in.shape[1] - CONV_K + 1
    conv_out = conv_in[:, :n_out].float() * cw[0]
    for k in range(1, CONV_K):
        conv_out = conv_out + conv_in[:, k:k + n_out].float() * cw[k]
    conv_out = F.silu(conv_out).to(u.dtype)

    x_part = conv_out[..., :di].reshape(B, -1, H, P)
    Bm = conv_out[..., di:di + N]
    Cm = conv_out[..., di + N:]
    dt = torch.logaddexp(dt_raw.float() + p["dt_bias"], torch.zeros((), device=u.device))   # softplus
    a = -torch.exp(p["a_log"])

    if decode and S == 1:
        if ssm_state is None:
            raise ValueError("a decode step needs the ssm state")
        new_state, y = _ssd_step(ssm_state.float(), x_part[:, 0].float(), dt[:, 0], a,
                                 Bm[:, 0].float(), Cm[:, 0].float())
        y = y[:, None]
    else:
        y, new_state = _ssd_chunked(x_part.float(), dt, a, Bm.float(), Cm.float(), cfg.ssm_chunk,
                                    init_state=ssm_state)

    y = y + p["d_skip"][None, None, :, None] * x_part.float()
    y = y.reshape(B, -1, di).to(u.dtype)
    y = y * F.silu(z.float()).to(u.dtype)
    return y @ p["w_out"], (new_conv, new_state.to(u.dtype))
