"""RWKV6 "Finch" block, the port of ``repro/models/rwkv6.py``: the
attention-free time mix with a data-dependent decay, and the channel mix.

Per head (k-dim = v-dim = head_dim):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state in R^{K x V})
    y_t = ((S_{t-1} + diag(u) k_t v_t^T)^T r_t)

with w_t = exp(-exp(w0 + lora_w(x_t))) in (0, 1).  The exact recurrent scan
is the decode path; the chunked form (intra-chunk products with the decay
folded into r and k, a scan over the chunk-end states) is what
``Model.prefill`` runs, with the JAX package's zero padding at decay 1, its
``log(max(w, 1e-38))`` and its ``exp(min(-cum, 40))`` clamp.

No Pallas kernel runs in the JAX block, so everything here stays torch ops:
the per-head group norm of the WKV output takes a two-pass variance (mean,
then the mean of squared deviations, as ``jnp.var`` does), not the
E[X^2] - E[X]^2 form of the layernorm kernel.  ``decay_base``, ``bonus_u``
and ``ln_x_scale`` are float32 whatever the config's dtype, as in the JAX
tree, and so is the WKV state.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.common.device import draw_device

Params = Dict[str, Any]

LORA_R = 32


def _dense(gen: torch.Generator, lead: tuple, shape: Sequence[int], device, dtype, scale=None) -> torch.Tensor:
    """A normal draw of ``lead + shape`` at the JAX ``dense_init`` scale (1 /
    sqrt of the first dim of ``shape``), scaled in place."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(lead + tuple(shape), generator=gen, device=draw_device(gen, device)).mul_(scale)
    return w.to(device, dtype)


def init_rwkv6(cfg, gen: torch.Generator, device, dtype: torch.dtype, lead: Sequence[int] = ()) -> Params:
    """The JAX package's ``init_rwkv6`` tree, each leaf with the leading dims
    ``lead`` (``(n_layers,)`` for the stacked layers)."""
    d, H, K = cfg.d_model, cfg.n_heads, cfg.head_dim
    lead = tuple(lead)

    def dense(*shape):
        return _dense(gen, lead, shape, device, dtype)

    f32 = torch.float32
    return {
        "w_r": dense(d, d), "w_k": dense(d, d), "w_v": dense(d, d), "w_g": dense(d, d), "w_o": dense(d, d),
        "decay_lora_a": dense(d, LORA_R),
        "decay_lora_b": dense(LORA_R, d),
        "decay_base": torch.full(lead + (d,), -6.0, dtype=f32, device=device),
        "bonus_u": _dense(gen, lead, (H, K), device, f32, scale=0.1),
        "mix_rkvg": torch.full(lead + (4, d), 0.5, dtype=dtype, device=device),
        "ts_lora_a": dense(d, LORA_R),
        "ts_lora_b": dense(LORA_R, 4 * d),
        "ln_x_scale": torch.ones(lead + (d,), dtype=f32, device=device),
    }


def _wkv_recurrent(r, k, v, w, u, init_state=None):
    """The exact scan.  r, k, v, w: [B, S, H, K] (w the decay in (0, 1));
    u: [H, K].  Returns y [B, S, H, K] and the final state [B, H, K, K]
    (state[k_dim, v_dim]), float32."""
    B, S, H, K = r.shape
    state = (torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device) if init_state is None
             else init_state.float())
    r, k, v, w = (a.float() for a in (r, k, v, w))
    uu = u.float()[None, :, :, None]
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]                      # [B, H, K, K]
        ys.append(torch.einsum("bhkv,bhk->bhv", state + uu * kv, r[:, t]))
        state = state * w[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1), state


def _wkv_chunked(r, k, v, w, u, chunk: int, init_state=None):
    """The chunked-parallel WKV (flash-linear-attention style), the same
    contract as ``_wkv_recurrent``.  The decay is folded into r and k, so
    the [Q, Q] intra-chunk score is a plain product: r' = r exp(cum_{t-1})
    (<= 1) and k' = k exp(-cum_s) (>= 1, clamped at exp(40); the decays a
    chunk sees keep |cum| small)."""
    B, S, H, K = r.shape
    pad = (-S) % chunk
    if pad:
        r, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    Sp = S + pad
    nc, Q = Sp // chunk, chunk
    shp = (B, nc, Q, H, K)
    rc, kc, vc, wc = (a.reshape(shp).float() for a in (r, k, v, w))
    u = u.float()

    logw = torch.log(torch.clamp_min(wc, 1e-38))
    cum = torch.cumsum(logw, dim=2)                   # [B, nc, Q, H, K] inclusive
    tot = cum[:, :, -1]                               # [B, nc, H, K]

    # intra-chunk: step s < t contributes with decay exp(cum_{t-1} - cum_s)
    r_fold = rc * torch.exp(cum - logw)
    k_fold = kc * torch.exp(torch.clamp_max(-cum, 40.0))
    att = torch.einsum("bcqhk,bcshk->bcqsh", r_fold, k_fold)          # [B, nc, Q, Q, H]
    strict = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device), diagonal=-1)
    att = torch.where(strict[None, None, :, :, None], att, torch.zeros((), device=r.device))
    diag = (rc * u * kc).sum(dim=-1)                  # s == q, with the bonus u: [B, nc, Q, H]
    y_intra = torch.einsum("bcqsh,bcshv->bcqhv", att, vc) + diag[..., None] * vc

    # chunk-end states: S_end = S_init prod(w) + sum_s (prod_{i>s} w_i) k_s v_s
    state_decay = torch.exp(tot[:, :, None] - cum)
    su = torch.einsum("bcshk,bcshv->bchkv", kc * state_decay, vc)
    prev = (torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device) if init_state is None
            else init_state.float())
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = prev * torch.exp(tot[:, c])[..., None] + su[:, c]
    prevs = torch.stack(prevs, dim=1)                 # [B, nc, H, K, V]

    # inter-chunk: y_q += r_q exp(cum_{q-1}) S_prev
    y_inter = torch.einsum("bcqhk,bchkv->bcqhv", r_fold, prevs)
    y = (y_intra + y_inter).reshape(B, Sp, H, K)[:, :S]
    return y, prev


def _token_shift(x: torch.Tensor, last_x: Optional[torch.Tensor]) -> torch.Tensor:
    """x shifted one token back, the state's token first: [B, S, d]."""
    if last_x is None:
        last_x = torch.zeros_like(x[:, :1])
    return torch.cat([last_x.to(x.dtype), x[:, :-1]], dim=1)


def apply_rwkv6(
    p: Params,
    x: torch.Tensor,                          # [B, S, d] (already layer-normed)
    cfg,
    *,
    last_x: Optional[torch.Tensor] = None,    # [B, 1, d] token-shift state
    wkv_state: Optional[torch.Tensor] = None,  # [B, H, K, K]
    decode: bool = False,
):
    """The time mix.  Returns (out [B, S, d], (new_last_x [B, 1, d],
    new_wkv_state [B, H, K, K])); one decode token takes the exact scan,
    longer inputs the chunked form.  (The JAX function's ``chunked=False``,
    the scan for any length, has no caller and is not ported.)"""
    B, S, d = x.shape
    H, K = cfg.n_heads, cfg.head_dim
    x_prev = _token_shift(x, last_x)
    new_last_x = x[:, -1:, :]

    # data-dependent token-shift mixing
    lora = torch.tanh((x @ p["ts_lora_a"]).float()) @ p["ts_lora_b"].float()
    mix = torch.sigmoid(p["mix_rkvg"].float()[None, None] + lora.reshape(B, S, 4, d)).to(x.dtype)
    xr, xk, xv, xg = (x * mix[:, :, i] + x_prev * (1 - mix[:, :, i]) for i in range(4))

    r = (xr @ p["w_r"]).reshape(B, S, H, K)
    k = (xk @ p["w_k"]).reshape(B, S, H, K)
    v = (xv @ p["w_v"]).reshape(B, S, H, K)
    g = F.silu((xg @ p["w_g"]).float())

    # data-dependent decay
    dlora = torch.tanh((xk @ p["decay_lora_a"]).float()) @ p["decay_lora_b"].float()
    w = torch.exp(-torch.exp(p["decay_base"][None, None] + dlora)).reshape(B, S, H, K)

    u = p["bonus_u"]
    if decode and S == 1:
        y, state = _wkv_recurrent(r, k, v, w, u, init_state=wkv_state)
    else:
        y, state = _wkv_chunked(r, k, v, w, u, cfg.ssm_chunk, init_state=wkv_state)

    # per-head group norm (two-pass variance), then the gate
    mean = y.mean(dim=-1, keepdim=True)
    var = torch.square(y - mean).mean(dim=-1, keepdim=True)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = y.reshape(B, S, d) * p["ln_x_scale"][None, None]
    y = (y * g).to(x.dtype)
    return y @ p["w_o"], (new_last_x, state)


def init_channel_mix(cfg, gen: torch.Generator, device, dtype: torch.dtype, lead: Sequence[int] = ()) -> Params:
    """The JAX package's ``init_channel_mix`` tree with leading dims ``lead``."""
    d, ff = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    return {
        "mix_k": torch.full(lead + (d,), 0.5, dtype=dtype, device=device),
        "w_k": _dense(gen, lead, (d, ff), device, dtype),
        "w_v": _dense(gen, lead, (ff, d), device, dtype),
        "w_r": _dense(gen, lead, (d, d), device, dtype),
    }


def apply_channel_mix(p: Params, x: torch.Tensor, last_x: Optional[torch.Tensor] = None):
    """The channel mix: a squared-ReLU FFN on the token-shifted input, gated
    by a sigmoid receptance.  Returns (out [B, S, d], new_last_x [B, 1, d])."""
    x_prev = _token_shift(x, last_x)
    xk = x * p["mix_k"] + x_prev * (1 - p["mix_k"])
    k = torch.square(torch.relu((xk @ p["w_k"]).float()))
    kv = k.to(x.dtype) @ p["w_v"]
    rgate = torch.sigmoid((x @ p["w_r"]).float()).to(x.dtype)
    return rgate * kv, x[:, -1:, :]
