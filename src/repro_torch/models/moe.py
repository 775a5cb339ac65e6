"""Mixture-of-Experts layer with sort-based static-capacity dispatch, the
port of ``repro/models/moe.py``.

Each token's top-k expert assignments are sorted by expert id (a stable
sort) and gathered into a dense [E, C, d] buffer, which is batch-multiplied
against the stacked expert weights.  Assignments past an expert's capacity
C go to a drop slot and add nothing (the token's residual passes through):
GShard / Switch semantics, with the same assignments dropped as in the JAX
package.  qwen2-moe adds a dense shared expert with a sigmoid gate on every
token.

Every routing here runs over a leading group axis, ``[G, N, d]``: one
routing of N tokens per group.  The flat form is one group of all the
tokens.  The grouped form (``moe_grouped_dispatch``, or ``grouped=True``)
is one group per batch row, which is also what the JAX package's per-lane
``vmap`` computes in its serving decode.  Capacity couples the tokens of a
group, so the grouping decides which tokens can be dropped.

Two departures from the JAX code, neither in what is computed:

- the combine gathers each assignment's output back to [N, k, d] and sums
  the k slots in a fixed order, where the JAX package scatter-adds
  (``.at[st].add``): a scatter-add on the card runs on atomics, whose sum
  order changes from run to run;
- the top-k is a stable descending sort, which breaks ties toward the lower
  expert index as ``jax.lax.top_k`` does (``torch.topk`` promises no
  order).

No Pallas kernel runs in the JAX layer, so the expert products stay torch
ops (batched matmuls).  ``moe_buffer_sharded`` only pins a layout on a
mesh and changes nothing on one device.  ``apply_moe_shardmap`` needs a
device mesh and is not ported.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


def init_moe(cfg, gen: torch.Generator, device, dtype: torch.dtype, lead: Sequence[int] = ()) -> Params:
    """The JAX package's ``init_moe`` tree (``router``, ``w_gate``, ``w_up``,
    ``w_down``, and ``shared`` where the config has a shared expert), each
    leaf with the leading dims ``lead`` (``(n_layers,)`` for the stacked
    layers), drawn from ``gen`` on its device with the JAX init scales
    (1 / sqrt of the leaf's first dim; for the [E, d, ff] experts that is
    E).  The router stays float32."""
    d, ff, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    lead = tuple(lead)

    def dense(shape, dt=dtype):
        # scaled in place: a stacked expert weight is gigabytes, and a copy doubles it
        w = torch.randn(lead + shape, generator=gen, device=gen.device).mul_(1.0 / math.sqrt(shape[0]))
        return w.to(device, dt)

    p = {"router": dense((d, E), torch.float32), "w_gate": dense((E, d, ff)), "w_up": dense((E, d, ff)),
         "w_down": dense((E, ff, d))}
    if cfg.shared_expert_d_ff:
        sff = cfg.shared_expert_d_ff
        p["shared"] = {"w_gate": dense((d, sff)), "w_up": dense((d, sff)), "w_down": dense((sff, d)),
                       "gate_proj": dense((d, 1))}
    return p


def capacity(n_tokens: int, cfg, capacity_factor: float = 1.25) -> int:
    """Slots per expert for one routing of ``n_tokens`` tokens (the JAX
    package's Python arithmetic, term for term)."""
    return max(int(n_tokens * cfg.top_k * capacity_factor / cfg.n_experts), 4)


class Routing(NamedTuple):
    probs: torch.Tensor        # [G, N, E] router softmax
    expert_idx: torch.Tensor   # [G, N, k] top-k experts, most probable first
    gates: torch.Tensor        # [G, N, k] renormalised top-k probabilities
    slot: torch.Tensor         # [G, N, k] buffer row e * C + position, E * C when dropped
    capacity: int


def route(p: Params, xt: torch.Tensor, cfg, capacity_factor: float = 1.25) -> Routing:
    """Router softmax, top-k, renormalised gates, and each assignment's slot
    in its group's [E * C (+ 1 drop slot)] buffer: assignments sorted by
    expert (stable, so token order within an expert), the first C of each
    expert kept."""
    G, N, _ = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_idx = top[..., :k], idx[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    C = capacity(N, cfg, capacity_factor)
    flat_expert = expert_idx.reshape(G, N * k)
    se, order = torch.sort(flat_expert, dim=-1, stable=True)
    counts = F.one_hot(flat_expert, E).sum(1)                          # [G, E]
    starts = counts.cumsum(-1) - counts
    pos = torch.arange(N * k, device=xt.device) - starts.gather(-1, se)
    dest = torch.where(pos < C, se * C + pos, E * C)                  # sorted order
    slot = torch.empty_like(dest).scatter_(-1, order, dest)           # back to (token, k) order
    return Routing(probs, expert_idx, gates, slot.reshape(G, N, k), C)


def _expert_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [G, E, C, d] -> [G, E, C, d], each expert's SwiGLU on its rows of
    every group (one batched matmul per weight, batched over E)."""
    G, E, C, d = x.shape
    xe = x.transpose(0, 1).reshape(E, G * C, d)
    h = F.silu(torch.bmm(xe, p["w_gate"]).float()).to(x.dtype) * torch.bmm(xe, p["w_up"])
    return torch.bmm(h, p["w_down"]).reshape(E, G, C, d).transpose(0, 1)


def _moe_tokens(p: Params, xt: torch.Tensor, cfg,
                capacity_factor: float = 1.25) -> Tuple[torch.Tensor, torch.Tensor]:
    """[G, N, d] -> (y [G, N, d], the Switch aux loss per group [G])."""
    G, N, d = xt.shape
    E, k = cfg.n_experts, cfg.top_k
    r = route(p, xt, cfg, capacity_factor)
    n_buf = E * r.capacity
    slot = r.slot.reshape(G, N * k)
    g_idx = torch.arange(G, device=xt.device)[:, None]

    # gather to [G, E, C, d]: every kept assignment has a slot of its own;
    # the dropped ones all write the drop slot, which is never read
    buf = xt.new_zeros(G, n_buf + 1, d)
    buf[g_idx, slot] = xt.repeat_interleave(k, dim=1)
    out = _expert_ffn(p, buf[:, :n_buf].reshape(G, E, r.capacity, d)).reshape(G, n_buf, d)
    out = torch.cat([out, xt.new_zeros(G, 1, d)], dim=1)

    # combine: each token's k outputs (the drop slot's zeros for a dropped
    # one), gated, summed in slot order
    contrib = (out[g_idx, slot] * r.gates.reshape(G, N * k, 1).to(xt.dtype)).reshape(G, N, k, d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]

    if "shared" in p:
        sp = p["shared"]
        h = F.silu((xt @ sp["w_gate"]).float()).to(xt.dtype) * (xt @ sp["w_up"])
        sgate = torch.sigmoid((xt @ sp["gate_proj"]).float()).to(xt.dtype)
        y = y + sgate * (h @ sp["w_down"])

    me = r.probs.mean(1)                                              # [G, E]
    ce = F.one_hot(r.expert_idx[..., 0], E).float().mean(1)
    return y, E * (me * ce).sum(-1)


def apply_moe(
    p: Params,
    x: torch.Tensor,               # [B, S, d]
    cfg,
    capacity_factor: float = 1.25,
    *,
    grouped: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, d], router aux loss).  ``grouped`` (default:
    the config's ``moe_grouped_dispatch``) routes each batch row on its
    own, the aux loss then the mean over rows; otherwise all B x S tokens
    route together."""
    if cfg.moe_shardmap_dispatch:
        return apply_moe_shardmap(p, x, cfg, capacity_factor)
    if grouped is None:
        grouped = cfg.moe_grouped_dispatch
    if grouped:
        y, aux = _moe_tokens(p, x, cfg, capacity_factor)
        return y, aux.mean()
    y, aux = _moe_tokens(p, x.reshape(1, -1, x.shape[-1]), cfg, capacity_factor)
    return y.reshape(x.shape), aux[0]


def apply_moe_shardmap(p: Params, x: torch.Tensor, cfg, capacity_factor: float = 1.25):
    """The JAX package's explicit-collective expert-parallel dispatch runs
    under a device mesh, which the port does not have yet."""
    raise NotImplementedError("apply_moe_shardmap needs a device mesh: sharding is not ported "
                              "(ROADMAP Queue 1 item 2)")
