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
mesh and changes nothing on one device.  ``apply_moe_shardmap`` is the
expert-parallel dispatch over a ``torch.distributed`` device mesh
(``launch.mesh.use_mesh``), with the model axis's gradient rules written
out as autograd functions.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.common.device import draw_device

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
        w = torch.randn(lead + shape, generator=gen, device=draw_device(gen, device)).mul_(1.0 / math.sqrt(shape[0]))
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


def route(p: Params, xt: torch.Tensor, cfg, capacity_factor: float = 1.25,
          local_expert_range: Optional[Tuple[int, int]] = None) -> Routing:
    """Router softmax, top-k, renormalised gates, and each assignment's slot
    in its group's [E * C (+ 1 drop slot)] buffer: assignments sorted by
    expert (stable, so token order within an expert), the first C of each
    expert kept.  With ``local_expert_range`` ``(e_off, e_loc)`` (the
    expert-parallel dispatch: this rank owns experts [e_off, e_off +
    e_loc)) the buffer is [e_loc * C (+ 1)] and only the kept assignments
    to those experts get a slot; the rest go to the drop slot e_loc * C."""
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
    if local_expert_range is None:
        dest = torch.where(pos < C, se * C + pos, E * C)              # sorted order
    else:
        e_off, e_loc = local_expert_range
        se_local = se - e_off
        valid = (pos < C) & (se_local >= 0) & (se_local < e_loc)
        dest = torch.where(valid, se_local * C + pos, e_loc * C)
    slot = torch.empty_like(dest).scatter_(-1, order, dest)           # back to (token, k) order
    return Routing(probs, expert_idx, gates, slot.reshape(G, N, k), C)


def _expert_ffn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [G, E, C, d] -> [G, E, C, d], each expert's SwiGLU on its rows of
    every group (one batched matmul per weight, batched over E)."""
    G, E, C, d = x.shape
    xe = x.transpose(0, 1).reshape(E, G * C, d)
    h = F.silu(torch.bmm(xe, p["w_gate"]).float()).to(x.dtype) * torch.bmm(xe, p["w_up"])
    return torch.bmm(h, p["w_down"]).reshape(E, G, C, d).transpose(0, 1)


def _moe_tokens(p: Params, xt: torch.Tensor, cfg, capacity_factor: float = 1.25,
                local_expert_range: Optional[Tuple[int, int]] = None,
                model_group: Optional[dist.ProcessGroup] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[G, N, d] -> (y [G, N, d], the Switch aux loss per group [G]).  With
    ``local_expert_range`` only those experts' contributions (``p`` holds
    their weights alone); with ``model_group`` the gates and the tokens
    entering the expert buffer get their gradients summed over the group
    (``_ModelRegionInput``): each model rank uses them for its own
    experts."""
    G, N, d = xt.shape
    k = cfg.top_k
    n_exp = cfg.n_experts if local_expert_range is None else local_expert_range[1]
    r = route(p, xt, cfg, capacity_factor, local_expert_range)
    gates, x_in = r.gates, xt
    if model_group is not None:
        gates = _ModelRegionInput.apply(gates, model_group)
        x_in = _ModelRegionInput.apply(xt, model_group)
    n_buf = n_exp * r.capacity
    slot = r.slot.reshape(G, N * k)
    g_idx = torch.arange(G, device=xt.device)[:, None]

    # gather to [G, E, C, d]: every kept assignment has a slot of its own;
    # the dropped ones all write the drop slot, which is never read
    buf = xt.new_zeros(G, n_buf + 1, d)
    buf[g_idx, slot] = x_in.repeat_interleave(k, dim=1)
    out = _expert_ffn(p, buf[:, :n_buf].reshape(G, n_exp, r.capacity, d)).reshape(G, n_buf, d)
    out = torch.cat([out, xt.new_zeros(G, 1, d)], dim=1)

    # combine: each token's k outputs (the drop slot's zeros for a dropped
    # one), gated, summed in slot order
    contrib = (out[g_idx, slot] * gates.reshape(G, N * k, 1).to(xt.dtype)).reshape(G, N, k, d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]

    if "shared" in p:
        y = y + _shared_expert(p["shared"], xt)

    E = cfg.n_experts
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


def _shared_expert(sp: Params, xt: torch.Tensor) -> torch.Tensor:
    """qwen2-moe's dense shared expert with its sigmoid gate, on every token."""
    h = F.silu((xt @ sp["w_gate"]).float()).to(xt.dtype) * (xt @ sp["w_up"])
    sgate = torch.sigmoid((xt @ sp["gate_proj"]).float()).to(xt.dtype)
    return sgate * (h @ sp["w_down"])


# ---------------------------------------------------------------------------
# Expert parallelism over a device mesh
# ---------------------------------------------------------------------------
#
# Under this layout activations are replicated along the model axis and the
# loss is the same on every model rank: it counts once, and every model
# rank's backward must give the full gradient of its replicated leaves.
# Across the batch axes each rank's loss is its batch shard's, the global
# loss their mean, and the data-parallel step averages the gradients.  JAX
# derives the transposes from the global view; torch's collective autograd
# (``torch.distributed.nn.functional.all_reduce``) sums the cotangent in
# every backward.  That is the right transpose of the batch-axis mean
# (``_BatchMean``) and the wrong one of the model-axis sum: a replicated
# output's cotangent is already every rank's, and summing it again
# multiplies the expert gradients by the model axis's size.  So the model
# axis takes the Megatron pair below.


class _ModelRegionInput(torch.autograd.Function):
    """A replicated tensor entering the model-parallel region, where each
    model rank uses it for its own experts: identity forward; the backward
    sums the cotangents over the model group (Megatron's "f")."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


class _ModelRegionOutput(torch.autograd.Function):
    """The model ranks' partial outputs summed into the replicated output:
    the forward all-reduces over the model group; the backward is the
    identity, since the replicated output's cotangent is the same on every
    rank and is each partial's (Megatron's "g")."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class _BatchMean(torch.autograd.Function):
    """The mean of a value over the batch axes' groups (JAX's ``pmean``),
    each rank's from its own batch shard.  Its backward is the same mean of
    the cotangents: the transpose of a mean whose inputs differ by rank (and
    what torch's collective autograd would give)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, groups: tuple) -> torch.Tensor:
        ctx.groups = groups
        return _mean_over(x, groups)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _mean_over(grad, ctx.groups), None


def _mean_over(x: torch.Tensor, groups: tuple) -> torch.Tensor:
    y, n = x.contiguous().clone(), 1
    for g in groups:
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=g)
        n *= dist.get_world_size(g)
    return y / n


def shard_experts(p: Params, mesh) -> Params:
    """``p`` (a MoE layer's tree, or a whole model's) with every
    expert-stacked leaf (``w_gate``, ``w_up``, ``w_down`` under ``moe``, [...,
    E, a, b]) cut to this rank's experts [e_off : e_off + e_loc] along the
    model axis of ``mesh``; everything else as it is."""
    m = mesh.size(mesh.mesh_dim_names.index("model")) if "model" in mesh.mesh_dim_names else 1
    j = mesh.get_local_rank("model") if m > 1 else 0

    def walk(node, key=None, in_moe=False):
        if isinstance(node, dict):
            return {k: walk(v, k, in_moe or k == "moe") for k, v in node.items()}
        if in_moe and key in ("w_gate", "w_up", "w_down") and node.ndim >= 3:
            E = node.shape[-3]
            if E % m:
                raise ValueError(f"shard_experts: {E} experts do not divide the model axis ({m})")
            e_loc = E // m
            return node.narrow(node.ndim - 3, j * e_loc, e_loc).contiguous()
        return node

    return walk(p, in_moe="router" in p)


def apply_moe_shardmap(
    p: Params,
    x: torch.Tensor,               # [B_local, S, d]: this rank's batch shard
    cfg,
    capacity_factor: float = 1.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Explicit-collective expert-parallel dispatch under the current mesh
    (``launch.mesh.use_mesh``; raises without one), the JAX package's
    ``shard_map`` version.

    Every model rank routes its batch shard (identical on the model ranks)
    against the full router, keeps only the assignments that hit ITS
    experts (``p``'s ``w_gate`` / ``w_up`` / ``w_down`` hold those E / m
    experts alone: ``shard_experts``), runs them with capacity C taken from
    the local token count, and one all-reduce over the model axis merges
    the partial outputs.  The aux loss is the mean over the batch axes of
    each shard's.  qwen2's shared expert runs densely outside the region.
    Requires E % m == 0.  Gradients: see the note above
    ``_ModelRegionInput``; the aux loss, the same on every model rank, is
    computed outside the model region and counts once."""
    from repro_torch.launch.mesh import current_mesh

    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("apply_moe_shardmap needs a device mesh: call it inside launch.mesh.use_mesh(...)")
    names = mesh.mesh_dim_names
    m_size = mesh.size(names.index("model")) if "model" in names else 1
    E = cfg.n_experts
    if E % m_size:
        raise ValueError(f"expert-parallel dispatch needs experts % model == 0, got {E} % {m_size}")
    e_loc = E // m_size
    if tuple(p["w_gate"].shape[-3:-2]) != (e_loc,):
        raise ValueError(f"apply_moe_shardmap: p holds {p['w_gate'].shape[-3]} experts, this rank owns "
                         f"{e_loc}: cut them with shard_experts")
    e_off = mesh.get_local_rank("model") * e_loc if m_size > 1 else 0
    ba = tuple(a for a in cfg.sp_batch_axes if a in names)
    model_group = mesh.get_group("model") if m_size > 1 else None

    B_l, S, d = x.shape
    routed = {k: p[k] for k in ("router", "w_gate", "w_up", "w_down")}
    y, aux = _moe_tokens(routed, x.reshape(1, B_l * S, d), cfg, capacity_factor,
                         local_expert_range=(e_off, e_loc), model_group=model_group)
    if model_group is not None:
        y = _ModelRegionOutput.apply(y, model_group)
    aux = aux[0]
    if ba:
        aux = _BatchMean.apply(aux, tuple(mesh.get_group(a) for a in ba))
    y = y.reshape(B_l, S, d)
    if "shared" in p:
        y = y + _shared_expert(p["shared"], x.reshape(-1, d)).reshape(x.shape)
    return y, aux
