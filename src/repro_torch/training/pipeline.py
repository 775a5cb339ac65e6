"""Pipeline parallelism (PP) over a process group (the port of
``repro/training/pipeline.py``).

GPipe-style microbatch pipeline: each rank of ``group`` is one stage and
owns a contiguous block of layers; activations flow stage -> stage while
microbatches stream through, so the bubble is (S-1)/(S-1+M) of the
schedule.  The schedule is the JAX package's tick for tick: at tick t stage
0 takes microbatch min(t, M-1) and every other stage the activation its
predecessor sent at tick t-1; every stage runs its layers and sends the
result around the ring (the JAX ``ppermute``, here one
``batch_isend_irecv``: the last stage's send to stage 0 is unused, as in
JAX); the last stage commits microbatch t-(S-1).  At the end the last
stage's outputs go to every stage: JAX sums one-hot-masked outputs
(``psum``), a broadcast from the last stage gives the same bits.

Under autograd every collective takes the transpose JAX derives for its
``shard_map`` (no collective of torch's own autograd is used):

* ``_RingShift``, the ring step: its backward sends each cotangent to the
  previous stage and receives its output's from the next (the transpose of
  ``ppermute`` is the inverse permutation).  Stage 0's received activation
  enters ``torch.where`` beside its microbatch, as in JAX, so its cotangent
  (zero) still goes back round the ring to the last stage.
* ``_LastStageBroadcast``, the closing broadcast: only the last stage's
  outputs get a cotangent, its own rank's, counted once (the transpose of
  ``psum(outs * mask)`` with a replicated output; summing it over ranks
  would scale it by S).  It also takes every rank's final activation with
  a zero cotangent, so that each rank's backward walks its whole chain of
  ring steps and pairs every send with its peer's receive.
* ``_ReplicatedInput``: ``x`` is replicated (``in_specs P()``), and JAX
  sums the per-device cotangents of such an input, so its backward
  all-reduces: every rank's ``x.grad`` is stage 0's.

Each rank's ``stage_params`` gradient is its own stage's.  The layer is
model-agnostic: it pipelines any ``layer_fn(stage_params, h) -> h``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist


def _peer(group: dist.ProcessGroup, stage: int, n_stages: int) -> int:
    """A stage's global rank, which P2P ops and broadcast take."""
    return dist.get_global_rank(group, stage % n_stages)


def _exchange(send: torch.Tensor, to: int, frm: int, group: dist.ProcessGroup) -> torch.Tensor:
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send.contiguous(), to, group), dist.P2POp(dist.irecv, recv, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


class _RingShift(torch.autograd.Function):
    """Send to the next stage, receive from the previous one; the backward
    sends the cotangent the other way round."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, group: dist.ProcessGroup, stage: int, n_stages: int) -> torch.Tensor:
        ctx.group, ctx.stage, ctx.n_stages = group, stage, n_stages
        return _exchange(h, _peer(group, stage + 1, n_stages), _peer(group, stage - 1, n_stages), group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g, s, n = ctx.group, ctx.stage, ctx.n_stages
        return _exchange(grad, _peer(g, s - 1, n), _peer(g, s + 1, n), g), None, None, None


class _LastStageBroadcast(torch.autograd.Function):
    """The last stage's ``outs`` on every rank; the backward gives the last
    stage its own cotangent and every other input a zero one."""

    @staticmethod
    def forward(ctx, outs: torch.Tensor, tail: torch.Tensor, group: dist.ProcessGroup, is_last: bool,
                src: int) -> torch.Tensor:
        ctx.is_last = is_last
        y = outs.contiguous().clone()
        dist.broadcast(y, src=src, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        g_outs = grad if ctx.is_last else torch.zeros_like(grad)
        return g_outs, torch.zeros_like(grad[0]), None, None, None


class _ReplicatedInput(torch.autograd.Function):
    """The identity; the backward sums the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def pipeline_forward(
    layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,          # this rank's stage's params
    x: torch.Tensor,            # [n_micro, mb, ...] microbatched input, the same on every rank
    group: Optional[dist.ProcessGroup] = None,
) -> torch.Tensor:
    """Run a GPipe forward over the ranks of ``group`` (None: the default
    group), stage = rank in the group.  Returns the [n_micro, mb, ...]
    outputs of the LAST stage, on every rank; differentiable in
    ``stage_params`` and ``x`` (the module doc gives the transposes)."""
    group = group if group is not None else dist.group.WORLD
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    n_micro = x.shape[0]
    if n_micro < n_stages:
        raise ValueError(f"pipeline_forward: need >= n_stages ({n_stages}) microbatches to fill the pipe, "
                         f"got {n_micro}")
    if torch.is_grad_enabled() and x.requires_grad and n_stages > 1:
        x = _ReplicatedInput.apply(x, group)
    is_first = torch.tensor(stage == 0, device=x.device)
    is_last = stage == n_stages - 1

    buf = torch.zeros_like(x[0])
    committed = []
    h_out = buf
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t (if in range); the others use buf
        h_in = torch.where(is_first, x[min(t, n_micro - 1)], buf)
        h_out = layer_fn(stage_params, h_in)
        # pass to the next stage (the last stage's output wraps, unused)
        buf = _RingShift.apply(h_out, group, stage, n_stages) if n_stages > 1 else h_out
        # the last stage commits its result for microbatch t - (S - 1)
        if t >= n_stages - 1 and is_last:
            committed.append(h_out)
    outs = torch.stack(committed) if is_last else torch.zeros_like(x)
    if n_stages == 1:
        return outs
    return _LastStageBroadcast.apply(outs, h_out, group, is_last, _peer(group, n_stages - 1, n_stages))
