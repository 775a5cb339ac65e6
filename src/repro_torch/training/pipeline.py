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

Forward only, as the JAX package's tests use it; model-agnostic: it
pipelines any ``layer_fn(stage_params, h) -> h``.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist


def pipeline_forward(
    layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,          # this rank's stage's params
    x: torch.Tensor,            # [n_micro, mb, ...] microbatched input, the same on every rank
    group: Optional[dist.ProcessGroup] = None,
) -> torch.Tensor:
    """Run a GPipe forward over the ranks of ``group`` (None: the default
    group), stage = rank in the group.  Returns the [n_micro, mb, ...]
    outputs of the LAST stage, on every rank."""
    group = group if group is not None else dist.group.WORLD
    n_stages = dist.get_world_size(group)
    stage = dist.get_rank(group)
    n_micro = x.shape[0]
    if n_micro < n_stages:
        raise ValueError(f"pipeline_forward: need >= n_stages ({n_stages}) microbatches to fill the pipe, "
                         f"got {n_micro}")

    def peer(r):        # a stage's global rank, which P2P ops and broadcast take
        return dist.get_global_rank(group, r % n_stages)

    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(n_micro + n_stages - 1):
        h_in = x[min(t, n_micro - 1)] if stage == 0 else buf
        h_out = layer_fn(stage_params, h_in)
        # pass to the next stage (the last stage's output wraps, unused)
        if n_stages > 1:
            buf = torch.empty_like(h_out)
            ops = [dist.P2POp(dist.isend, h_out.contiguous(), peer(stage + 1), group),
                   dist.P2POp(dist.irecv, buf, peer(stage - 1), group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        else:
            buf = h_out
        # the last stage commits its result for microbatch t - (S - 1)
        commit = t - (n_stages - 1)
        if commit >= 0 and stage == n_stages - 1:
            outs[commit] = h_out
    dist.broadcast(outs, src=peer(n_stages - 1), group=group)
    return outs
