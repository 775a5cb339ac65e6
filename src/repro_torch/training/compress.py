"""Gradient compression for the data-parallel all-reduce (the port of
``repro/training/compress.py``).

int8 uniform quantization with ERROR FEEDBACK: each worker quantizes
(grad + residual) to int8 against a globally agreed scale (the all-reduce
MAX of |g|), all-reduces the int8 code (widened to int32 to accumulate:
the 4x wire saving is the int8 payload, the reduction itself runs on the
widened type), dequantizes, and carries the quantization error into the
next step.  Error feedback keeps SGD/Adam convergence unbiased
(Karimireddy et al. 2019).

The collectives run on the process group ``group`` the caller passes (the
data-parallel ranks: ``DeviceMesh.get_group("data")`` or the default
group); ``torch.distributed`` must be initialised.  The float32 operations
are the JAX package's, in its order, with every divisor a float32 tensor on
the grads' device (a Python-scalar divisor is applied on the card as a
multiply by its reciprocal, which rounds otherwise), so the mean and the
residual are the JAX package's bit for bit.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.common.util import tree_map, tree_map_with_path


class EFState(NamedTuple):
    residual: Any    # same structure as grads, fp32


def ef_init(grads_shape: Any) -> EFState:
    """Zero float32 residuals shaped like ``grads_shape``'s leaves, on their
    devices."""
    return EFState(residual=tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                                     grads_shape))


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def compressed_psum(
    grads: Any,
    ef: EFState,
    group: Optional[dist.ProcessGroup],
    n_devices: int,
) -> Tuple[Any, EFState]:
    """All-reduce mean of ``grads`` over ``group`` (None: the default group)
    with int8 codes and error feedback: ``(mean grads in each leaf's dtype,
    EFState with the new float32 residuals)``.  Every rank of the group
    must call it with the same tree."""

    def one(g: torch.Tensor, r: torch.Tensor):
        dev = g.device
        g32 = g.float() + r
        # globally-agreed scale so dequantization is consistent
        amax = torch.max(torch.abs(g32))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax, min=1e-20) / _f32(127.0, dev)
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        new_r = g32 - q.float() * scale
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean = total.float() * scale / _f32(n_devices, dev)
        return mean.to(g.dtype), new_r

    outs = {}      # path -> (mean, residual); leaves in the same order on every rank

    def run(path, g, r):
        outs[path] = one(g, r)
        return outs[path][0]

    new_g = tree_map_with_path(run, grads, ef.residual)
    new_r = tree_map_with_path(lambda path, _: outs[path][1], grads)
    return new_g, EFState(residual=new_r)
