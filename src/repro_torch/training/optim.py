"""AdamW and its learning-rate schedules (the port of the JAX package's
``training/optim.py``, which writes them from scratch).

Functional, as the reference: ``state = adamw_init(params)``;
``params, state, metrics = adamw_update(grads, state, params, cfg)``
returns new tensors (no autograd history) and leaves its inputs as they
are.  Moments are float32 whatever the param dtype.  Weight decay is masked
off 1-D leaves, norms, biases and spans (``_decay_mask``, on keystr paths).
The step count, the bias corrections, the warmup and the cosine are float32
tensors on the params' device, as the reference computes them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.common.util import tree_leaves_with_path, tree_map, tree_map_with_path


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"     # cosine | linear | constant
    # span parameters move O(tens of tokens) while weights move O(1e-2):
    # Adam normalizes magnitudes away, so spans get their own LR multiplier
    # (Sukhbaatar et al. train spans with a much larger effective step)
    span_lr_mult: float = 1.0


class AdamWState(NamedTuple):
    count: torch.Tensor   # int32 scalar
    m: Any
    v: Any


def _device(tree: Any) -> torch.device:
    leaves = tree_leaves_with_path(tree)
    return leaves[0][1].device if leaves else torch.device("cpu")


def adamw_init(params: Any) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=_device(params)),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def _f32(x: float, device) -> torch.Tensor:
    # a float32 tensor on the step's device: a Python scalar divisor on the
    # card is applied as a multiply by its reciprocal, which rounds otherwise
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    dev = step.device
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), dev), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        t = ((step - cfg.warmup_steps) / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev)).clamp(0, 1)
        decay = 1.0 - t if cfg.schedule == "linear" else 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * decay


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of the per-leaf sums of squares, leaves in the
    reference's order (a float32 sum in another order differs in the last
    ulp)."""
    leaves = [torch.sum(torch.square(x.float())) for _, x in tree_leaves_with_path(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Any, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), norm


def _decay_mask(path: str, leaf) -> bool:
    """True if weight decay applies (2-D+ weights only; not norms, biases, spans)."""
    if not hasattr(leaf, "ndim") or leaf.ndim < 2:
        return False
    p = path.lower()
    return not any(s in p for s in ("norm", "span_z", "bias"))


@torch.no_grad()
def adamw_update(grads: Any, state: AdamWState, params: Any, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None):
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
    count = state.count + 1
    if lr is None:
        lr = lr_schedule(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()

    new = {}      # path -> (param, m, v)

    def step(path, p, g, m, v):
        g32 = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * g32 * g32
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay and _decay_mask(path, p):
            upd = upd + cfg.weight_decay * p.float()
        if cfg.span_lr_mult != 1.0 and "span_z" in path:
            upd = upd * cfg.span_lr_mult
        new[path] = ((p.float() - lr * upd).to(p.dtype), m, v)

    tree_map_with_path(step, params, grads, state.m, state.v)

    def pick(i):
        return tree_map_with_path(lambda path, _: new[path][i], params)

    return pick(0), AdamWState(count=count, m=pick(1), v=pick(2)), {"grad_norm": gnorm, "lr": lr}
