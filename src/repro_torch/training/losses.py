"""Task losses (the port of the JAX package's ``training/losses.py``):
next-token LM cross-entropy, classification cross-entropy, the phase-2
off-ramp sum, and EdgeBERT's phase-1 composite (task CE, distillation,
span regularizer, auxiliary loss)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.adaptive_span import span_loss
from repro_torch.core.distill import cross_entropy, distill_objective


def _acc(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.float().argmax(-1) == labels).float().mean()


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE: logits [B, S, V] predict the tokens shifted left."""
    tgt = tokens[:, 1:].long()
    lg = logits[:, :-1].float()
    nll = -torch.gather(torch.log_softmax(lg, dim=-1), -1, tgt[..., None])[..., 0]
    loss = nll.mean()
    return loss, {"loss": loss, "acc": _acc(lg, tgt)}


def cls_loss(cls_logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    loss = cross_entropy(cls_logits, labels)
    return loss, {"loss": loss, "acc": _acc(cls_logits, labels)}


def offramp_loss(all_cls_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Phase 2 (DeeBERT): the sum of the CE over every off-ramp layer [L, B, C]."""
    return torch.stack([cross_entropy(lg, labels) for lg in all_cls_logits]).sum()


def edgebert_phase1_loss(
    cls_logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    teacher_logits: Optional[torch.Tensor] = None,
    distill_alpha: float = 0.0,
    span_z: Optional[torch.Tensor] = None,
    max_span: int = 128,
    span_coef: float = 0.0,
    aux=0.0,
) -> Tuple[torch.Tensor, Dict]:
    """Paper Fig. 6 phase 1: task CE (+ KD) while pruning and learning spans."""
    if teacher_logits is not None and distill_alpha > 0:
        task = distill_objective(cls_logits, teacher_logits, labels, distill_alpha)
    else:
        task = cross_entropy(cls_logits, labels)
    total = task + aux
    metrics = {"task_loss": task}
    if span_z is not None and span_coef > 0:
        sl = span_loss(span_z, max_span, span_coef)
        total = total + sl
        metrics["span_loss"] = sl
        metrics["mean_span"] = span_z.mean()
    metrics.update({"loss": total, "acc": _acc(cls_logits, labels)})
    return total, metrics
