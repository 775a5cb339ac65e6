"""Knowledge distillation loss (paper Fig. 6 phase 1: the task-finetuned
ALBERT acts as teacher while the student is pruned and learns its spans),
the port of the JAX package's ``core/distill.py``."""
from __future__ import annotations

import torch


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor, temperature: float = 2.0) -> torch.Tensor:
    """KL(teacher || student) with temperature scaling, mean over the batch."""
    t = temperature
    sp = torch.log_softmax(student_logits.float() / t, dim=-1)
    tp = torch.softmax(teacher_logits.float() / t, dim=-1)
    kl = (tp * (torch.log(tp.clamp_min(1e-20)) - sp)).sum(dim=-1)
    return (t * t) * kl.mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(lp, -1, labels.long()[..., None])[..., 0]
    return nll.mean()


def distill_objective(student_logits, teacher_logits, labels, alpha: float, temperature: float = 2.0):
    """(1 - alpha) * CE + alpha * KD: the phase-1 fine-tuning objective."""
    ce = cross_entropy(student_logits, labels)
    if alpha <= 0:
        return ce
    kd = kd_loss(student_logits, teacher_logits, temperature)
    return (1.0 - alpha) * ce + alpha * kd
