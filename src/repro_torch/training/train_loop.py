"""Training steps and the EdgeBERT two-phase trainer (paper Fig. 6), the
port of the JAX package's ``training/train_loop.py``.

``make_train_step`` builds the generic step (gradient accumulation over
microbatches, AdamW, the span projection).  ``EdgeBertTrainer`` runs the
paper's procedure: phase 1 fine-tunes with pruning (magnitude or movement),
adaptive-span learning and optional distillation from a teacher; phase 2
freezes the backbone and trains the early-exit off-ramp.  Pruning masks are
updated on the host every ``update_every`` steps and passed into the step.

Each step function is the counterpart of one ``jax.jit`` step: autograd
differentiates the model's reference ops (``Model.apply_train``; no kernel
has a backward), and the step returns plain tensors with no autograd
history.  The params are whatever device the caller put them on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from repro_torch.common.util import logger, tree_leaves_with_path, tree_map, tree_map_with_path
from repro_torch.core import adaptive_span, pruning
from repro_torch.models.model import Model
from repro_torch.training import losses as losses_mod
from repro_torch.training.optim import AdamWConfig, adamw_init, adamw_update


def to_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A data batch on ``device``, without ``signal_ratio`` (data
    telemetry, not a model input)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items() if k != "signal_ratio"}


def _device(params: Any) -> torch.device:
    return tree_leaves_with_path(params)[0][1].device


# ---------------------------------------------------------------------------
# Loss functions
# ---------------------------------------------------------------------------


def make_loss_fn(model: Model) -> Callable:
    cfg = model.cfg

    def loss_fn(params, batch, teacher_logits=None):
        out = model.apply_train(params, batch)
        if cfg.num_classes and "labels" in batch:
            eb = cfg.edgebert
            # early exit on: train against the FINAL layer's off-ramp
            cls = out.all_cls_logits[-1] if out.all_cls_logits is not None else out.cls_logits
            return losses_mod.edgebert_phase1_loss(
                cls, batch["labels"],
                teacher_logits=teacher_logits,
                distill_alpha=eb.distill_alpha,
                span_z=params.get("span_z"),
                max_span=eb.span.max_span,
                span_coef=eb.span.loss_coef if eb.span.enabled else 0.0,
                aux=out.aux_loss,
            )
        total, metrics = losses_mod.lm_loss(out.logits, batch["tokens"])
        total = total + out.aux_loss
        if cfg.edgebert.span.enabled and "span_z" in params:
            total = total + adaptive_span.span_loss(
                params["span_z"], cfg.edgebert.span.max_span, cfg.edgebert.span.loss_coef)
            metrics["mean_span"] = params["span_z"].mean()
        metrics["loss"] = total
        return total, metrics

    return loss_fn


def value_and_grad(fn: Callable, params: Any, *args, **kw):
    """``((loss, aux), grads)`` of ``fn(params, *args, **kw) -> (loss, aux)``
    with respect to every leaf of ``params`` (``jax.value_and_grad`` with
    ``has_aux``): a leaf the loss does not reach gets a zero gradient, as in
    JAX.  The returned grads and aux carry no autograd history."""
    leaves = tree_leaves_with_path(params)
    with torch.enable_grad():
        live = {path: leaf.detach().requires_grad_(True) for path, leaf in leaves}
        loss, aux = fn(tree_map_with_path(lambda path, _: live[path], params), *args, **kw)
        got = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    grads = {path: torch.zeros_like(live[path]) if g is None else g for (path, _), g in zip(leaves, got)}
    aux = tree_map(lambda t: t.detach() if torch.is_tensor(t) else t, aux)
    return (loss.detach(), aux), tree_map_with_path(lambda path, _: grads[path], params)


def _masked(params: Any, masks: Any) -> Any:
    return params if masks is None else pruning.apply_masks(params, pruning.PruneState(masks=masks, scores=None))


def _project_spans(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """The span projection after the optimizer step: z stays in [0, max_span]."""
    if "span_z" in params and cfg.edgebert.span.enabled:
        return dict(params, span_z=adaptive_span.clamp_spans(params["span_z"], cfg.edgebert.span.max_span))
    return params


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def _microbatch(v: torch.Tensor, k: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``k``: the i-th block of rows, as the JAX
    package's reshape to [k, B / k] splits the batch
    (``sharding.dtensor_forms`` swaps in a DTensor form)."""
    return v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))[i]


def make_train_step(model: Model, opt_cfg: AdamWConfig, *, microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch[, masks]) -> (params, opt_state,
    metrics)``.  With ``microbatches`` > 1 the batch's leading dim is split
    into that many chunks whose gradients are accumulated (in float32) and
    averaged, and the metrics averaged: activation memory scales down by the
    same factor."""
    loss_fn = make_loss_fn(model)
    cfg = model.cfg

    def grads_of(params, batch, masks):
        (_, metrics), grads = value_and_grad(lambda p: loss_fn(_masked(p, masks), batch), params)
        return grads, metrics

    def train_step(params, opt_state, batch, masks=None):
        if microbatches > 1:
            acc, ms = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params), []
            for i in range(microbatches):
                mb = {k: _microbatch(v, microbatches, i) for k, v in batch.items()}
                g, metrics = grads_of(params, mb, masks)
                acc = tree_map(lambda a, b: a + b.float(), acc, g)
                ms.append(metrics)
            grads = tree_map(lambda g: g / microbatches, acc)
            metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        else:
            grads, metrics = grads_of(params, batch, masks)
        params, opt_state, om = adamw_update(grads, opt_state, params, opt_cfg)
        metrics = dict(metrics)
        metrics.update(om)
        return _project_spans(params, cfg), opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# EdgeBERT two-phase trainer (paper Fig. 6)
# ---------------------------------------------------------------------------


@dataclass
class TrainerConfig:
    phase1_steps: int = 200
    phase2_steps: int = 100
    opt: AdamWConfig = None           # type: ignore

    def __post_init__(self):
        if self.opt is None:
            self.opt = AdamWConfig()


class EdgeBertTrainer:
    """Host-side orchestration of phase 1 (prune + span + KD) and phase 2
    (off-ramp highway fine-tuning with a frozen backbone)."""

    def __init__(self, model: Model, tcfg: TrainerConfig, teacher_params=None):
        self.model = model
        self.cfg = model.cfg
        self.tcfg = tcfg
        self.teacher_params = teacher_params
        self.loss_fn = make_loss_fn(model)

    # ---------------- phase 1 ----------------
    def phase1_step(self, params, opt_state, batch, masks):
        """One phase-1 step (the reference's jitted ``step_fn``): ``(params,
        opt_state, grads, metrics)``; the gradients are those of the
        unmasked params through the masks."""
        teacher, model = self.teacher_params, self.model
        tl = None
        if teacher is not None:
            with torch.no_grad():
                t_out = model.apply_train(teacher, batch)
            tl = t_out.all_cls_logits[-1] if t_out.all_cls_logits is not None else t_out.cls_logits
        (_, metrics), grads = value_and_grad(
            lambda p: self.loss_fn(_masked(p, masks), batch, teacher_logits=tl), params)
        params, opt_state, om = adamw_update(grads, opt_state, params, self.tcfg.opt)
        metrics = dict(metrics)
        metrics.update(om)
        return _project_spans(params, self.cfg), opt_state, grads, metrics

    def phase1(self, params, data, log_every: int = 50, callbacks=()):
        eb = self.cfg.edgebert
        dev = _device(params)
        opt_state = adamw_init(params)
        prune_state = pruning.init_prune_state(params, eb.prune.method) if eb.prune.enabled else None
        history: List[Dict[str, float]] = []
        masks = prune_state.masks if prune_state else None
        for step in range(self.tcfg.phase1_steps):
            batch = to_batch(data.batch(step), dev)
            params, opt_state, grads, metrics = self.phase1_step(params, opt_state, batch, masks)
            if prune_state is not None:
                if eb.prune.method == "movement":
                    prune_state = pruning.update_movement_scores(prune_state, params, grads, float(metrics["lr"]))
                if step % eb.prune.update_every == 0 or step == self.tcfg.phase1_steps - 1:
                    prune_state = pruning.update_masks(
                        params, prune_state, step, eb.prune.method, eb.prune.encoder_sparsity,
                        eb.prune.begin_step, eb.prune.end_step, eb.prune.block_size)
                    masks = prune_state.masks
            if step % log_every == 0:
                logger.info("phase1 step=%d loss=%.4f acc=%.3f", step, float(metrics["loss"]),
                            float(metrics.get("acc", 0.0)))
            history.append({k: float(v) for k, v in metrics.items()})
            for cb in callbacks:
                cb(step, params, metrics)
        # bake the masks in (the deploy form)
        if prune_state is not None:
            params = pruning.apply_masks(params, prune_state)
        return params, prune_state, history

    # ---------------- phase 2 ----------------
    def phase2_step(self, offramp, opt_state, frozen, batch):
        """One phase-2 step: only the off-ramp's params get gradients."""
        model = self.model

        def inner(oramp):
            out = model.apply_train(dict(frozen, offramp=oramp), batch)
            return losses_mod.offramp_loss(out.all_cls_logits, batch["labels"]), None

        (loss, _), grads = value_and_grad(inner, offramp)
        offramp, opt_state, om = adamw_update(grads, opt_state, offramp, self.tcfg.opt)
        return offramp, opt_state, {"loss": loss, **om}

    def phase2(self, params, data, log_every: int = 50):
        """Freeze everything except the off-ramp; train the off-ramp at every
        layer (DeeBERT).  Needs early exit on and an albert-family model."""
        if "offramp" not in params:
            raise ValueError("phase2 needs early-exit off-ramp params")
        dev = _device(params)
        frozen = {k: v for k, v in params.items() if k != "offramp"}
        offramp = params["offramp"]
        opt_state = adamw_init(offramp)
        history: List[Dict[str, float]] = []
        for step in range(self.tcfg.phase2_steps):
            batch = to_batch(data.batch(10_000 + step), dev)
            offramp, opt_state, metrics = self.phase2_step(offramp, opt_state, frozen, batch)
            if step % log_every == 0:
                logger.info("phase2 step=%d loss=%.4f", step, float(metrics["loss"]))
            history.append({k: float(v) for k, v in metrics.items()})
        return dict(frozen, offramp=offramp), history
