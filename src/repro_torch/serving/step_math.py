"""The math of one fused classifier serving step, apart from scheduling
(the single-device part of ``repro/serving/step_math.py``).

Every function here is tensor math only: no scheduler, no telemetry, no
host state.  ``use_kernels`` routes the eligible inner ops (attention,
layernorm, off-ramp entropy, activation quantization, pruned MLP tiles) to
the hand-written kernels through ``kernels.dispatch``; ``False`` keeps the
reference ops.

Lanes: the JAX package ``vmap``s a one-lane body over the lane axis; the
port runs the ``[lanes, S_bucket, D]`` slab at once, with per-lane lengths
masking each lane's bucket padding out of attention and one activation-
quant bias per lane, so each lane computes what the one-lane body does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.early_exit import offramp_logits
from repro_torch.core.entropy import entropy_from_logits
from repro_torch.kernels import dispatch
from repro_torch.models.model import Model


def classifier_embed(model: Model, params: Any, tokens: torch.Tensor) -> torch.Tensor:
    """Embed one lane's padded token row: [1, S_bucket] -> [1, S_bucket, D]."""
    return model.embed(params, tokens)


def _layer(model, params, h, active, lengths, use_kernels, block_masks) -> torch.Tensor:
    h_new = model._dense_layer_step(
        params["layer"], h, causal=False, span_z=model._span_for_layer(params, 0),
        kv_len=lengths, use_kernels=use_kernels, block_masks=block_masks, per_lane=True,
    )
    return torch.where(active[:, None, None], h_new, h)


def classifier_fused_step(
    model: Model,
    params: Any,
    h: torch.Tensor,          # [lanes, S_bucket, D] hidden states
    active: torch.Tensor,     # [lanes] bool; inactive lanes keep their h
    lengths: torch.Tensor,    # [lanes] int32 valid tokens per lane
    threshold: float,         # entropy threshold
    *,
    use_kernels: bool = False,
    block_masks: Optional[Dict[str, Any]] = None,
):
    """Encoder layer -> off-ramp logits -> entropy -> retire mask.

    Positions beyond a lane's length are bucket padding, masked out of
    attention by its kv_len, so a padded sentence computes the same function
    as at its native length.  Returns ``(h, logits, entropy, retire)``.  On
    the kernel route the last three are the views ``unpack_head`` gives of
    ``classifier_head_step``'s packed buffer, retire as 1.0 / 0.0.
    """
    if use_kernels:
        h, packed = classifier_head_step(model, params, h, active, lengths, threshold,
                                         block_masks=block_masks)
        return (h, *unpack_head(packed))
    h = _layer(model, params, h, active, lengths, False, block_masks)
    lg = offramp_logits(h, model._offramp(params))
    ent = entropy_from_logits(lg)
    retire = active & (ent < threshold)
    return h, lg, ent, retire


def classifier_head_step(
    model: Model,
    params: Any,
    h: torch.Tensor,
    active: torch.Tensor,
    lengths: torch.Tensor,
    threshold: float,
    *,
    block_masks: Optional[Dict[str, Any]] = None,
):
    """The kernel route of ``classifier_fused_step``: the encoder layer on
    the kernels, then the whole off-ramp in one launch
    (``dispatch.offramp_head``) -> ``(h, packed)``, packed [lanes, C + 2]
    fp32 rows [logits | entropy | retire as 1.0 / 0.0]."""
    h = _layer(model, params, h, active, lengths, True, block_masks)
    return h, dispatch.offramp_head(h, model._offramp(params), active, threshold)


def unpack_head(packed):
    """``(logits, entropy, retire)`` views of the off-ramp head's packed
    rows, a tensor or a numpy array."""
    C = packed.shape[-1] - 2
    return packed[:, :C], packed[:, C], packed[:, C + 1]


def lane_insert(h: torch.Tensor, lane: int, h_new: torch.Tensor) -> None:
    """Overwrite one lane row of ``h`` in place with ``h_new`` [1, S, D]
    (load and restore share it, so a preempted lane round-trips through the
    same copy)."""
    h[lane] = h_new[0]
