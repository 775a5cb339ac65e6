"""The math of one fused serving step, apart from scheduling (the
single-device part of ``repro/serving/step_math.py``): the classifier's
step and the decoder's decode, early-exit decode, speculative decode and
prefill.

Every function here is tensor math only: no scheduler, no telemetry, no
host state.  ``use_kernels`` routes the eligible inner ops (attention,
layernorm, off-ramp entropy, activation quantization, pruned MLP tiles; the
decoder's LM-head entropy) to the hand-written kernels through
``kernels.dispatch``; ``False`` keeps the reference ops.

Lanes: the JAX package ``vmap``s a one-lane body over the lane axis; the
port runs all lanes at once.  The classifier's ``[lanes, S_bucket, D]``
slab carries per-lane lengths masking each lane's bucket padding out of
attention and one activation-quant bias per lane; the decoder's steps take
a ``[lanes]`` tensor of cache positions, and each lane reads and writes its
own cache row at its own position, so each lane computes what the one-lane
body does.  The decoder's cache is updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.early_exit import offramp_logits
from repro_torch.core.entropy import entropy_from_logits
from repro_torch.kernels import dispatch
from repro_torch.models import moe
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


# ---------------------------------------------------------------------------
# Decoder (LM) fused steps
# ---------------------------------------------------------------------------


def decoder_decode(
    model: Model,
    params: Any,
    cache: Any,
    tokens: torch.Tensor,     # [lanes, 1]
    pos: torch.Tensor,        # [lanes] per-lane cache positions
    *,
    use_kernels: bool = False,
):
    """One decode step with PER-LANE positions -> (logits [lanes, 1, V],
    cache)."""
    return model.decode_step(params, cache, tokens, pos, use_kernels=use_kernels)


def decoder_decode_ee(
    model: Model,
    params: Any,
    cache: Any,
    tokens: torch.Tensor,     # [lanes, 1]
    pos: torch.Tensor,        # [lanes]
    threshold: float,
    *,
    use_kernels: bool = False,
):
    """Fused layer -> LM-head off-ramp -> entropy -> per-token exit, every
    lane at its own position -> (logits [lanes, 1, V], cache, exit_layer
    [lanes] (1-based), first-off-ramp entropy [lanes])."""
    return model.decode_step_ee(params, cache, tokens, pos, threshold, use_kernels=use_kernels)


def decoder_decode_spec(
    model: Model,
    params: Any,
    cache: Any,
    tokens: torch.Tensor,      # [lanes, 1]
    pos: torch.Tensor,         # [lanes]
    thresholds: torch.Tensor,  # [lanes, spec_window] per-slot entropy thresholds
    spec_window: int,
    *,
    eos_id: int = -1,
    use_kernels: bool = False,
):
    """Self-speculative fused step (draft via the off-ramp, verify via the
    remaining layers, batched accept and rollback), one threshold row per
    lane so a position / entropy-band schedule prices each speculated
    position.  Returns ``(tokens [lanes, W], logits [lanes, W, V], cache,
    exit_layers [lanes, W], first_ent [lanes, W], accepted [lanes, W])``."""
    return model.decode_step_spec(params, cache, tokens, pos, thresholds, spec_window,
                                  eos_id=eos_id, use_kernels=use_kernels)


def decoder_prefill(
    model: Model,
    params: Any,
    cache: Any,
    tokens: np.ndarray,       # [bucket] zero-padded prompt
    lane: int,
    length: int,              # prompt length
    *,
    use_kernels: bool = False,
):
    """Write one lane's prompt[:length - 1] into its cache row: full-depth
    ``decode_step``s, one token at a time, as the JAX package runs them.

    The JAX package steps every lane in one batched call per token (token 0
    on the other lanes) on a scratch copy of the cache, and merges the lane
    back under a one-hot.  Where no other lane can change the lane's result,
    the port steps a view of the lane's row alone and writes it in place:
    the same values without the copy.  That holds for the dense family, and
    for the MoE family while ``lanes <= C``, the capacity of one step's
    routing over the lanes: the lane's assignment to an expert is dropped
    only when C lanes of lower index took that expert before it in the
    stable sort, and it has at most ``lanes - 1`` of them.  With more lanes
    the dummy lanes can take the lane's expert slots, so the port steps all
    lanes on a scratch copy as the JAX package does.  Returns the cache."""
    dev = cache["k"].device
    toks = torch.as_tensor(np.asarray(tokens[: max(length - 1, 0)], np.int64), device=dev)
    lanes = cache["k"].shape[1]
    if model.cfg.family == "moe" and lanes > moe.capacity(lanes, model.cfg):
        scratch = {k: v.clone() for k, v in cache.items()}
        is_lane = torch.arange(lanes, device=dev)[:, None] == lane
        for t in range(length - 1):
            tok = torch.where(is_lane, toks[t], 0)
            model.decode_step(params, scratch, tok, t, use_kernels=use_kernels, moe_per_lane=False)
        for k in cache:
            cache[k][:, lane] = scratch[k][:, lane]
        return cache
    row = {k: v[:, lane:lane + 1] for k, v in cache.items()}
    for t in range(length - 1):
        model.decode_step(params, row, toks[t].reshape(1, 1), t, use_kernels=use_kernels)
    return cache
