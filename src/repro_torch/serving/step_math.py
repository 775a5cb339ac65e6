"""The math of one fused serving step, apart from scheduling (the port of
``repro/serving/step_math.py``): the classifier's step and the decoder's
decode, early-exit decode, speculative decode and prefill, each also over
replica slabs (``sharded_*``); and the port's own encoder family's step, in
which each lane runs its own layer: lanes grouped by depth
(``depth_groups``), one layer call per group (``encoder_group_step``).

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
own cache row at its own position (the ssm and hybrid families: its own
recurrent state too), so each lane computes what the one-lane body does.  The decoder's
cache is updated in place.

Replicas: the ``sharded_*`` functions split the lanes into ``replicas``
contiguous slabs (lane ``i`` lives on replica ``i // lanes_per_replica``), as
the JAX package's ``shard_map`` over a 1-D mesh does.  A device list plays
the mesh's part: each slab, its params (one copy per distinct device,
shared by the replicas on it) and the decoder's cache rows live on the
slab's device, and each slab runs the unsharded function on its own, with
the same kernels, and no tensor crosses replicas but the gathered
per-lane outputs.  Every slab's inputs go to its device first, then every
slab's launches are issued, and only then are the outputs gathered onto
the first slab's device, so the host waits once per fused step and two
cards overlap.  Lanes are independent, so one slab computes what the
unsharded function computes on its lanes; at equal shapes (one replica, or
one slab against the unsharded function on ``lanes_per_replica`` lanes) bit
for bit, and across shapes within the rounding of sums whose order the
shape decides (split-K, the grouped quantize's clusters).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.early_exit import offramp_logits
from repro_torch.core.entropy import entropy_from_logits
from repro_torch.kernels import dispatch
from repro_torch.models import moe
from repro_torch.models.model import Model


def classifier_embed(model: Model, params: Any, tokens: torch.Tensor) -> torch.Tensor:
    """Embed padded token rows: [k, S_bucket] -> [k, S_bucket, D]."""
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


def slab_inputs(x, slabs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A per-lane host array ``x`` [lanes, ...] cut into one slab per
    replica, each on its replica's device (``slabs``: one tensor per
    replica whose device and leading axis give the replica's device and
    lane count): one copy per distinct device, then views."""
    x = torch.as_tensor(np.asarray(x))
    on: Dict[torch.device, torch.Tensor] = {}
    out, start = [], 0
    for s in slabs:
        dev, n = s.device, s.shape[0]
        if dev not in on:
            on[dev] = x.to(dev)
        out.append(on[dev][start:start + n])
        start += n
    return out


def gather(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-replica outputs concatenated on the lane axis, on the first
    replica's device (a copy between cards is queued, not waited for)."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts]) if len(parts) > 1 else parts[0]


def sharded_classifier_fused_step(
    model: Model,
    params: Sequence[Any],         # one per replica (replicas on a device share it)
    h: Sequence[torch.Tensor],     # one [lanes_per_replica, S_bucket, D] slab per replica
    active,                        # [lanes] bool, host
    lengths,                       # [lanes] int32, host
    threshold: float,
    *,
    use_kernels: bool = False,
    block_masks: Optional[Sequence[Optional[Dict[str, Any]]]] = None,
):
    """``classifier_fused_step`` over replica slabs: each slab on its
    device under its replica's params -> ``(h slabs, logits, entropy,
    retire)``, the last three gathered [lanes, ...] on the first slab's
    device (on the kernel route, views of ``sharded_classifier_head_step``'s
    packed rows)."""
    if use_kernels:
        h, packed = sharded_classifier_head_step(model, params, h, active, lengths, threshold,
                                                 block_masks=block_masks)
        return (h, *unpack_head(packed))
    masks = block_masks or [None] * len(h)
    act, lens = slab_inputs(np.asarray(active, bool), h), slab_inputs(lengths, h)
    outs = [classifier_fused_step(model, p, hh, a, n, threshold, block_masks=m)
            for p, hh, a, n, m in zip(params, h, act, lens, masks)]
    return [o[0] for o in outs], *(gather([o[k] for o in outs]) for k in (1, 2, 3))


def sharded_classifier_head_step(
    model: Model,
    params: Sequence[Any],
    h: Sequence[torch.Tensor],
    active,
    lengths,
    threshold: float,
    *,
    block_masks: Optional[Sequence[Optional[Dict[str, Any]]]] = None,
):
    """The kernel route of ``sharded_classifier_fused_step``: each slab's
    ``classifier_head_step`` -> ``(h slabs, packed)``, packed [lanes, C + 2]
    gathered on the first slab's device (one copy back to the host for the
    whole fused step)."""
    masks = block_masks or [None] * len(h)
    act, lens = slab_inputs(np.asarray(active, bool), h), slab_inputs(lengths, h)
    outs = [classifier_head_step(model, p, hh, a, n, threshold, block_masks=m)
            for p, hh, a, n, m in zip(params, h, act, lens, masks)]
    return [o[0] for o in outs], gather([o[1] for o in outs])


def depth_groups(depth: np.ndarray, active: np.ndarray) -> Tuple[np.ndarray, List[Tuple[int, int, int]]]:
    """The active lanes grouped by the layer each runs next: ``(order,
    groups)``, ``order`` the active lanes sorted by ``depth`` (stably:
    lane order within a layer) and ``groups`` ``(layer, start, stop)``, the
    lanes ``order[start:stop]`` at depth (0-based layer) ``layer``, layers
    ascending."""
    lanes = np.flatnonzero(active)
    order = lanes[np.argsort(depth[lanes], kind="stable")]
    d = depth[order]
    cuts = np.flatnonzero(np.diff(d)) + 1
    starts, stops = np.r_[0, cuts], np.r_[cuts, len(order)]
    return order, [(int(d[a]), int(a), int(b)) for a, b in zip(starts, stops) if b > a]


def encoder_group_step(
    model: Model,
    params: Any,
    h: torch.Tensor,          # [lanes, S_bucket, D], written in place
    lanes: torch.Tensor,      # [g] int64 lanes at this layer (on h's device)
    lengths: torch.Tensor,    # [lanes] valid tokens per lane (on h's device)
    layer: int,
    threshold: float,
    packed: torch.Tensor,     # [lanes, C + 2] fp32, the group's rows written in place
    *,
    use_kernels: bool = False,
    block_masks: Optional[Dict[str, Any]] = None,   # this layer's
) -> None:
    """One depth group of the encoder family's fused step: the lanes
    ``lanes`` (every one at depth ``layer``) taken out of ``h``, run through
    encoder layer ``layer`` (its own weights, its kind of attention) and put
    back, then that layer's off-ramp on their CLS rows, its entropy and
    retire = entropy < threshold written into their rows of ``packed``
    (``[logits | entropy | retire as 1.0 / 0.0]``, the off-ramp head
    kernel's layout).  Each lane computes what it computes alone: its own
    kv_len, its own activation-quant bias.  The off-ramp runs on the
    reference ops on either route (no kernel computes ModernBERT's head)."""
    hg = model.encoder_layer_step(model._layer(params, layer)[0], h.index_select(0, lanes), layer=layer,
                                  kv_len=lengths.index_select(0, lanes), use_kernels=use_kernels,
                                  block_masks=block_masks, per_lane=True)
    h.index_copy_(0, lanes, hg)
    lg = model.encoder_offramp(params, hg, layer).float()
    ent = entropy_from_logits(lg)
    packed.index_copy_(0, lanes, torch.cat([lg, ent[:, None], (ent < threshold).float()[:, None]], dim=1))


def lane_insert(h: torch.Tensor, lane: int, h_new: torch.Tensor) -> None:
    """Overwrite one lane row of ``h`` in place with ``h_new`` [1, S, D]
    (a restore puts a checkpointed row back through it, bit for bit)."""
    h[lane] = h_new[0]


def lanes_insert(h: torch.Tensor, lanes: torch.Tensor, h_new: torch.Tensor) -> None:
    """Overwrite lane rows ``lanes`` [k] (int64, on ``h``'s device) of ``h``
    in place with ``h_new`` [k, S, D]: one indexed copy for a flush of
    staged loads."""
    h.index_copy_(0, lanes, h_new)


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


def _cache_slabs(caches: Sequence[Any]) -> List[torch.Tensor]:
    """One tensor per replica carrying its device and lane count (axis 1 of
    every cache leaf), for ``slab_inputs``."""
    return [next(iter(c.values()))[0] for c in caches]


def sharded_decoder_decode(
    model: Model,
    params: Sequence[Any],
    caches: Sequence[Any],     # one cache per replica, lanes on axis 1 of every leaf
    tokens,                    # [lanes, 1] host
    pos,                       # [lanes] host
    *,
    use_kernels: bool = False,
):
    """``decoder_decode`` over replica slabs -> (logits [lanes, 1, V]
    gathered on the first replica's device, caches updated in place)."""
    toks, ps = slab_inputs(tokens, _cache_slabs(caches)), slab_inputs(pos, _cache_slabs(caches))
    outs = [decoder_decode(model, p, c, t, q, use_kernels=use_kernels)
            for p, c, t, q in zip(params, caches, toks, ps)]
    return gather([o[0] for o in outs]), [o[1] for o in outs]


def sharded_decoder_decode_ee(
    model: Model,
    params: Sequence[Any],
    caches: Sequence[Any],
    tokens,
    pos,
    threshold: float,
    *,
    use_kernels: bool = False,
):
    """``decoder_decode_ee`` over replica slabs -> (logits, caches,
    exit_layer, first_ent), the per-lane outputs gathered on the first
    replica's device."""
    toks, ps = slab_inputs(tokens, _cache_slabs(caches)), slab_inputs(pos, _cache_slabs(caches))
    outs = [decoder_decode_ee(model, p, c, t, q, threshold, use_kernels=use_kernels)
            for p, c, t, q in zip(params, caches, toks, ps)]
    return (gather([o[0] for o in outs]), [o[1] for o in outs],
            gather([o[2] for o in outs]), gather([o[3] for o in outs]))


def sharded_decoder_decode_spec(
    model: Model,
    params: Sequence[Any],
    caches: Sequence[Any],
    tokens,
    pos,
    thresholds,                # [lanes, spec_window] host
    spec_window: int,
    *,
    eos_id: int = -1,
    use_kernels: bool = False,
):
    """``decoder_decode_spec`` over replica slabs -> (tokens, logits,
    caches, exit_layers, first_ent, accepted), the per-lane outputs
    gathered on the first replica's device."""
    slabs = _cache_slabs(caches)
    toks, ps, thr = slab_inputs(tokens, slabs), slab_inputs(pos, slabs), slab_inputs(thresholds, slabs)
    outs = [decoder_decode_spec(model, p, c, t, q, th, spec_window, eos_id=eos_id, use_kernels=use_kernels)
            for p, c, t, q, th in zip(params, caches, toks, ps, thr)]
    return (gather([o[0] for o in outs]), gather([o[1] for o in outs]), [o[2] for o in outs],
            *(gather([o[k] for o in outs]) for k in (3, 4, 5)))


def decoder_prefill(
    model: Model,
    params: Any,
    cache: Any,
    tokens: np.ndarray,       # [bucket] zero-padded prompt
    lane: int,
    length: int,              # prompt length
    *,
    use_kernels: bool = False,
    group: Optional[Tuple[int, int]] = None,
    fleet: Optional[Sequence[Any]] = None,
):
    """Write one lane's prompt[:length - 1] into its cache row (the KV rows,
    or the recurrent state): full-depth ``decode_step``s, one token at a
    time, as the JAX package runs them.

    The JAX package steps every lane in one batched call per token (token 0
    on the other lanes) on a scratch copy of the cache, and merges the lane
    back under a one-hot.  Two things couple the lane to the other lanes in
    that call: an MoE layer's expert capacity, and the activation
    quantization's one AdaptivFloat bias over the batch (the call is not
    ``vmap``ped), whose amax takes in the other lanes' rows.  The port
    steps as few lanes as give the same values:

    * the lane's row alone, a view written in place, where nothing couples:
      quantization off, and for the MoE family ``lanes <= C``, the capacity
      of one step's routing over the lanes (the lane's assignment to an
      expert is dropped only when C lanes of lower index took that expert
      before it in the stable sort, and it has at most ``lanes - 1`` of
      them).  The ssm and hybrid families' recurrent state, the hybrid
      family's causal conv, SSD step and shared block's attention to the
      lane's own KV rows, and the encdec and vlm cross layers' reads of the
      lane's own (zero: the server never writes them, as the JAX server does
      not) cross or image K/V each read the lane's row alone;
    * every lane of the group on a scratch, the other rows zero, for the
      MoE family with ``lanes > C``: the dummy lanes can take the lane's
      expert slots.  A dummy row holds what this loop writes into it (token
      0 at every position) whatever it held before, so zero rows route as
      the JAX package's do;
    * the lane and ONE zero dummy row on a scratch, with quantization on,
      for the dense, MoE (``lanes <= C``; the two rows' routing drops
      nothing, capacity being at least 4), encdec and vlm families: every
      dummy lane of the JAX call computes the same row (token 0 at every
      position over rows this loop wrote), so one of them gives the same
      amax;
    * every lane of the group on a scratch copied from their live rows,
      with quantization on, for the ssm and hybrid families: there a dummy
      lane steps its own live recurrent state, so every row counts in the
      amax.  ``fleet`` gives every replica's cache in lane order when the
      group spans replicas (the JAX package's sharded server runs the
      prefill over the whole fleet's lanes); their rows are copied to the
      lane's device once per prefill.

    Every cache leaf is [n, lanes, ...]: the KV cache's rows, the ssm
    family's recurrent state (token-shift inputs and WKV state) or the
    hybrid family's (conv and SSM state, beside the shared block's KV
    rows), which this prefill carries on from whatever the lane's row holds
    (the server zeroes it first).

    ``group`` = (lanes, index): the lanes the JAX package's prefill steps
    together and the lane's index among them, when they are not the
    cache's (a replica's cache holds its slab; default: the cache's lanes
    and ``lane``).  Returns the cache."""
    leaf = next(iter(cache.values()))
    dev, lanes = leaf.device, leaf.shape[1]
    g_lanes, g_index = group if group is not None else (lanes, lane)
    toks = torch.as_tensor(np.asarray(tokens[: max(length - 1, 0)], np.int64), device=dev)
    cfg = model.cfg
    quant = cfg.edgebert.quant.enabled and cfg.edgebert.quant.quantize_activations and g_lanes > 1
    if cfg.family in ("ssm", "hybrid") and quant:
        caches = fleet if fleet is not None else [cache]
        scratch = {k: torch.cat([c[k].to(dev) for c in caches], dim=1) for k in cache}
        index = g_index
    elif cfg.family == "moe" and g_lanes > moe.capacity(g_lanes, cfg):
        scratch = {k: v.new_zeros((v.shape[0], g_lanes) + tuple(v.shape[2:])) for k, v in cache.items()}
        index = g_index
    elif quant:
        scratch = {k: v.new_zeros((v.shape[0], 2) + tuple(v.shape[2:])) for k, v in cache.items()}
        index = 0
    else:
        row = {k: v[:, lane:lane + 1] for k, v in cache.items()}
        for t in range(length - 1):
            model.decode_step(params, row, toks[t].reshape(1, 1), t, use_kernels=use_kernels)
        return cache
    for k, v in cache.items():
        scratch[k][:, index] = v[:, lane]
    is_lane = torch.arange(next(iter(scratch.values())).shape[1], device=dev)[:, None] == index
    for t in range(length - 1):
        tok = torch.where(is_lane, toks[t], 0)
        model.decode_step(params, scratch, tok, t, use_kernels=use_kernels, per_lane=False)
    for k in cache:
        cache[k][:, lane] = scratch[k][:, index]
    return cache
