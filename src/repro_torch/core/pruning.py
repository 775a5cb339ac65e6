"""Movement and magnitude pruning (paper §III-C, Fig. 5, Table IV), the
port of the JAX package's ``core/pruning.py``.

``magnitude_mask`` keeps the weights with ``|w|`` above the quantile the
target sparsity implies.  ``block_size > 1`` scores contiguous
(block, block) tiles by their L2 norm and prunes whole tiles: the structured
mode whose zero tiles the block-sparse matmul kernel skips.

Movement pruning (Sanh et al.): learnable scores S of W's shape; the forward
uses W * TopV(S), and the straight-through estimator routes
dL/dS = dL/d(W * mask) * W (``movement_masked_weight``).  ``PruneState``
carries the masks (and scores) over a parameter tree; which leaves are
pruned is decided on their keystr paths (``prunable``), as in the JAX
package.  Masks are recomputed on the host on a cubic schedule
(``sparsity_schedule``, ``update_masks``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.common.util import tree_leaves_with_path, tree_map_with_path


def sparsity_schedule(step, final_sparsity: float, begin_step: int, end_step: int) -> torch.Tensor:
    """Cubic ramp, 0 at ``begin_step`` -> ``final_sparsity`` at ``end_step``,
    a float32 scalar computed in float32 as the reference computes it."""
    f32 = torch.float32
    step = torch.as_tensor(step, dtype=f32)
    t = ((step - begin_step) / torch.tensor(max(end_step - begin_step, 1), dtype=f32)).clamp(0.0, 1.0)
    return final_sparsity * (1.0 - (1.0 - t) ** 3)


def _block_reduce(score: torch.Tensor, block: int) -> torch.Tensor:
    """L2-reduce a 2D score tensor into (ceil(r/b), ceil(c/b)) block scores."""
    r, c = score.shape
    s = torch.nn.functional.pad(score.float(), (0, (-c) % block, 0, (-r) % block))
    s = s.reshape(s.shape[0] // block, block, s.shape[1] // block, block)
    return torch.sqrt((s * s).sum(dim=(1, 3)))


def _expand_block_mask(bmask: torch.Tensor, shape, block: int) -> torch.Tensor:
    m = bmask.repeat_interleave(block, dim=0).repeat_interleave(block, dim=1)
    return m[: shape[0], : shape[1]]


def topv_mask(score: torch.Tensor, sparsity: float, block_size: int = 1) -> torch.Tensor:
    """Binary keep-mask retaining the top (1 - sparsity) fraction by score."""
    if block_size > 1 and score.ndim == 2:
        bmask = topv_mask(_block_reduce(score, block_size), sparsity, block_size=1)
        return _expand_block_mask(bmask, score.shape, block_size).to(score.dtype)
    flat = score.reshape(-1).float()
    n = flat.shape[0]
    # drop the k = floor(n * sparsity) smallest scores (the product taken in
    # float32, as the reference does): threshold at the k-th order
    # statistic and keep strictly greater values; k == 0 keeps everything
    k = int(np.clip(math.floor(np.float32(n) * np.float32(sparsity)), 0, n))
    if k <= 0:
        return torch.ones_like(score)
    thresh = torch.sort(flat).values[k - 1]
    return (flat > thresh).to(score.dtype).reshape(score.shape)


def magnitude_mask(w: torch.Tensor, sparsity: float, block_size: int = 1) -> torch.Tensor:
    return topv_mask(w.abs(), sparsity, block_size)


# ---------------------------------------------------------------------------
# Movement pruning STE
# ---------------------------------------------------------------------------


class _MovementMaskedWeight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, scores, sparsity, block_size):
        mask = topv_mask(scores.detach(), float(sparsity), block_size).to(w.dtype)
        ctx.save_for_backward(w, mask)
        return w * mask

    @staticmethod
    def backward(ctx, g):
        w, mask = ctx.saved_tensors
        # dL/dw through the mask; dL/dscores straight through: g * w
        return g * mask, (g * w).to(w.dtype), None, None


def movement_masked_weight(w: torch.Tensor, scores: torch.Tensor, sparsity: float,
                           block_size: int = 1) -> torch.Tensor:
    """``w * topv_mask(scores)`` with the straight-through gradients
    dW = g * mask and dS = g * W."""
    return _MovementMaskedWeight.apply(w, scores, sparsity, block_size)


# ---------------------------------------------------------------------------
# Pruning state over parameter trees
# ---------------------------------------------------------------------------

# The paper deliberately does NOT sparsify layer normalization, the early-exit
# off-ramp or the final classifier (§IV-B2: EE_perf deteriorates 3.2x on SST-2
# otherwise).  Matched against keystr paths, so ['embed']['tok'] is prunable.
_EXCLUDE_SUBSTRINGS = ("norm", "ln_", "bias", "offramp", "classifier", "span_z", "router")


def prunable(path: str, leaf) -> bool:
    if not hasattr(leaf, "ndim") or leaf.ndim < 2:
        return False
    lp = path.lower()
    return not any(s in lp for s in _EXCLUDE_SUBSTRINGS)


def path_str(path) -> str:
    """The keystr path of a leaf (the port's tree walks already give it)."""
    return path


class PruneState(NamedTuple):
    masks: Any     # tree aligned with the params: a float32 mask per prunable leaf, else None
    scores: Any    # movement-pruning importance scores (all None for magnitude)


def init_prune_state(params: Any, method: str) -> PruneState:
    def mk_mask(path, leaf):
        return torch.ones_like(leaf, dtype=torch.float32) if prunable(path, leaf) else None

    def mk_score(path, leaf):
        # scores start at |w|, so early masking is magnitude-like, then moves
        if method == "movement" and prunable(path, leaf):
            return leaf.detach().abs().float()
        return None

    return PruneState(masks=tree_map_with_path(mk_mask, params),
                      scores=tree_map_with_path(mk_score, params))


def update_masks(params: Any, state: PruneState, step, method: str, final_sparsity: float,
                 begin_step: int, end_step: int, block_size: int = 1) -> PruneState:
    """Recompute the masks at the scheduled sparsity (every ``update_every``)."""
    s = float(sparsity_schedule(step, final_sparsity, begin_step, end_step))

    def upd(path, leaf, mask, score):
        if mask is None:
            return None
        src = leaf.detach().abs() if method == "magnitude" else score
        return topv_mask(src, s, block_size).float()

    return PruneState(masks=tree_map_with_path(upd, params, state.masks, state.scores),
                      scores=state.scores)


def apply_masks(params: Any, state: PruneState) -> Any:
    """params * mask on the prunable leaves (identity elsewhere)."""
    return tree_map_with_path(
        lambda _, leaf, mask: leaf if mask is None else leaf * mask.to(leaf.dtype), params, state.masks)


def update_movement_scores(state: PruneState, params: Any, grads: Any, lr) -> PruneState:
    """S <- S - lr * w * grad_w (first-order movement: accumulates
    -(dL/dW) * W, the movement-pruning importance)."""
    def upd(_, w, score, g):
        if score is None:
            return None
        return score - lr * (w * g).float()

    return PruneState(masks=state.masks, scores=tree_map_with_path(upd, params, state.scores, grads))


def measured_sparsity(params: Any, state: PruneState) -> Dict[str, float]:
    """The zero fraction over the prunable leaves (reported in benchmarks)."""
    zeros = total = 0
    for path, leaf in tree_leaves_with_path(apply_masks(params, state)):
        if prunable(path, leaf):
            zeros += int((leaf == 0).sum())
            total += leaf.numel()
    return {"sparsity": zeros / max(total, 1), "zeros": zeros, "total": total}
