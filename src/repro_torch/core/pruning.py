"""Magnitude pruning masks (paper §III-C, Table IV), the part of the JAX
package's ``core/pruning.py`` that serving needs.

``magnitude_mask`` keeps the weights with ``|w|`` above the quantile the
target sparsity implies.  ``block_size > 1`` scores contiguous
(block, block) tiles by their L2 norm and prunes whole tiles: the structured
mode whose zero tiles the block-sparse matmul kernel skips.  Movement
pruning and the sparsity schedule come with the training slice.
"""
from __future__ import annotations

import math

import numpy as np
import torch


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
