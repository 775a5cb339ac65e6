"""Block-sparse matmul over pruned weight tiles (paper §V-C zero skip, at
tile granularity).

Replaces the Pallas kernel ``repro/kernels/block_sparse.py:42``
``_bs_kernel`` (``pallas_call`` at :84) with the CUDA kernel in
``csrc/block_sparse.cu``.  ``build_block_index`` (a copy of the JAX
package's) turns a static block-occupancy mask into a CSR-of-blocks index on
the host; ``BlockIndex.build`` uploads it once per weight, and every call
reuses it.  The kernel's k-loop visits only the occupied tiles, so compute
and weight traffic scale with density.  The source gives its bound on the
H100.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

_SIGNATURES = {
    "repro_block_sparse_matmul": [build.PTR] * 5 + [build.INT] * 6 + [build.PTR, build.INT],
}
MAX_TILE = 32


def build_block_index(block_mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int]:
    """CSR-of-blocks: for each n-block, the occupied k-block indices.

    Returns (indices [Nb, max_nnz] int32, counts [Nb] int32, max_nnz).
    Padded entries repeat the last valid index (clamped DMA, masked compute).
    """
    block_mask = np.asarray(block_mask, bool)
    Kb, Nb = block_mask.shape
    counts = block_mask.sum(axis=0).astype(np.int32)
    max_nnz = max(int(counts.max()) if counts.size else 0, 1)
    indices = np.zeros((Nb, max_nnz), np.int32)
    for j in range(Nb):
        ks = np.nonzero(block_mask[:, j])[0]
        if len(ks):
            indices[j, : len(ks)] = ks
            indices[j, len(ks) :] = ks[-1]
    return indices, counts, max_nnz


@dataclass(frozen=True)
class BlockIndex:
    """A weight's static occupancy and its CSR-of-blocks index on the
    weight's device."""

    mask: np.ndarray              # [K // bk, N // bn] bool
    bk: int
    bn: int
    indices: torch.Tensor         # [N // bn, max_nnz] int32
    counts: torch.Tensor          # [N // bn] int32
    max_nnz: int

    @classmethod
    def build(cls, mask: np.ndarray, bk: int, bn: int, device) -> "BlockIndex":
        indices, counts, max_nnz = build_block_index(mask)
        return cls(np.asarray(mask, bool), int(bk), int(bn),
                   torch.from_numpy(indices).to(device), torch.from_numpy(counts).to(device),
                   max_nnz)

    @property
    def occupied(self) -> int:
        return int(self.mask.sum())


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor, index: BlockIndex) -> torch.Tensor:
    """x [M, K] @ w [K, N] over the occupied tiles of ``index`` -> [M, N]
    fp32.  A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises."""
    if x.device.type == "cpu":
        return ref.block_sparse_matmul(x, w, index.mask, index.bk, index.bn)
    build.require_cuda("block_sparse_matmul", x, w)
    build.require_cuda("block_sparse_matmul", x, index.indices, index.counts, dtype=None)
    M, K = x.shape
    K2, N = w.shape
    Kb, Nb = index.mask.shape
    if K != K2 or K != Kb * index.bk or N != Nb * index.bn:
        raise ValueError(f"block_sparse_matmul: x {tuple(x.shape)}, w {tuple(w.shape)} and a "
                         f"{Kb}x{Nb} mask of {index.bk}x{index.bn} tiles do not match")
    if not (1 <= index.bk <= MAX_TILE and 1 <= index.bn <= MAX_TILE):
        raise ValueError(f"block_sparse_matmul: tiles must be at most {MAX_TILE}x{MAX_TILE}")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = build.library("block_sparse", _SIGNATURES)
    err = lib.repro_block_sparse_matmul(
        out.data_ptr(), x.data_ptr(), w.data_ptr(), index.indices.data_ptr(),
        index.counts.data_ptr(), M, K, N, index.bk, index.bn, index.max_nnz,
        build.stream_of(x), x.device.index,
    )
    build.check(lib, err, "block_sparse_matmul")
    block_sparse_matmul.launches += 1
    return out


block_sparse_matmul.launches = 0
