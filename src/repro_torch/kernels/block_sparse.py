"""Block-sparse matmul over pruned weight tiles (paper §V-C zero skip, at
tile granularity).

Replaces the Pallas kernel ``repro/kernels/block_sparse.py:42``
``_bs_kernel`` (``pallas_call`` at :84) with the CUDA kernel in
``csrc/block_sparse.cu``.  ``build_block_index`` (a copy of the JAX
package's) turns a static block-occupancy mask into a CSR-of-blocks index on
the host; ``BlockIndex.build`` uploads it once per weight, and every call
reuses it.  The kernel's k-loop visits only the occupied tiles, so compute
and weight traffic scale with density.

The kernel runs on bf16 tensor cores with float32 parity, and reads the
weights as three exact bf16 planes (``split_bf16``) of the occupied tiles
(``pack_tiles``), packed once when the index is built from the weights
(``BlockIndex.build(..., w=w)``, as ``dispatch.mlp_block_masks`` does), never
per call.  An index built from a mask alone serves the plain version; the
kernel refuses it.  The kernel takes an index's packed tiles only with the
weight they were packed from, unmodified since, and raises on any other.
The source gives the kernel's bound on the H100.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref

_SIGNATURES = {
    "repro_block_sparse_matmul": [build.PTR] * 6 + [build.INT] * 8 + [build.PTR, build.INT],
}
MAX_TILE = 32      # packed tile edge: bk and bn are at most this
_BM = 128          # csrc/block_sparse.cu's rows per block


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The exact three-way split of float32 ``x`` into bf16 terms,
    x = x0 + x1 + x2 (round to nearest at each step; csrc/split_mma.cuh
    ``split3`` does the same on the card)."""
    x = x.float()
    x0 = x.to(torch.bfloat16)
    r1 = x - x0.float()
    x1 = r1.to(torch.bfloat16)
    x2 = (r1 - x1.float()).to(torch.bfloat16)
    return x0, x1, x2


def _fragment_order() -> np.ndarray:
    """For each position p of a packed 32 x 32 tile, the row-major index
    k * 32 + n of the weight it holds: mma.sync m16n8k16 B fragments, for
    k16 step ks and n8 tile j, lane (g, t) = (lane // 4, lane % 4) holds
    (k, n) = (16 ks + 2t + {0, 1, 8, 9}, 8 j + g) at p = ((ks * 4 + j) * 32
    + lane) * 4 + {0, 1, 2, 3}."""
    ks, j, lane, i = np.meshgrid(np.arange(2), np.arange(4), np.arange(32), np.arange(4),
                                 indexing="ij")
    k = 16 * ks + 2 * (lane % 4) + (i & 1) + 8 * (i >> 1)
    n = 8 * j + lane // 4
    return (k * MAX_TILE + n).reshape(-1)


_FRAGMENT_ORDER = _fragment_order()


def pack_tiles(w: torch.Tensor, indices: np.ndarray, counts: np.ndarray, bk: int,
               bn: int) -> torch.Tensor:
    """The occupied (bk x bn) tiles of ``w`` [K, N] in the CSR order of
    (indices, counts) -- n-block by n-block, each n-block's tiles in index
    order -- each zero-padded to 32 x 32, split into three exact bf16 planes
    and laid out in mma fragment order (``_fragment_order``): [3, occupied,
    1024] bf16 on w's device, one contiguous 2 KB chunk per tile and plane."""
    K, N = w.shape
    tiles = w.detach().float().reshape(K // bk, bk, N // bn, bn)
    nbs = np.repeat(np.arange(len(counts)), counts)
    kbs = np.concatenate([indices[j, :c] for j, c in enumerate(counts)] + [np.zeros(0, np.int64)])
    sel = tiles[torch.as_tensor(kbs, dtype=torch.long, device=w.device), :,
                torch.as_tensor(nbs, dtype=torch.long, device=w.device), :]   # [occupied, bk, bn]
    padded = torch.zeros((len(nbs), MAX_TILE, MAX_TILE), dtype=torch.float32, device=w.device)
    padded[:, :bk, :bn] = sel
    order = torch.as_tensor(_FRAGMENT_ORDER, dtype=torch.long, device=w.device)
    flat = padded.reshape(len(nbs), MAX_TILE * MAX_TILE)[:, order]
    return torch.stack(split_bf16(flat))


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
    weight's device, with the weight's occupied tiles packed for the kernel
    when it was built from the weight."""

    mask: np.ndarray              # [K // bk, N // bn] bool
    bk: int
    bn: int
    indices: torch.Tensor         # [N // bn, max_nnz] int32
    counts: torch.Tensor          # [N // bn] int32
    max_nnz: int
    tiles: Optional[torch.Tensor] = None     # [3, occupied, 1024] bf16 (pack_tiles)
    offsets: Optional[torch.Tensor] = None   # [N // bn] int32: each n-block's first tile
    # the weight the tiles were packed from, and its version counter then
    source: Optional[torch.Tensor] = field(default=None, compare=False, repr=False)
    source_version: int = -1

    @classmethod
    def build(cls, mask: np.ndarray, bk: int, bn: int, device,
              w: Optional[torch.Tensor] = None) -> "BlockIndex":
        """The index of ``mask``; with ``w`` [K, N] also its packed tiles, on
        ``device``."""
        indices, counts, max_nnz = build_block_index(mask)
        tiles = offsets = None
        if w is not None:
            w = torch.as_tensor(w)
            tiles = pack_tiles(w.to(device), indices, counts, bk, bn)
            offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32))
            offsets = offsets.to(device)
        return cls(np.asarray(mask, bool), int(bk), int(bn),
                   torch.from_numpy(indices).to(device), torch.from_numpy(counts).to(device),
                   max_nnz, tiles, offsets, w, _version(w) if w is not None else -1)

    @property
    def occupied(self) -> int:
        return int(self.mask.sum())

    def check_weight(self, w: torch.Tensor) -> None:
        """Raise unless ``w`` is the weight the tiles were packed from (the
        same memory, shape and dtype; the index holds it, so its memory is
        never reused) and unmodified since (its version counter)."""
        src = self.source
        if src is None:
            return
        if (w.device != src.device or w.data_ptr() != src.data_ptr() or w.shape != src.shape
                or w.stride() != src.stride() or w.dtype != src.dtype):
            raise ValueError("block_sparse_matmul: w is not the weight this index's tiles were "
                             "packed from; build the index from it (BlockIndex.build(..., w=w))")
        if _version(w) != self.source_version:
            raise ValueError("block_sparse_matmul: w was modified after its tiles were packed; "
                             "build the index again")


def _version(w: torch.Tensor) -> int:
    """The tensor's in-place version counter (inference tensors keep none)."""
    return -1 if w.is_inference() else w._version


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor, index: BlockIndex) -> torch.Tensor:
    """x [M, K] fp32 @ w [K, N] over the occupied tiles of ``index`` ->
    [M, N] fp32.  A CPU tensor takes the plain version, which reads ``w``;
    a CUDA tensor launches the kernel, which reads the tiles packed in
    ``index`` and not ``w`` (so ``w`` must be the weight they were packed
    from, ``BlockIndex.check_weight``), or raises."""
    if x.device.type == "cpu":
        return ref.block_sparse_matmul(x, w, index.mask, index.bk, index.bn)
    build.require_cuda("block_sparse_matmul", x)
    if index.tiles is None:
        raise ValueError("block_sparse_matmul: the index holds no packed tiles; build it "
                         "with BlockIndex.build(mask, bk, bn, device, w=w)")
    index.check_weight(w)
    build.require_cuda("block_sparse_matmul", x, w, index.indices, index.counts, index.offsets,
                       index.tiles, dtype=None)
    M, K = x.shape
    K2, N = w.shape
    Kb, Nb = index.mask.shape
    if K != K2 or K != Kb * index.bk or N != Nb * index.bn:
        raise ValueError(f"block_sparse_matmul: x {tuple(x.shape)}, w {tuple(w.shape)} and a "
                         f"{Kb}x{Nb} mask of {index.bk}x{index.bn} tiles do not match")
    if not (1 <= index.bk <= MAX_TILE and 1 <= index.bn <= MAX_TILE):
        raise ValueError(f"block_sparse_matmul: tiles must be at most {MAX_TILE}x{MAX_TILE}")
    tiles = index.tiles
    if tiles.dtype != torch.bfloat16 or tiles.dim() != 3 or tiles.shape[0] != 3 or tiles.shape[2] != MAX_TILE ** 2:
        raise TypeError(f"block_sparse_matmul: packed tiles must be bf16 [3, occupied, {MAX_TILE ** 2}], "
                        f"got {tiles.dtype} {tuple(tiles.shape)}")
    # two blocks fit on an SM (csrc/block_sparse.cu: ~104 KB of ring, 103 registers)
    split = build.cluster_split(Nb * -(-M // _BM), index.max_nnz, 2 * build.sm_count(x.device.index))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = build.library("block_sparse", _SIGNATURES)
    err = lib.repro_block_sparse_matmul(
        out.data_ptr(), x.data_ptr(), tiles.data_ptr(), index.indices.data_ptr(),
        index.counts.data_ptr(), index.offsets.data_ptr(), M, K, N, index.bk, index.bn,
        index.max_nnz, tiles.shape[1], split, build.stream_of(x), x.device.index,
    )
    build.check(lib, err, "block_sparse_matmul")
    block_sparse_matmul.launches += 1
    return out


block_sparse_matmul.launches = 0
