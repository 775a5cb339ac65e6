"""Bitmask sparse encoding (paper §V-C): binary tags for zero/non-zero entries;
only non-zeros are stored.  This is the *storage* format (checkpoint + eNVM
accounting, the paper's 12% overhead figure); a copy of the JAX package's
``core/bitmask.py`` (numpy only).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class BitmaskEncoded(NamedTuple):
    bitmask: np.ndarray      # packed uint8, 1 bit per element (stored in SLC)
    values: np.ndarray       # non-zero values in row-major order
    shape: Tuple[int, ...]
    dtype: np.dtype


def encode(arr: np.ndarray) -> BitmaskEncoded:
    arr = np.asarray(arr)
    flat = arr.reshape(-1)
    nz = flat != 0
    return BitmaskEncoded(
        bitmask=np.packbits(nz),
        values=flat[nz].copy(),
        shape=arr.shape,
        dtype=arr.dtype,
    )


def decode(enc: BitmaskEncoded) -> np.ndarray:
    n = int(np.prod(enc.shape))
    nz = np.unpackbits(enc.bitmask, count=n).astype(bool)
    out = np.zeros(n, dtype=enc.dtype)
    out[nz] = enc.values
    return out.reshape(enc.shape)


def storage_bytes(enc: BitmaskEncoded, value_bits: int = 8) -> dict:
    """Storage accounting: paper reports the bitmask as a 12% overhead on top
    of 8-bit non-zero values at 60% embedding sparsity (1 bit per element ~=
    12.5% of the dense 8-bit footprint; relative to the 40%-density value
    payload it is ~31%)."""
    n = int(np.prod(enc.shape))
    mask_bytes = len(enc.bitmask)
    value_bytes = len(enc.values) * value_bits // 8
    dense_bytes = n * value_bits // 8
    return {
        "mask_bytes": mask_bytes,
        "value_bytes": value_bytes,
        "total_bytes": mask_bytes + value_bytes,
        "dense_bytes": dense_bytes,
        "compression": dense_bytes / max(mask_bytes + value_bytes, 1),
        "mask_overhead_vs_dense": mask_bytes / max(dense_bytes, 1),
    }
