"""Embedded non-volatile memory (eNVM) model: MLC ReRAM storage of the frozen
embedding table (paper §III-D, Table III, Fig. 11).

Faults are injected into the stored uint8 AF codes, grouped into 1/2/3-bit
cells; a faulty cell's level shifts by +/-1.  The fault draws come from
numpy's seeded generator in the same order as the JAX package's
``core/envm.py``, so given identical AF codes the readback is bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import adaptivfloat as af
from repro_torch.core import bitmask as bm
from repro_torch.core.adaptivfloat import AFFormat


@dataclass(frozen=True)
class CellConfig:
    name: str
    bits_per_cell: int
    area_mm2_per_mb: float   # paper Table III
    read_latency_ns: float   # paper Table III
    ber: float               # per-cell fault probability (calibration anchor)


CELL_CONFIGS: Dict[str, CellConfig] = {
    "SLC": CellConfig("SLC", 1, 0.28, 1.21, 1e-8),
    "MLC2": CellConfig("MLC2", 2, 0.08, 1.54, 1e-6),
    "MLC3": CellConfig("MLC3", 3, 0.04, 2.96, 2e-3),
}


def inject_cell_faults(
    codes: np.ndarray, cell: CellConfig, rng: np.random.Generator
) -> np.ndarray:
    """Flip MLC levels of stored uint8 codes (+/-1 level, saturating)."""
    codes = np.asarray(codes, dtype=np.uint8).copy()
    bpc = cell.bits_per_cell
    n_cells_per_code = -(-8 // bpc)
    flat = codes.reshape(-1)
    for ci in range(n_cells_per_code):
        shift = ci * bpc
        n_bits = min(bpc, 8 - shift)
        if n_bits <= 0:
            continue
        mask = (1 << n_bits) - 1
        level = (flat >> shift) & mask
        faulty = rng.random(flat.shape) < cell.ber
        direction = rng.integers(0, 2, flat.shape) * 2 - 1
        new_level = np.clip(level.astype(np.int32) + direction, 0, mask).astype(np.uint8)
        level = np.where(faulty, new_level, level)
        flat = (flat & ~np.uint8(mask << shift)) | (level << np.uint8(shift))
    return flat.reshape(codes.shape).astype(np.uint8)


def store_and_readback(
    embedding: np.ndarray,
    data_cell: str = "MLC2",
    mask_cell: str = "SLC",
    fmt: AFFormat = AFFormat(),
    seed: int = 0,
) -> Tuple[np.ndarray, dict]:
    """Full eNVM round-trip for the embedding table, on the host.

    1. bitmask-encode the (pruned) embedding;
    2. AF8-encode the non-zero values -> uint8 codes;
    3. inject faults: bitmask bits in `mask_cell` (SLC), codes in `data_cell`;
    4. decode back to floats (what the accelerator reads after power-on).
    """
    rng = np.random.default_rng(seed)
    enc = bm.encode(embedding)
    codes_t, e_min = af.af_encode(torch.from_numpy(np.asarray(enc.values)), fmt)
    codes = codes_t.numpy()

    faulty_mask_bits = inject_cell_faults(enc.bitmask, CELL_CONFIGS[mask_cell], rng)
    faulty_codes = inject_cell_faults(codes, CELL_CONFIGS[data_cell], rng)

    values = af.af_decode(torch.from_numpy(faulty_codes), e_min, fmt).numpy()
    n = int(np.prod(enc.shape))
    nz = np.unpackbits(faulty_mask_bits, count=n).astype(bool)
    out = np.zeros(n, dtype=np.float32)
    # a flipped bitmask bit changes which slots receive values: the values
    # stream fills the 'on' bits in order
    n_vals = min(int(nz.sum()), len(values))
    idx = np.nonzero(nz)[0][:n_vals]
    out[idx] = values[:n_vals]
    stats = {
        "n_mask_bit_flips": int(
            (np.unpackbits(faulty_mask_bits, count=n) != np.unpackbits(enc.bitmask, count=n)).sum()
        ),
        "n_code_faults": int((faulty_codes != codes).sum()),
        "storage": bm.storage_bytes(enc, value_bits=fmt.n_bits),
    }
    return out.reshape(enc.shape), stats
