"""Fused softmax + entropy (paper Alg. 1 + Eq. 4: the GB unit).

Replaces the Pallas kernel ``repro/kernels/softmax_entropy.py:17``
``_sm_ent_kernel`` (``pallas_call`` at :48) with the CUDA kernel in
``csrc/softmax_entropy.cu``: one warp per row.  The mask multiplies the
probs and is not renormalised; the entropy is that of the unmasked
distribution, clamped at 0.  At the off-ramp's [B, 3] logits its time is
launch latency; the source gives the bound.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref

_SIGNATURES = {"repro_softmax_entropy": [build.PTR] * 4 + [build.INT, build.INT, build.PTR, build.INT]}


def softmax_entropy(
    logits: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [rows, n] (+ mask [rows, n], None = all ones) -> (probs
    [rows, n], entropy [rows] fp32).  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel or raises."""
    if logits.device.type == "cpu":
        return ref.softmax_entropy(logits, mask)
    tensors = (logits,) if mask is None else (logits, mask)
    build.require_cuda("softmax_entropy", *tensors)
    rows, n = logits.shape
    if mask is not None and mask.shape != logits.shape:
        raise ValueError(f"softmax_entropy: mask shape {tuple(mask.shape)} != logits {tuple(logits.shape)}")
    probs = torch.empty_like(logits)
    ent = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lib = build.library("softmax_entropy", _SIGNATURES)
    err = lib.repro_softmax_entropy(
        probs.data_ptr(), ent.data_ptr(), logits.data_ptr(),
        None if mask is None else mask.data_ptr(),
        rows, n, build.stream_of(logits), logits.device.index,
    )
    build.check(lib, err, "softmax_entropy")
    softmax_entropy.launches += 1
    return probs, ent


softmax_entropy.launches = 0
