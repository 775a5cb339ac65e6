"""Fused LayerNorm (paper §V-D3: the GB LayerNorm unit, Eq. 5).

Replaces the Pallas kernel ``repro/kernels/layernorm.py:17``
``_layernorm_kernel`` (``pallas_call`` at :44) with the CUDA kernel in
``csrc/layernorm.cu``: one warp per row, fp32 sums of x and x*x, fused
gamma/beta.  It is bound by bytes on the H100 (one read and one write of
the rows); the source says what its simple design leaves for later.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

_SIGNATURES = {"repro_layernorm": [build.PTR] * 4 + [build.INT, build.INT, build.FLOAT, build.PTR, build.INT]}


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: [rows, d] (callers flatten leading dims).  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return ref.layernorm(x, gamma, beta, eps)
    build.require_cuda("layernorm", x, gamma, beta)
    rows, d = x.shape
    if gamma.shape != (d,) or beta.shape != (d,):
        raise ValueError(f"layernorm: gamma/beta must be [{d}]")
    out = torch.empty_like(x)
    lib = build.library("layernorm", _SIGNATURES)
    err = lib.repro_layernorm(
        out.data_ptr(), x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        rows, d, eps, build.stream_of(x), x.device.index,
    )
    build.check(lib, err, "layernorm")
    layernorm.launches += 1
    return out


layernorm.launches = 0
