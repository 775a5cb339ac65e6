"""AF8-weight matmul (paper §V-C: 8-bit multiply, 32-bit accumulate).

Replaces the Pallas kernel ``repro/kernels/adaptivfloat_k.py:99``
``_af_matmul_kernel`` (``pallas_call`` at :141) with the CUDA kernel in
``csrc/af_matmul.cu``.  The weights stay uint8 AdaptivFloat codes in device
memory and are decoded per tile in shared memory; fp32 FMAs accumulate.  It
is bound by operations on the H100 at the encoder's shapes; the source gives
the numbers.  The activation ``quantize`` kernel of the same JAX module
comes with the serving slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.adaptivfloat import AFFormat
from repro_torch.kernels import build, ref

_SIGNATURES = {
    "repro_af_matmul": [build.PTR] * 3 + [build.INT] * 6 + [build.PTR, build.INT],
}


def af_matmul(
    x: torch.Tensor,          # [M, K] fp32
    w_codes: torch.Tensor,    # [K, N] uint8 AF codes
    e_min: int,               # the codes' per-tensor exponent bias
    *,
    fmt: AFFormat = AFFormat(),
) -> torch.Tensor:
    """x @ decode(codes) -> [M, N] fp32.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if x.device.type == "cpu":
        return ref.af_matmul(x, w_codes, e_min, fmt)
    build.require_cuda("af_matmul", x)
    build.require_cuda("af_matmul", x, w_codes, dtype=None)     # same device, contiguous
    if w_codes.dtype != torch.uint8:
        raise TypeError(f"af_matmul: codes must be uint8, got {w_codes.dtype}")
    M, K = x.shape
    K2, N = w_codes.shape
    if K != K2:
        raise ValueError(f"af_matmul: x is [{M}, {K}] but codes are [{K2}, {N}]")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = build.library("af_matmul", _SIGNATURES)
    err = lib.repro_af_matmul(
        out.data_ptr(), x.data_ptr(), w_codes.data_ptr(), M, K, N, int(e_min),
        fmt.n_bits, fmt.n_exp, build.stream_of(x), x.device.index,
    )
    build.check(lib, err, "af_matmul")
    af_matmul.launches += 1
    return out


af_matmul.launches = 0
