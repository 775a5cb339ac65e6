"""AdaptivFloat kernels (paper §III-E + §V-C), the port of
``repro/kernels/adaptivfloat_k.py``.

1. ``quantize_groups`` — activation quantize-dequantize with one exponent
   bias per group of rows, the bias taken from the group's amax in the same
   launch.  Replaces the Pallas kernel ``_quantize_kernel`` (:41,
   ``pallas_call`` at :68) and the amax and bias its wrapper ``quantize``
   (:47-66) takes around it with the CUDA kernel in ``csrc/af_quantize.cu``
   (one thread-block cluster per group), bit-exact to its plain version on
   the CPU (``group_exp_bias`` + ``ref.quantize``).  ``quantize`` is the
   same source's entry with the biases given.
2. ``af_matmul`` — AF8-weight matmul (8-bit multiply, 32-bit accumulate).
   Replaces ``_af_matmul_kernel`` (:99, ``pallas_call`` at :141) with
   ``csrc/af_matmul.cu``: the weights stay uint8 codes in device memory and
   are decoded per tile, exactly, into bf16; x is split exactly into three
   bf16 terms, so three bf16 tensor-core passes give the float32 product
   (``csrc/split_mma.cuh``).  The wrapper picks how many blocks of a
   cluster split K when the output tiles alone would leave SMs idle.

The sources give each kernel's bound on the H100.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.adaptivfloat import AFFormat, exp_bias_from_amax
from repro_torch.kernels import build, ref

_SIGNATURES = {
    "repro_af_matmul": [build.PTR] * 3 + [build.INT] * 7 + [build.PTR, build.INT],
}
# csrc/af_matmul.cu's output tile and k-step
_AF_BM, _AF_BN, _AF_BK = 128, 128, 32
_Q_SIGNATURES = {
    "repro_af_quantize": [build.PTR] * 3 + [build.INT] * 5 + [build.PTR, build.INT],
    "repro_af_quantize_groups": [build.PTR] * 3 + [build.INT] * 5 + [build.PTR, build.INT],
}


def group_exp_bias(x: torch.Tensor, rows_per_group: int, fmt: AFFormat = AFFormat()) -> torch.Tensor:
    """Per-group AdaptivFloat bias of ``x`` [rows, d]: the amax over each
    group of ``rows_per_group`` rows (all of its columns) -> int32 e_min
    [groups], as ``quantize`` takes it."""
    rows, d = x.shape
    if rows % rows_per_group:
        raise ValueError(f"quantize: {rows} rows do not split into groups of {rows_per_group}")
    amax = x.detach().float().abs().reshape(rows // rows_per_group, rows_per_group * d).amax(dim=1)
    return exp_bias_from_amax(amax, fmt)


def quantize(
    x: torch.Tensor,              # [rows, d] fp32
    e_min: torch.Tensor,          # [groups] int32 per-group bias
    rows_per_group: int,
    *,
    fmt: AFFormat = AFFormat(),
) -> torch.Tensor:
    """Quantize-dequantize ``x`` to the AdaptivFloat grid, row group g with
    bias ``e_min[g]``.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    if x.device.type == "cpu":
        return ref.quantize(x, e_min, rows_per_group, fmt)
    build.require_cuda("quantize", x)
    build.require_cuda("quantize", x, e_min, dtype=None)
    rows, d = x.shape
    groups = -(-rows // rows_per_group)
    if e_min.dtype != torch.int32 or e_min.shape != (groups,):
        raise TypeError(f"quantize: e_min must be int32 [{groups}], got {e_min.dtype} {tuple(e_min.shape)}")
    out = torch.empty_like(x)
    lib = build.library("af_quantize", _Q_SIGNATURES)
    err = lib.repro_af_quantize(
        out.data_ptr(), x.data_ptr(), e_min.data_ptr(), rows, d, int(rows_per_group),
        fmt.n_bits, fmt.n_exp, build.stream_of(x), x.device.index,
    )
    build.check(lib, err, "quantize")
    quantize.launches += 1
    return out


quantize.launches = 0


def quantize_groups(
    x: torch.Tensor,              # [rows, d] fp32, rows = groups * rows_per_group
    rows_per_group: int,
    *,
    fmt: AFFormat = AFFormat(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-dequantize ``x`` with one bias per group of
    ``rows_per_group`` rows, each from its group's amax -> (quantized
    [rows, d], e_min [groups] int32).  A CPU tensor takes the plain version
    (``group_exp_bias`` then ``quantize``); a CUDA tensor launches the
    kernel, one launch for amax, bias and quantize, or raises.  Its
    launches count on ``quantize.launches`` (one kernel source)."""
    if x.device.type == "cpu":
        e_min = group_exp_bias(x, rows_per_group, fmt)
        return ref.quantize(x, e_min, rows_per_group, fmt), e_min
    build.require_cuda("quantize_groups", x)
    rows, d = x.shape
    if rows_per_group <= 0 or rows % rows_per_group:
        raise ValueError(f"quantize_groups: {rows} rows do not split into groups of {rows_per_group}")
    out = torch.empty_like(x)
    e_min = torch.empty(rows // rows_per_group, dtype=torch.int32, device=x.device)
    lib = build.library("af_quantize", _Q_SIGNATURES)
    err = lib.repro_af_quantize_groups(
        out.data_ptr(), e_min.data_ptr(), x.data_ptr(), rows, d, int(rows_per_group),
        fmt.n_bits, fmt.n_exp, build.stream_of(x), x.device.index,
    )
    build.check(lib, err, "quantize_groups")
    quantize.launches += 1
    return out, e_min


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
    # the kernel's decode is exact in bf16 (7 mantissa bits) only while a
    # code has at most 6: n_bits <= 8, as uint8 codes already imply
    if fmt.n_bits > 8:
        raise ValueError(f"af_matmul: AF({fmt.n_bits}, {fmt.n_exp}) codes do not fit in bf16")
    blocks = -(-M // _AF_BM) * -(-N // _AF_BN)
    split = build.cluster_split(blocks, -(-K // _AF_BK), build.sm_count(x.device.index))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = build.library("af_matmul", _SIGNATURES)
    err = lib.repro_af_matmul(
        out.data_ptr(), x.data_ptr(), w_codes.data_ptr(), M, K, N, int(e_min),
        fmt.n_bits, fmt.n_exp, split, build.stream_of(x), x.device.index,
    )
    build.check(lib, err, "af_matmul")
    af_matmul.launches += 1
    return out


af_matmul.launches = 0
