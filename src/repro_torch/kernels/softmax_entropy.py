"""Fused softmax + entropy (paper Alg. 1 + Eq. 4: the GB unit), alone and
as the last stage of the off-ramp head.

Replaces the Pallas kernel ``repro/kernels/softmax_entropy.py:17``
``_sm_ent_kernel`` (``pallas_call`` at :48) with the CUDA kernels in
``csrc/softmax_entropy.cu``.  The mask multiplies the probs and is not
renormalised; the entropy is that of the unmasked distribution, clamped at
0.  Three entry points of the one source:

* ``offramp_head`` — what the classifier paths run after a layer, in one
  launch: pooler (tanh), classifier, softmax and entropy, and the retire
  mask, into one packed [B, C + 2] row per sentence, reading the CLS rows
  of ``h`` by stride; fp32 weights (serving) or AF8 codes (deployed);
* ``entropy`` — the entropy alone of rows of vocabulary width, what the
  decoder's LM-head off-ramp runs after every layer (``dispatch.entropy``):
  a thread-block cluster per row, no probs written;
* ``softmax_entropy`` — given logits (+ mask), probs and entropy, one warp
  per row.

All count their launches on ``softmax_entropy.launches``.  The source
gives the bounds.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.adaptivfloat import AFFormat
from repro_torch.kernels import build, ref

_SIGNATURES = {
    "repro_softmax_entropy": [build.PTR] * 4 + [build.INT, build.INT, build.PTR, build.INT],
    "repro_offramp_head": [build.PTR] * 4 + [build.INT64] + [build.INT] * 3 + [build.PTR] * 5
    + [build.FLOAT] + [build.INT] * 5 + [build.PTR, build.INT],
    "repro_offramp_head_blocks": [build.INT],
    "repro_entropy_rows": [build.PTR, build.PTR, build.INT, build.INT, build.INT, build.PTR, build.INT],
}


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


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """logits [rows, n] fp32 or bf16 -> the entropy of softmax over each
    row, [rows] fp32, clamped at 0 (no probs).  bf16 rows are read as they
    are and computed in fp32, as the JAX kernel casts its rows.  A CPU
    tensor takes the plain version (``ref.softmax_entropy``); a CUDA tensor
    launches the kernel, one thread-block cluster per row, or raises: it
    must be a contiguous fp32 or bf16 matrix of at most 65535 rows."""
    if logits.device.type == "cpu":
        return ref.softmax_entropy(logits)[1]
    build.require_cuda("entropy", logits, dtype=None)
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"entropy: expected torch.float32 or torch.bfloat16, got {logits.dtype}")
    if logits.ndim != 2 or logits.shape[0] > 65535 or logits.shape[1] == 0:
        raise ValueError(f"entropy: logits must be [rows <= 65535, n > 0], got {tuple(logits.shape)}")
    rows, n = logits.shape
    ent = torch.empty(rows, dtype=torch.float32, device=logits.device)
    lib = build.library("softmax_entropy", _SIGNATURES)
    err = lib.repro_entropy_rows(ent.data_ptr(), logits.data_ptr(), rows, n, int(logits.dtype == torch.bfloat16),
                                 build.stream_of(logits), logits.device.index)
    build.check(lib, err, "entropy")
    softmax_entropy.launches += 1
    return ent

# per (device, stream): the head's launch counter (zero between launches)
# and its partial-sum scratch, grown to the largest launch seen.  The
# launches of one stream run one after another, so they share them safely;
# launches on two streams never share them.  (A CUDA graph that captures a
# launch keeps its stream's pair: two replays must not run at once.)
_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws[1].numel() < n:
        counter = ws[0] if ws is not None else torch.zeros(1, dtype=torch.int32, device=device)
        ws = _WORKSPACE[key] = (counter, torch.empty(max(n, 1), dtype=torch.float32, device=device))
    return ws


def offramp_head(
    h: torch.Tensor,                # [B, S, D] fp32, D contiguous; CLS rows h[:, 0, :]
    pooler_w: torch.Tensor,         # [D, D] fp32, or uint8 AF codes
    pooler_b: torch.Tensor,         # [D] fp32
    cls_w: torch.Tensor,            # [D, C] fp32, or uint8 AF codes
    cls_b: torch.Tensor,            # [C] fp32
    *,
    active: Optional[torch.Tensor] = None,    # [B] bool; None = all active
    threshold: float = 0.0,
    e_min: Optional[Tuple[int, int]] = None,  # (pooler, cls) biases when the weights are codes
    fmt: AFFormat = AFFormat(),
) -> torch.Tensor:
    """The off-ramp: tanh(h[:, 0, :] @ pooler_w + pooler_b) @ cls_w + cls_b,
    its softmax entropy, and retire = active & (entropy < threshold), as
    one packed [B, C + 2] fp32 tensor [logits | entropy | retire as 1.0 /
    0.0].  A CPU tensor takes the plain version (``ref.offramp_head``); a
    CUDA tensor launches the kernel, which reads the CLS rows by the batch
    stride, or raises."""
    if h.device.type == "cpu":
        return ref.offramp_head(h, pooler_w, pooler_b, cls_w, cls_b, active, threshold, e_min, fmt)
    build.require_cuda("offramp_head", h, contiguous=False)
    build.require_cuda("offramp_head", pooler_b, cls_b)
    build.require_cuda("offramp_head", pooler_w, cls_w, dtype=torch.uint8 if e_min is not None else torch.float32)
    B, _, D = h.shape
    C = cls_w.shape[1]
    if h.stride(2) != 1:
        raise ValueError("offramp_head: h must be contiguous along its last axis")
    if pooler_w.shape != (D, D) or cls_w.shape != (D, C) or pooler_b.shape != (D,) or cls_b.shape != (C,):
        raise ValueError(f"offramp_head: weights {tuple(pooler_w.shape)}, {tuple(pooler_b.shape)}, "
                         f"{tuple(cls_w.shape)}, {tuple(cls_b.shape)} do not fit h {tuple(h.shape)}")
    if active is not None:
        build.require_cuda("offramp_head", h, active, dtype=None, contiguous=False)
        if active.dtype != torch.bool or active.shape != (B,) or not active.is_contiguous():
            raise TypeError(f"offramp_head: active must be a contiguous bool [{B}] tensor")
    if e_min is not None and fmt.n_bits > 8:
        raise ValueError(f"offramp_head: AF({fmt.n_bits}, {fmt.n_exp}) codes do not fit in uint8")
    lib = build.library("softmax_entropy", _SIGNATURES)
    stream = build.stream_of(h)
    counter, partial = _workspace(h.device, stream, lib.repro_offramp_head_blocks(D) * B * C)
    out = torch.empty((B, C + 2), dtype=torch.float32, device=h.device)
    pe, ce = e_min if e_min is not None else (0, 0)
    err = lib.repro_offramp_head(
        out.data_ptr(), partial.data_ptr(), counter.data_ptr(), h.data_ptr(), h.stride(0), B, D, C,
        pooler_w.data_ptr(), pooler_b.data_ptr(), cls_w.data_ptr(), cls_b.data_ptr(),
        None if active is None else active.data_ptr(), float(threshold), int(e_min is not None),
        int(pe), int(ce), fmt.n_bits, fmt.n_exp, stream, h.device.index,
    )
    build.check(lib, err, "offramp_head")
    softmax_entropy.launches += 1
    return out
