"""The deployed path's entry points to the kernels (the port of
``repro/kernels/ops.py`` for the four kernels on that path), and the launch
counters of all six kernels.  The serving step's ``dispatch.layernorm`` goes
through ``layernorm_op``; the deployed off-ramp runs ``offramp_head_op``.

Each op takes tensors in the layout the deployed model holds, reshapes them
for its kernel and routes by device like the kernels do: CPU tensors run the
plain versions, CUDA tensors launch the kernels.  ``span_attention_op``
keeps the deploy fast path of the JAX package: span-0 heads are gathered
out on the host, the survivors run with ``window`` = their largest span,
and dead heads get zero context vectors.  (The JAX package's traced-spans
branch exists only for ``jit`` and has no counterpart here.)
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.adaptive_span import active_head_indices
from repro_torch.core.adaptivfloat import AFFormat
from repro_torch.kernels import (
    adaptivfloat_k,
    block_sparse,
    layernorm,
    softmax_entropy,
    span_attention,
)

# every kernel, by name, with the wrapper that holds its launch count (a
# source's other entries count on the same: quantize_groups on quantize,
# offramp_head and entropy on softmax_entropy)
KERNEL_WRAPPERS = {
    "layernorm": layernorm.layernorm,
    "softmax_entropy": softmax_entropy.softmax_entropy,
    "af_matmul": adaptivfloat_k.af_matmul,
    "span_attention": span_attention.span_attention,
    "af_quantize": adaptivfloat_k.quantize,
    "block_sparse_matmul": block_sparse.block_sparse_matmul,
}
# the kernels each path launches: the deployed classifier
# (serving/deploy.py) and the serving engine's fused step (serving/engine.py;
# span_attention when the config has no trained spans, block_sparse_matmul
# when the MLP weights are block-pruned)
DEPLOY_KERNELS = ("layernorm", "softmax_entropy", "af_matmul", "span_attention")
SERVING_KERNELS = ("layernorm", "softmax_entropy", "af_quantize", "block_sparse_matmul",
                   "span_attention")
# the trace replay (launch/replay.py) serves every task through the same
# fused step, so it launches the serving path's kernels
REPLAY_KERNELS = SERVING_KERNELS
# the trained weights of the Fig. 6 pipeline (launch/finetune.py, chip_smoke's
# train phase) deployed and served: the deployed path's kernels and the
# serving kernels (serving keeps attention on the reference ops while the
# learned soft spans, span_z, are set: span_attention comes from the deploy)
FINETUNE_KERNELS = DEPLOY_KERNELS + tuple(k for k in SERVING_KERNELS if k not in DEPLOY_KERNELS)
# the decoder (DecoderServer with an exit threshold): the LM-head off-ramp's
# entropy after every layer (softmax_entropy's wide-row entry); its RMS
# norms, cache attention and dense matmuls have no kernel in either package
DECODE_KERNELS = ("softmax_entropy",)
# the MoE decoder through the same DecoderServer: the same off-ramp at
# qwen-moe's vocabulary width; routing, expert products and the shared
# expert are torch ops in both packages (no Pallas kernel in the JAX layer)
MOE_DECODE_KERNELS = ("softmax_entropy",)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def layernorm_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-6):
    shape = x.shape
    out = layernorm.layernorm(x.reshape(-1, shape[-1]).contiguous(), gamma, beta, eps=eps)
    return out.reshape(shape)


def softmax_entropy_op(
    logits: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused softmax + entropy over the last axis.

    The mask only zeroes probs (no renormalisation), and the entropy is that
    of the full softmax distribution; ``mask=None`` means no padding, the
    off-ramp case.
    """
    shape = logits.shape
    x2 = logits.reshape(-1, shape[-1]).contiguous()
    if mask is not None:
        if mask.shape != shape:
            raise ValueError(f"mask shape {tuple(mask.shape)} must match logits shape {tuple(shape)}")
        mask = mask.reshape(-1, shape[-1]).contiguous()
    p, h = softmax_entropy.softmax_entropy(x2, mask)
    return p.reshape(shape), h.reshape(shape[:-1])


def offramp_head_op(h: torch.Tensor, offramp: dict) -> torch.Tensor:
    """The deployed off-ramp (pooler, classifier, softmax entropy) on its
    AF8 weights in one kernel: h [B, S, D] -> packed [B, C + 2] rows
    [logits | entropy | retire] (retire unused: the deployed loop decides
    exits on the host)."""
    pw, cw = offramp["pooler_w"], offramp["cls_w"]
    return softmax_entropy.offramp_head(h, pw.codes, offramp["pooler_b"], cw.codes, offramp["cls_b"],
                                        e_min=(pw.e_min, cw.e_min), fmt=pw.fmt)


def af_matmul_op(x: torch.Tensor, w_codes: torch.Tensor, e_min: int, n_bits: int = 8, n_exp: int = 3):
    return adaptivfloat_k.af_matmul(x, w_codes, e_min, fmt=AFFormat(n_bits, n_exp))


def span_attention_op(
    q: torch.Tensor,           # [B, S, H, dh]
    k: torch.Tensor,           # [B, S, KV, dh]
    v: torch.Tensor,           # [B, S, KV, dh]
    spans: Sequence[int],      # per-head integer spans (len H; 0 = off), host-side
    *,
    causal: bool,
) -> torch.Tensor:
    """EdgeBERT deployed attention: dead heads skipped, survivors windowed.

    Returns [B, S, H, dh] with zero context vectors for span-0 heads (the
    accelerator writes zeros to the UAB for those heads, §V-D1).  When every
    head is live (and KV == H) the kernel reads q, k and v through permuted
    views and writes the [B, S, H, dh] result in place: no copies.
    """
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    spans_np = np.asarray(spans, np.int32)
    active, window = active_head_indices(spans_np)
    if len(active) == 0:
        return torch.zeros_like(q)

    if len(active) == H:
        kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        if G > 1:
            kh, vh = kh.repeat_interleave(G, dim=1), vh.repeat_interleave(G, dim=1)
        out = torch.empty((B, Sq, H, dh), dtype=q.dtype, device=q.device)
        span_attention.span_attention_heads(
            q.permute(0, 2, 1, 3), kh, vh, _head_spans(spans_np, q.device), int(window),
            causal=causal, out=out.permute(0, 2, 1, 3))
        return out

    # gather the active heads as [B, Ha, S, dh]; row bh = b * Ha + h
    act = torch.as_tensor(active, device=q.device)
    kv_idx = torch.as_tensor(active // G, device=q.device)
    qh = q.permute(0, 2, 1, 3).index_select(1, act)
    kh = k.permute(0, 2, 1, 3).index_select(1, kv_idx)
    vh = v.permute(0, 2, 1, 3).index_select(1, kv_idx)
    out = span_attention.span_attention_heads(
        qh, kh, vh, _head_spans(spans_np[active], q.device), int(window), causal=causal)

    full = torch.zeros((B, H, Sq, dh), dtype=q.dtype, device=q.device)
    full.index_copy_(1, act, out)
    return full.permute(0, 2, 1, 3)


_HEAD_SPANS: dict = {}


def _head_spans(spans_np: np.ndarray, device: torch.device) -> torch.Tensor:
    """The per-head spans as an int32 tensor on ``device``, uploaded once
    per distinct set of spans (the deployed spans are fixed registers)."""
    key = (spans_np.tobytes(), str(device))
    t = _HEAD_SPANS.get(key)
    if t is None:
        t = _HEAD_SPANS[key] = torch.as_tensor(spans_np, dtype=torch.int32, device=device)
    return t
