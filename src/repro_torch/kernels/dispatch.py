"""Reference/kernel dispatch for the serving engine's fused step
(``use_kernels=``), the port of ``repro/kernels/dispatch.py``.

The serving step is built from the model's layer math; this module is the
one seam where that math goes to the hand-written kernels instead of the
reference PyTorch ops.  Call sites guard with ``if use_kernels:`` so the
reference route stays op for op the JAX package's ``use_pallas=False`` path.

The eligibility rules are the JAX package's:

  * soft (trained) spans taper probabilities over a ramp; the hard-window
    span kernel cannot reproduce that, so ``span_z is not None`` call sites
    keep reference attention.  Dense (no-span) attention goes to the span
    kernel with a full window plus per-row ``kv_len`` masking;
  * block-sparse MLP needs a static occupancy mask: ``mlp_block_masks``
    derives one from the concrete (pruned) weights when the server is
    built, with the CSR index and the kernel's packed bf16 tile planes
    beside it.  Fully occupied weights map to None and their matmuls stay
    dense;
  * KV-cache decode attention stays on the reference ops (the JAX package
    fuses the cache update and the AF8 codec with it), and RMS norm has no
    kernel: the decoder's kernel route is the LM-head off-ramp's entropy.

Each wrapper below routes by device as the kernels do: CPU tensors take the
plain versions, CUDA tensors launch the kernels.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.adaptivfloat import AFFormat
from repro_torch.core.early_exit import OfframpParams
from repro_torch.kernels import adaptivfloat_k, block_sparse, ops
from repro_torch.kernels import softmax_entropy as _sm_k
from repro_torch.kernels import span_attention as _span_k


# ---------------------------------------------------------------------------
# LayerNorm (Eq. 5 running moments)
# ---------------------------------------------------------------------------


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *, eps: float = 1e-6):
    """Fused two-moment LayerNorm over the last axis; any leading shape."""
    return ops.layernorm_op(x.float(), scale.float(), bias.float(), eps).to(x.dtype)


# ---------------------------------------------------------------------------
# Off-ramp entropy (Eq. 4)
# ---------------------------------------------------------------------------


def offramp_head(
    h: torch.Tensor,               # [lanes, S_bucket, D]
    offramp: OfframpParams,
    active: torch.Tensor,          # [lanes] bool
    threshold: float,
) -> torch.Tensor:
    """The serving step's off-ramp in one kernel: pooler, classifier,
    entropy and retire -> packed [lanes, C + 2] fp32 rows [logits | entropy
    | retire as 1.0 / 0.0] (``softmax_entropy.offramp_head``).  The entropy
    has no mask: off-ramp logits are [lanes, C] class scores with no padded
    positions (lane padding is masked upstream, in attention)."""
    return _sm_k.offramp_head(h.float(), offramp.pooler_w.float(), offramp.pooler_b.float(),
                              offramp.cls_w.float(), offramp.cls_b.float(), active=active,
                              threshold=threshold)


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Entropy of softmax(logits) over the last axis -> logits.shape[:-1]
    (the JAX package's ``dispatch.entropy``, which throws the kernel's probs
    away): the decoder's LM-head off-ramp, [lanes, 1, V] logits, through
    the wide-row entry ``softmax_entropy.entropy``: fp32 or bf16 logits
    (the decoders' own dtype), computed in fp32."""
    shape = logits.shape
    return _sm_k.entropy(logits.reshape(-1, shape[-1])).reshape(shape[:-1])


# ---------------------------------------------------------------------------
# AdaptivFloat activation quantization
# ---------------------------------------------------------------------------


def act_quantize(x: torch.Tensor, n_bits: int, n_exp: int, *, groups: int = 1) -> torch.Tensor:
    """Quantize-dequantize ``x`` with one bias per slice of its leading axis
    split into ``groups`` (the serving step passes one group per lane, as
    the JAX package's ``vmap`` over lanes gives each lane its own amax over
    its whole padded ``[S_bucket, D]`` slab): one launch for the amaxes,
    biases and quantization."""
    shape = x.shape
    x2 = (x.reshape(-1, shape[-1]) if x.ndim > 1 else x.reshape(1, -1)).float().contiguous()
    if x2.shape[0] % groups:
        raise ValueError(f"act_quantize: {x2.shape[0]} rows do not split into {groups} groups")
    out, _ = adaptivfloat_k.quantize_groups(x2, x2.shape[0] // groups, fmt=AFFormat(n_bits, n_exp))
    return out.reshape(shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense (full-window) attention via the span kernel
# ---------------------------------------------------------------------------


def dense_attention(
    q: torch.Tensor,              # [B, Sq, H, dh]
    k: torch.Tensor,              # [B, Sk, KV, dh]
    v: torch.Tensor,              # [B, Sk, KV, dh]
    *,
    causal: bool,
    kv_len: Optional[torch.Tensor] = None,   # [B] (or scalar) valid keys per row
    window: Optional[int] = None,            # None: Sk (full attention)
) -> torch.Tensor:
    """Span kernel with window = Sk (full attention; or ``window``, the
    encoder family's local layers: |i - j| < window) and per-row kv_len:
    the serving step's attention, whose lanes are right-padded to the bucket
    length and carry their true lengths.  The kernel reads q, k and v
    through permuted views and writes the [B, Sq, H, dh] result in place;
    only grouped KV heads (KV < H) are expanded first."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    kh, vh = k.float().permute(0, 2, 1, 3), v.float().permute(0, 2, 1, 3)
    if G > 1:
        kh, vh = kh.repeat_interleave(G, dim=1), vh.repeat_interleave(G, dim=1)
    kvl = None
    if kv_len is not None:
        kvl = torch.as_tensor(kv_len, device=q.device).to(torch.int32).reshape(-1).expand(B)
    out = torch.empty((B, Sq, H, dh), dtype=torch.float32, device=q.device)
    _span_k.span_attention_heads(q.float().permute(0, 2, 1, 3), kh, vh, None, window or k.shape[1],
                                 causal=causal, kv_lens=kvl, out=out.permute(0, 2, 1, 3))
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Block-sparse MLP matmuls (§V-C tile skip)
# ---------------------------------------------------------------------------


def _block_size(dim: int, want: int) -> int:
    b = min(want, dim)
    while dim % b:
        b -= 1
    return b


def mlp_block_masks(
    mlp_params: Dict[str, Any], bk: int = 32, bn: int = 32
) -> Dict[str, Optional[block_sparse.BlockIndex]]:
    """Static occupancy masks for each MLP weight matrix, from concrete
    (post-pruning) weights at server build time, each with its CSR index
    and its occupied tiles packed for the kernel (``block_sparse.pack_tiles``,
    once here and never per call) on the weight's device.  Fully occupied
    matrices map to None: dense weights gain nothing from tile skipping."""
    masks: Dict[str, Optional[block_sparse.BlockIndex]] = {}
    for name in ("w_gate", "w_up", "w_down"):
        w = mlp_params.get(name)
        if w is None:
            continue
        wn = torch.as_tensor(w).detach().to("cpu", torch.float32).numpy()
        K, N = wn.shape
        bk_, bn_ = _block_size(K, bk), _block_size(N, bn)
        occ = np.abs(wn.reshape(K // bk_, bk_, N // bn_, bn_)).sum(axis=(1, 3)) > 0
        w = torch.as_tensor(w)
        masks[name] = (None if occ.all()
                       else block_sparse.BlockIndex.build(occ, bk_, bn_, w.device, w=w))
    return masks


def sparse_matmul(x: torch.Tensor, w: torch.Tensor, mask: block_sparse.BlockIndex) -> torch.Tensor:
    """x @ w skipping pruned (all-zero) weight tiles; any leading shape.
    ``w`` goes through as it is: the index's packed tiles stand for it."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).float().contiguous()
    out = block_sparse.block_sparse_matmul(x2, w, mask)
    return out.reshape(*shape[:-1], w.shape[1]).to(x.dtype)
