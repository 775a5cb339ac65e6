"""Span-windowed attention (paper §III-B + §V-D1).

Replaces the Pallas kernel ``repro/kernels/span_attention.py:32``
``_span_attn_kernel`` (``pallas_call`` at :176) with the CUDA kernel in
``csrc/span_attention.cu``: a flash-attention forward on bf16 tensor cores
(``mma.sync``) over an exact three-way split of its float32 operands, one
block per (row, 64-query tile), which reads its own span and kv_len and
visits only the key tiles inside the row's window and below its kv_len.
Element mask: causal ``0 <= i-j < span`` or bidirectional ``|i-j| < span``,
and ``j < kv_len``; float32 online softmax; a row with no visible key
returns zeros.  The source gives its bound on the H100.

Long full-window rows (``long_rows``: dh 64, bidirectional, no per-head
spans, every key in every query's window, Sq and Sk of 1024 and more, as in
ModernBERT's global layers at buckets 2048-8192) go to the Hopper kernel in
``csrc/span_attention_long.cu`` instead: K and V split once into bf16
planes by a pre-pass, then 128-query blocks whose producer warpgroup
streams the planes by TMA and whose two consumer warpgroups run the same
six-product chains on ``wgmma``.  Both kernels count in
``span_attention.launches``; the long one also in
``span_attention.long_launches``, a count that only grows (read it before
and after: ``ops.reset_launch_counts`` leaves it).

``span_attention_heads`` takes ``[B, H, S, dh]`` operands with any strides
whose last one is 1 (the callers pass permuted ``[B, S, H, dh]`` views) and
can write into a given output view, so the layout changes around the
kernel cost no copies; ``span_attention`` on ``[BH, S, dh]`` is the public
contract and one stride case of it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

_SIGNATURES = {
    "repro_span_attention": [build.PTR] * 6 + [build.INT] * 7 + [build.FLOAT] + [build.INT64] * 16
    + [build.PTR, build.INT],
}
_LONG_SIGNATURES = {
    "repro_span_attention_long": [build.PTR] * 6 + [build.INT] * 4 + [build.FLOAT] + [build.INT64] * 14
    + [build.PTR, build.INT],
}
HEAD_DIMS = (16, 32, 64, 128)
LONG_MIN_ROWS = 1024      # the long kernel's least Sq and Sk
LONG_KEY_TILE = 64        # keys per plane tile of the long kernel
LONG_TILE_BYTES = 6 * LONG_KEY_TILE * 64 * 2   # three bf16 planes of K and of V^T per tile


def long_rows(dh: int, causal: bool, per_head_spans: bool, window: int, Sq: int, Sk: int) -> bool:
    """Whether a call goes to the long-row kernel: head dim 64, bidirectional,
    no per-head spans, a window that holds every key of every query (|i - j|
    < window for all i < Sq, j < Sk), and Sq and Sk of at least
    ``LONG_MIN_ROWS``, so that its pre-pass is spread over many query
    tiles.  Decided from the call's shapes alone."""
    return (dh == 64 and not causal and not per_head_spans and window >= max(Sq, Sk)
            and Sq >= LONG_MIN_ROWS and Sk >= LONG_MIN_ROWS)


def _per_row(t: Optional[torch.Tensor], B: int, H: int, per_head: bool, what: str):
    """``t`` with its (batch, head) element strides as a [B, H] table (a 1-D
    ``t`` is per head or per batch row, as ``per_head`` says), or None."""
    if t is None:
        return None
    if t.dtype != torch.int32:
        raise TypeError(f"span_attention: {what} must be int32, got {t.dtype}")
    shape, n = t.shape, (H if per_head else B)
    if len(shape) == 1 and shape[0] in (1, n):
        st = t.stride(0) if shape[0] == n else 0
        return t, ((0, st) if per_head else (st, 0))
    if len(shape) == 2 and shape[0] in (1, B) and shape[1] in (1, H):
        sb, sh = t.stride()
        return t, (sb if shape[0] == B else 0, sh if shape[1] == H else 0)
    raise ValueError(f"span_attention: {what} of shape {tuple(shape)} is not [B, H] = [{B}, {H}]")


def _launch(out, q, k, v, sp, kvl, B, H, Sq, Sk, dh, window, causal, short_only: bool = False) -> None:
    """The kernel on CUDA tensors; ``sp`` and ``kvl`` are (tensor, [B, H]
    strides) or None.  ``short_only`` keeps the short-row kernel where
    ``long_rows`` would pick the long one (a comparison at the same shape)."""
    dev = build.require_cuda("span_attention", q, k, v, out, contiguous=False)
    qs, ks, vs, os_ = strides = (q.stride(), k.stride(), v.stride(), out.stride())
    ptrs = (out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) & 15 or any(st[3] != 1 or (st[0] | st[1] | st[2]) & 3
                                                            for st in strides):
        raise ValueError("span_attention: the dh axis must be contiguous and every row 16-byte aligned")
    for x in (sp, kvl):
        if x is not None and x[0].get_device() != dev:
            raise ValueError(f"span_attention: spans and kv_lens must be on cuda:{dev}, got {x[0].device}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"span_attention: head dim {dh} not in {HEAD_DIMS}")
    if not short_only and long_rows(dh, bool(causal), sp is not None, window, Sq, Sk):
        _launch_long(out, q, k, v, kvl, B, H, Sq, Sk, dev, strides, ptrs)
        return
    lib = build.library("span_attention", _SIGNATURES)
    err = lib.repro_span_attention(
        *ptrs,
        None if sp is None else sp[0].data_ptr(), None if kvl is None else kvl[0].data_ptr(),
        B, H, Sq, Sk, dh, window, causal, _SCALE[dh],
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], os_[0], os_[1], os_[2],
        *((0, 0) if sp is None else sp[1]), *((0, 0) if kvl is None else kvl[1]),
        build.stream_of(q), dev,
    )
    if err:
        build.check(lib, err, "span_attention")
    span_attention.launches += 1


def _launch_long(out, q, k, v, kvl, B, H, Sq, Sk, dev, strides, ptrs) -> None:
    """The long-row kernel and its pre-pass; the planes' scratch comes from
    PyTorch's allocator on the call's stream."""
    (qs, ks, vs, os_) = strides
    planes = torch.empty(B * H * (-(-Sk // LONG_KEY_TILE)) * LONG_TILE_BYTES, dtype=torch.uint8, device=q.device)
    lib = build.library("span_attention_long", _LONG_SIGNATURES)
    err = lib.repro_span_attention_long(
        *ptrs, None if kvl is None else kvl[0].data_ptr(), planes.data_ptr(),
        B, H, Sq, Sk, _SCALE[64],
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], os_[0], os_[1], os_[2],
        *((0, 0) if kvl is None else kvl[1]),
        build.stream_of(q), dev,
    )
    if err:
        build.check(lib, err, "span_attention (long rows)")
    span_attention.launches += 1
    span_attention.long_launches += 1


_SCALE = {dh: 1.0 / math.sqrt(dh) for dh in HEAD_DIMS}


def span_attention_heads(
    q: torch.Tensor,              # [B, H, Sq, dh]
    k: torch.Tensor,              # [B, H, Sk, dh] (expanded per head)
    v: torch.Tensor,              # [B, H, Sk, dh]
    spans: Optional[torch.Tensor],  # int32 [H] or [B, H]; None = every span is `window`
    window: int,                  # static max span over the rows
    *,
    causal: bool,
    kv_lens: Optional[torch.Tensor] = None,   # int32 [B] or [B, H] valid keys per row
    out: Optional[torch.Tensor] = None,       # [B, H, Sq, dh] view to write into
) -> torch.Tensor:
    """Hard-span attention over rows (b, h), operands with any strides whose
    last one is 1.  Every span must be at most ``window``.  Returns ``out``
    (a fresh contiguous tensor when None).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    B, H, Sq, dh = q.shape
    Sk = k.shape[2]
    if k.shape != (B, H, Sk, dh) or v.shape != k.shape:
        raise ValueError(f"span_attention: k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if out is not None and out.shape != q.shape:
        raise ValueError(f"span_attention: out {tuple(out.shape)} does not match q {tuple(q.shape)}")
    sp = _per_row(spans, B, H, True, "spans")
    kvl = _per_row(kv_lens, B, H, False, "kv_lens")
    if q.is_cpu:
        sp = torch.full((B, H), int(window), dtype=torch.int32) if sp is None else sp[0].as_strided((B, H), sp[1])
        res = ref.span_attention(
            q.reshape(1, B * H, Sq, dh), k.reshape(1, B * H, Sk, dh), v.reshape(1, B * H, Sk, dh),
            sp.reshape(-1), causal=causal,
            kv_lens=None if kvl is None else kvl[0].as_strided((B, H), kvl[1]).reshape(1, -1),
        ).reshape(B, H, Sq, dh)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty((B, H, Sq, dh), dtype=torch.float32, device=q.device)
    _launch(out, q, k, v, sp, kvl, B, H, Sq, Sk, dh, int(window), int(causal))
    return out


def span_attention(
    q: torch.Tensor,              # [BH, Sq, dh]
    k: torch.Tensor,              # [BH, Sk, dh] (expanded per head)
    v: torch.Tensor,              # [BH, Sk, dh]
    spans: torch.Tensor,          # [BH] int32 exact spans
    window: int,                  # static max span over the rows
    *,
    causal: bool,
    kv_lens: Optional[torch.Tensor] = None,   # [BH] int32 valid keys per row
) -> torch.Tensor:
    """Hard-span attention over independent rows.  Every span must be at
    most ``window``: the kernel reads only the keys within ``window`` of each
    query tile.  The rows as one batch row of ``span_attention_heads``."""
    BH = q.shape[0]
    for what, t in (("spans", spans), ("kv_lens", kv_lens)):
        if t is not None and t.shape != (BH,):
            raise ValueError(f"span_attention: {what} must be [BH] = [{BH}], got {tuple(t.shape)}")
    return span_attention_heads(q[None], k[None], v[None], spans, window, causal=causal,
                                kv_lens=None if kv_lens is None else kv_lens[None])[0]


span_attention.launches = 0
span_attention.long_launches = 0
