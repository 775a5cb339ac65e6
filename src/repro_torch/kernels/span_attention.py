"""Span-windowed attention (paper §III-B + §V-D1).

Replaces the Pallas kernel ``repro/kernels/span_attention.py:32``
``_span_attn_kernel`` (``pallas_call`` at :176) with the CUDA kernel in
``csrc/span_attention.cu``: one block per (row, 64-query tile), which reads
its own span and kv_len and visits only the kv tiles inside the static
window.  Element mask: causal ``0 <= i-j < span`` or bidirectional
``|i-j| < span``, and ``j < kv_len``; fp32 online softmax; a row with no
visible key returns zeros.  The source gives its bound on the H100.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

_SIGNATURES = {
    "repro_span_attention": [build.PTR] * 6 + [build.INT] * 6 + [build.FLOAT, build.PTR, build.INT],
}
HEAD_DIMS = (16, 32, 64, 128)


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
    query tile.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises."""
    BH, Sq, dh = q.shape
    if q.device.type == "cpu":
        out = ref.span_attention(
            q[None], k[None], v[None], spans, causal=causal,
            kv_lens=None if kv_lens is None else kv_lens[None],
        )
        return out[0]
    build.require_cuda("span_attention", q, k, v)
    ints = (spans,) if kv_lens is None else (spans, kv_lens)
    build.require_cuda("span_attention", q, *ints, dtype=None)
    if any(t.dtype != torch.int32 or t.shape != (BH,) for t in ints):
        raise TypeError("span_attention: spans and kv_lens must be int32 [BH]")
    Sk = k.shape[1]
    if k.shape != (BH, Sk, dh) or v.shape != k.shape:
        raise ValueError(f"span_attention: k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"span_attention: head dim {dh} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    lib = build.library("span_attention", _SIGNATURES)
    err = lib.repro_span_attention(
        out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), spans.data_ptr(),
        None if kv_lens is None else kv_lens.data_ptr(),
        BH, Sq, Sk, dh, int(window), int(causal), 1.0 / math.sqrt(dh),
        build.stream_of(q), q.device.index,
    )
    build.check(lib, err, "span_attention")
    span_attention.launches += 1
    return out


span_attention.launches = 0
