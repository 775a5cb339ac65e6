"""ALBERT parameter init for the port.

``init_params`` returns a tree with exactly the keys and shapes of the JAX
package's ``Model.init_params`` for the albert family (``models/model.py``),
with the same init scales.  The random numbers come from a
``torch.Generator`` and so differ from JAX's; parity tests bring the JAX
tree across with ``repro_torch.bridge`` instead.  The dense all-layers
forward comes with the serving slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _normal(gen: torch.Generator, shape: Sequence[int], scale: float) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device) * scale


def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = "cuda",
) -> Params:
    """Random ALBERT params on ``device`` (draws from ``generator``, a seed-0
    CPU generator when None)."""
    if (cfg.family, cfg.act, cfg.norm, cfg.qkv_bias, cfg.tie_embeddings) != (
        "albert", "gelu", "layernorm", False, True
    ):
        raise ValueError("only the ALBERT configs (gelu, layernorm, tied embeddings) are ported")
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dtype = _DTYPES[cfg.dtype]
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def dense(shape, scale=None, dt=dtype):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return _normal(gen, shape, scale).to(dev, dt)

    def embed(shape):
        return _normal(gen, shape, 0.02).to(dev, dtype)

    def norm():
        return {"scale": torch.ones(d, dtype=dtype, device=dev),
                "norm_bias": torch.zeros(d, dtype=dtype, device=dev)}

    p: Params = {"embed": {"tok": embed((cfg.vocab_size, cfg.embed_dim))}}
    if cfg.embed_dim != d:
        p["embed"]["proj"] = dense((cfg.embed_dim, d))
    if cfg.pos == "learned":
        p["embed"]["pos"] = embed((cfg.max_seq_len, d))

    attn = {
        "wq": dense((d, H * hd)),
        "wk": dense((d, KV * hd)),
        "wv": dense((d, KV * hd)),
        "wo": dense((H * hd, d)),
    }
    mlp = {"w_up": dense((d, cfg.d_ff)), "w_down": dense((cfg.d_ff, d))}
    p["layer"] = {"norm1": norm(), "attn": attn, "norm2": norm(), "mlp": mlp}

    p["final_norm"] = norm()
    if cfg.num_classes:
        p["classifier"] = {
            "pooler_w": dense((d, d)),
            "pooler_b": torch.zeros(d, dtype=dtype, device=dev),
            "cls_w": dense((d, cfg.num_classes)),
            "cls_b": torch.zeros(cfg.num_classes, dtype=dtype, device=dev),
        }
    if cfg.edgebert.early_exit.enabled:
        C = cfg.edgebert.early_exit.num_classes
        f32 = torch.float32
        p["offramp"] = {
            "offramp_pooler_w": dense((d, d), dt=f32),
            "offramp_pooler_b": torch.zeros(d, dtype=f32, device=dev),
            "offramp_cls_w": dense((d, C), dt=f32),
            "offramp_cls_b": torch.zeros(C, dtype=f32, device=dev),
        }
    if cfg.edgebert.span.enabled:
        n_span_layers = 1 if cfg.shared_layers else cfg.n_layers
        p["span_z"] = torch.full(
            (n_span_layers, H), cfg.edgebert.span.init_span, dtype=torch.float32, device=dev
        )
    return p
