"""The ALBERT-family model of the port (``repro/models/model.py``, albert
branch).

``init_params`` returns a tree with exactly the keys and shapes of the JAX
package's ``Model.init_params`` for the albert family, with the same init
scales.  The random numbers come from a ``torch.Generator`` and so differ
from JAX's; parity tests bring the JAX tree across with
``repro_torch.bridge`` instead.

``Model`` carries the layer math the classifier serving step and the dense
all-layers forward (``apply_train``) run: embedding, the post-LN shared
encoder layer, activation fake-quant, the early-exit off-ramp.  Its
methods take a tree of tensors on one device and compute there.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import early_exit as ee
from repro_torch.core.adaptivfloat import AFFormat, fake_quant
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L

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


class ModelOutput(NamedTuple):
    logits: Optional[torch.Tensor] = None          # LM logits [B, S, V]
    cls_logits: Optional[torch.Tensor] = None      # [B, C]
    all_cls_logits: Optional[torch.Tensor] = None  # [L, B, C] off-ramp sweep
    all_entropies: Optional[torch.Tensor] = None   # [L, B]
    exit_layer: Optional[torch.Tensor] = None      # [B]


class Model:
    """The albert family of the JAX package's ``Model``: one shared
    post-LN encoder layer, entropy off-ramps, AdaptivFloat activations."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "albert" or not cfg.shared_layers:
            raise ValueError("only the albert family (one shared layer) is ported")
        self.cfg = cfg

    # ------------------------------------------------------------ embedding
    def embed(self, p: Params, tokens: torch.Tensor, positions=None) -> torch.Tensor:
        h = p["embed"]["tok"][tokens.long()]
        if "proj" in p["embed"]:
            h = h @ p["embed"]["proj"]
        if self.cfg.pos == "learned":
            if positions is None:
                positions = torch.arange(tokens.shape[-1], device=h.device)
            h = h + p["embed"]["pos"][positions]
        return h

    def lm_logits(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        w = p["embed"]["tok"]
        if "proj" in p["embed"]:
            h = h @ p["embed"]["proj"].T
        return h @ w.T

    def cls_logits(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        c = p["classifier"]
        pooled = torch.tanh(h[..., 0, :] @ c["pooler_w"] + c["pooler_b"])
        return (pooled @ c["cls_w"] + c["cls_b"]).float()

    def _offramp(self, p: Params) -> ee.OfframpParams:
        o = p["offramp"]
        return ee.OfframpParams(o["offramp_pooler_w"], o["offramp_pooler_b"],
                                o["offramp_cls_w"], o["offramp_cls_b"])

    def _maybe_actquant(self, h: torch.Tensor, use_kernels: bool = False,
                        per_lane: bool = False) -> torch.Tensor:
        """AdaptivFloat activation quantization after the layer.  The bias
        comes from the amax over the whole tensor, or with ``per_lane`` over
        each slice of the leading axis (the serving step, where the JAX
        package ``vmap``s a one-lane body).  The reference route keeps
        ``fake_quant``'s ``x + (q - x)``; the kernel route returns ``q``."""
        q = self.cfg.edgebert.quant
        if not (q.enabled and q.quantize_activations):
            return h
        if use_kernels:
            return dispatch.act_quantize(h, q.n_bits, q.n_exp, groups=h.shape[0] if per_lane else 1)
        amax = h.detach().float().abs().amax(dim=tuple(range(1, h.ndim)), keepdim=True) if per_lane else None
        return fake_quant(h, AFFormat(q.n_bits, q.n_exp), amax=amax)

    # ---------------------------------------------------------- layer body
    def _dense_layer_step(
        self,
        lp: Params,
        h: torch.Tensor,               # [B, S, D]
        *,
        causal: bool,
        span_z: Optional[torch.Tensor] = None,
        kv_len: Optional[Any] = None,  # [B] valid tokens per row
        use_kernels: bool = False,
        block_masks: Optional[Dict[str, Any]] = None,
        per_lane: bool = False,
    ) -> torch.Tensor:
        """The shared post-LN encoder layer (the albert branch of the JAX
        package's ``_dense_layer_step``, cache-free) -> the new h."""
        cfg = self.cfg
        attn_out = L.attention_layer(
            lp["attn"], h, cfg, causal=causal, span_z=span_z,
            span_ramp=cfg.edgebert.span.ramp, kv_len=kv_len, use_kernels=use_kernels,
        )
        h = L.apply_norm(lp["norm1"], h + attn_out, use_kernels=use_kernels)
        mo = L.apply_mlp(lp["mlp"], h, use_kernels=use_kernels, block_masks=block_masks)
        h = L.apply_norm(lp["norm2"], h + mo, use_kernels=use_kernels)
        return self._maybe_actquant(h, use_kernels=use_kernels, per_lane=per_lane)

    def _span_for_layer(self, p: Params, i: int) -> Optional[torch.Tensor]:
        if "span_z" not in p:
            return None
        z = p["span_z"]
        return z[0] if z.shape[0] == 1 else z[i]

    # ------------------------------------------------------------- forward
    def apply_train(self, p: Params, batch: Dict[str, Any]) -> ModelOutput:
        """Dense all-layers forward of the albert family (every off-ramp's
        logits and entropy when early exit is on)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=p["embed"]["tok"].device)
        h = self.embed(p, tokens)
        span_z = self._span_for_layer(p, 0)

        def layer_fn(i, h):
            return self._dense_layer_step(p["layer"], h, causal=False, span_z=span_z)

        if cfg.edgebert.early_exit.enabled and "offramp" in p:
            all_logits, all_ent = ee.exit_all_layers(layer_fn, cfg.n_layers, h, self._offramp(p))
            exit_layer, _ = ee.exit_decisions(all_ent, cfg.edgebert.early_exit.entropy_threshold)
            return ModelOutput(
                cls_logits=ee.select_exit_logits(all_logits, exit_layer),
                all_cls_logits=all_logits, all_entropies=all_ent, exit_layer=exit_layer,
            )
        for i in range(cfg.n_layers):
            h = layer_fn(i, h)
        cls = self.cls_logits(p, h) if "classifier" in p else None
        logits = self.lm_logits(p, h) if cfg.vocab_size else None
        return ModelOutput(logits=logits, cls_logits=cls)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
