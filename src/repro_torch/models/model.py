"""The port's model (``repro/models/model.py``): the albert family, the
dense and MoE decoder families, the ssm family (RWKV6), the hybrid family
(zamba2: Mamba2 blocks and a shared attention block), the encoder-decoder
family (whisper) and the vision decoder family (llama-3.2-vision: groups of
self-attention layers, each followed by a gated cross-attention layer over
image embeddings); and the port's own encoder family (ModernBERT: unshared
pre-LN layers, global and windowed attention, an off-ramp per layer), which
the JAX package does not have.

``init_params`` returns a tree with exactly the keys and shapes of the JAX
package's ``Model.init_params`` for those families, with the same init
scales; the decoder families' layers are stacked on a leading
``[n_layers]`` axis as the JAX package's ``_stack_init`` stacks them (the
MoE family's expert weights too: ``[n_layers, E, d, ff]``, the RWKV6
layers' time mix and channel mix, the Mamba2 blocks, the encoder's layers,
the decoder's cross-attention and the vlm family's cross layers, their
gates ``[n_cross]``).  The random numbers come from a
``torch.Generator`` and so differ from JAX's; parity tests bring the JAX
tree across with ``repro_torch.bridge`` instead.

``Model`` carries the layer math the classifier serving step and each
family's training forward (``apply_train``) run: embedding, the post-LN shared
encoder layer, activation fake-quant, the early-exit off-ramp; and the
decoder's: the pre-LN layer (RMS norm or LayerNorm, rotary or learned
positions, qkv biases where the config has them, SwiGLU, GELU, squared
ReLU or the MoE layer of ``models/moe.py``), the untied LM head, the KV
cache (``init_cache``, ``prefill``, ``decode_step``) and per-token early
exit (``decode_step_ee``, ``decode_step_spec``, ``forward_token_exit``);
the RWKV6 layer (``models/rwkv6.py``) and the Mamba2 block
(``models/mamba2.py``) with their recurrent state; the shared attention
block on concat(h, x0) with its own KV cache; the encoder over stubbed
frames and the decoder's cross-attention to the encoder's cached K/V; the
gated cross layer over stubbed image embeddings, or over their K/V cached
at prefill.
Every family takes EdgeBERT's features where the JAX package takes them:
AdaptivFloat activation quantization after every layer, adaptive spans
(``span_z``) on the self-attention of each caller that passes one, the
off-ramp parameters and a classifier head.
Only the dense, MoE and albert families have early exit in the JAX
package.  Its methods take a tree of tensors on one device and compute
there; the decode methods take each lane's cache position as a ``[B]``
tensor (the JAX package ``vmap``s one-lane calls with a scalar) and write
the cache in place.

MoE routing couples the tokens of one routing through expert capacity, so
each method keeps the JAX package's grouping: the decode methods route each
lane on its own (the serving step's per-lane ``vmap``; ``decode_step`` with
``per_lane=False`` routes the lanes together, as the serving prefill
needs), ``prefill`` and ``forward_token_exit`` route the whole batch
together (the JAX model's batched calls).  The activation quantization's
AdaptivFloat bias follows the same grouping: one per lane where the JAX
server ``vmap``s a one-lane call (``per_lane``), one over the whole batch
where the JAX package makes the batched call.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.common.device import DeviceLike, draw_device, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import early_exit as ee
from repro_torch.core.adaptivfloat import AFFormat, fake_quant
from repro_torch.core.entropy import entropy_from_logits
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models import mamba2, moe, rwkv6

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _normal(gen: torch.Generator, shape: Sequence[int], scale: float, dev: torch.device) -> torch.Tensor:
    # scaled in place: a stacked 7B weight is gigabytes, and a copy doubles it
    return torch.randn(tuple(shape), generator=gen, device=draw_device(gen, dev)).mul_(scale)


def _init_dense_params(cfg: ModelConfig, gen: torch.Generator, dev: torch.device) -> Params:
    """The decoder families' tree: token embedding (with a projection where
    ``embed_dim`` differs from ``d_model``, as in the smoke config, and the
    learned position table where ``pos`` is "learned"), the layers stacked
    on a leading [n_layers] axis (zero qkv biases with ``qkv_bias``, as the
    JAX package's ``init_attention`` makes them; the SwiGLU MLP or the
    squared-ReLU or GELU one (``w_up``, ``w_down``), or for the MoE family
    ``moe.init_moe``'s tree; for the ssm family the RWKV6 time and channel
    mix between two LayerNorms; for the hybrid family the Mamba2 blocks and
    the shared attention block), for the encdec family the encoder's layers,
    its final norm and position table and the decoder's cross-attention,
    for the vlm family the n_layers - n_layers / cross_attn_every self
    layers and the gated cross layers (their gates zero, as the JAX
    package's ``_init_cross_layer`` makes them, so each is the identity),
    the final norm (RMS or LayerNorm, the ssm family's LayerNorm, with a
    zero ``norm_bias``) and the untied LM head."""
    dtype = _DTYPES[cfg.dtype]
    d, hd, H, KV, L_ = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers

    def dense(shape, lead=(), scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return _normal(gen, tuple(lead) + tuple(shape), scale, dev).to(dev, dtype)

    def norm(*lead, kind=cfg.norm, width=d):
        n = {"scale": torch.ones(lead + (width,), dtype=dtype, device=dev)}
        if kind == "layernorm":
            n["norm_bias"] = torch.zeros(lead + (width,), dtype=dtype, device=dev)
        return n

    def attention(lead, d_in=d):
        a = {"wq": dense((d_in, H * hd), lead), "wk": dense((d_in, KV * hd), lead),
             "wv": dense((d_in, KV * hd), lead), "wo": dense((H * hd, d_in), lead)}
        if cfg.qkv_bias and cfg.family != "hybrid":
            a.update(bq=torch.zeros(lead + (H * hd,), dtype=dtype, device=dev),
                     bk=torch.zeros(lead + (KV * hd,), dtype=dtype, device=dev),
                     bv=torch.zeros(lead + (KV * hd,), dtype=dtype, device=dev))
        return a

    def mlp(n):
        if cfg.act == "swiglu":
            return {"w_gate": dense((d, cfg.d_ff), (n,)), "w_up": dense((d, cfg.d_ff), (n,)),
                    "w_down": dense((cfg.d_ff, d), (n,))}
        return {"w_up": dense((d, cfg.d_ff), (n,)), "w_down": dense((cfg.d_ff, d), (n,))}

    def dense_layers(n):
        layers = {"norm1": norm(n), "attn": attention((n,)), "norm2": norm(n)}
        if cfg.family == "moe":
            layers["moe"] = moe.init_moe(cfg, gen, dev, dtype, lead=(n,))
        else:
            layers["mlp"] = mlp(n)
        return layers

    embed = {"tok": _normal(gen, (cfg.vocab_size, cfg.embed_dim), 0.02, dev).to(dev, dtype)}
    if cfg.embed_dim != d:
        embed["proj"] = _normal(gen, (cfg.embed_dim, d), 1.0 / math.sqrt(cfg.embed_dim), dev).to(dev, dtype)
    if cfg.pos == "learned":
        embed["pos"] = _normal(gen, (cfg.max_seq_len, d), 0.02, dev).to(dev, dtype)
    p: Params = {"embed": embed}
    if cfg.family == "ssm":
        p["layers"] = {"norm1": norm(L_, kind="layernorm"),
                       "tmix": rwkv6.init_rwkv6(cfg, gen, dev, dtype, lead=(L_,)),
                       "norm2": norm(L_, kind="layernorm"),
                       "cmix": rwkv6.init_channel_mix(cfg, gen, dev, dtype, lead=(L_,))}
    elif cfg.family == "hybrid":
        p["layers"] = {"norm": norm(L_), "mixer": mamba2.init_mamba2(cfg, gen, dev, dtype, lead=(L_,))}
        if cfg.attn_every:
            # the Zamba-style shared attention + MLP block on concat([h, x0])
            d2 = 2 * d
            p["shared_attn"] = {"norm1": norm(width=d2), "attn": attention((), d_in=d2), "norm2": norm(width=d2),
                                "mlp": {"w_up": dense((d2, cfg.d_ff)), "w_down": dense((cfg.d_ff, d2))},
                                "out_proj": dense((d2, d))}
    elif cfg.family == "vlm":
        n_cross = L_ // cfg.cross_attn_every
        p["layers"] = dense_layers(L_ - n_cross)
        gate = torch.zeros(n_cross, dtype=torch.float32, device=dev)
        p["cross_layers"] = {"norm1": norm(n_cross), "xattn": attention((n_cross,)), "gate_attn": gate,
                             "norm2": norm(n_cross), "mlp": mlp(n_cross), "gate_mlp": gate.clone()}
    else:
        p["layers"] = dense_layers(L_)
    if cfg.family == "encdec":
        p["enc_layers"] = dense_layers(cfg.n_enc_layers)
        p["enc_norm"] = norm()
        p["enc_pos"] = _normal(gen, (cfg.enc_seq_len, d), 0.02, dev).to(dev, dtype)
        p["dec_cross"] = {"norm": norm(L_), "xattn": attention((L_,))}
    p["final_norm"] = norm()
    p["lm_head"] = _normal(gen, (d, cfg.vocab_size), 0.02, dev).to(dev, dtype)
    p.update(_edgebert_params(cfg, gen, dev, dtype))
    return p


def _edgebert_params(cfg: ModelConfig, gen: torch.Generator, dev: torch.device, dtype) -> Params:
    """The EdgeBERT leaves the JAX package's ``init_params`` draws on every
    family: the classifier head with ``num_classes``, the off-ramp (float32)
    with early exit, and ``span_z`` [1 or n_layers, n_heads] at
    ``init_span`` with spans on, except on the attention-free ssm
    family."""
    d, f32 = cfg.d_model, torch.float32

    def dense(shape, dt=dtype):
        return _normal(gen, shape, 1.0 / math.sqrt(shape[0]), dev).to(dev, dt)

    p: Params = {}
    if cfg.num_classes:
        p["classifier"] = {
            "pooler_w": dense((d, d)),
            "pooler_b": torch.zeros(d, dtype=dtype, device=dev),
            "cls_w": dense((d, cfg.num_classes)),
            "cls_b": torch.zeros(cfg.num_classes, dtype=dtype, device=dev),
        }
    if cfg.edgebert.early_exit.enabled:
        C = cfg.edgebert.early_exit.num_classes
        p["offramp"] = {
            "offramp_pooler_w": dense((d, d), dt=f32),
            "offramp_pooler_b": torch.zeros(d, dtype=f32, device=dev),
            "offramp_cls_w": dense((d, C), dt=f32),
            "offramp_cls_b": torch.zeros(C, dtype=f32, device=dev),
        }
    if cfg.edgebert.span.enabled and not cfg.attention_free:
        n_span_layers = 1 if cfg.shared_layers else cfg.n_layers
        p["span_z"] = torch.full((n_span_layers, cfg.n_heads), cfg.edgebert.span.init_span, dtype=f32, device=dev)
    return p


def _check_dense(cfg: ModelConfig) -> None:
    """The decoders as deepseek-7b, minitron-8b, internlm2-20b, qwen1.5-110b
    and the qwen MoE configs have them: pre-LN with RMS norm or (dense
    only) LayerNorm, rotary positions, SwiGLU (in every expert too) or
    (dense only) the squared ReLU, with or without qkv biases, an untied LM
    head; the MoE family with its experts and top-k.  The ssm family as
    rwkv6-7b has it: RWKV6 layers, an untied LM head.  The hybrid family as
    zamba2-1.2b has it: Mamba2 blocks with RMS pre-norms and the shared
    attention block (rotary positions, its GELU MLP) every ``attn_every``
    blocks, an untied head.  The encdec family as whisper-medium has it:
    pre-LN LayerNorm layers with the GELU MLP in the encoder and the
    decoder, learned positions, an untied head.  The vlm family as
    llama-3.2-vision has it: RMS pre-norms, rotary positions, SwiGLU, no
    qkv bias, a gated cross layer closing every group of
    ``cross_attn_every`` layers (so ``n_layers`` a multiple of it), an
    untied head.  Every family takes the EdgeBERT features as the JAX
    package does: activation quantization, adaptive spans (not the
    attention-free ssm family, which has no ``span_z``), the off-ramp
    parameters and a classifier head (``num_classes``); a tied head and
    shared layers stay refused."""
    plain = not (cfg.tie_embeddings or cfg.shared_layers)
    if cfg.family == "ssm":
        if not plain or cfg.d_model != cfg.n_heads * cfg.head_dim:
            raise ValueError("only the ssm decoder of rwkv6-7b's kind (RWKV6 layers, untied head, no shared "
                             "layers) is ported")
        return
    if cfg.family == "hybrid":
        if (not plain or (cfg.norm, cfg.pos) != ("rms", "rope") or not cfg.ssm_state
                or (2 * cfg.d_model) % cfg.ssm_head_dim
                or (cfg.attn_every and 2 * cfg.d_model != cfg.n_heads * cfg.head_dim)):
            raise ValueError("only the hybrid decoder of zamba2-1.2b's kind (Mamba2 blocks, rms, a shared "
                             "rope attention block at width 2 d_model, untied head, no shared layers) is ported")
        return
    if cfg.family == "encdec":
        if (not plain or (cfg.act, cfg.norm, cfg.pos) != ("gelu", "layernorm", "learned")
                or not cfg.n_enc_layers):
            raise ValueError("only the encoder-decoder of whisper-medium's kind (gelu, layernorm, learned "
                             "positions, an encoder, untied head, no shared layers) is ported")
        return
    if cfg.family == "vlm":
        if (not plain or (cfg.act, cfg.norm, cfg.pos) != ("swiglu", "rms", "rope") or cfg.qkv_bias
                or cfg.cross_attn_every < 2 or cfg.n_layers % cfg.cross_attn_every):
            raise ValueError("only the vision decoder of llama-3.2-vision's kind (swiglu, rms, rope, no qkv bias, "
                             "a gated cross layer closing every group of cross_attn_every layers, untied head, "
                             "no shared layers) is ported")
        return
    # the squared ReLU and LayerNorm as minitron-8b has them: the dense family only
    dense = cfg.family == "dense"
    if (cfg.family not in ("dense", "moe")
            or (cfg.family == "moe" and not (cfg.n_experts and cfg.top_k))
            or cfg.act not in (("swiglu", "relu2") if dense else ("swiglu",))
            or cfg.norm not in (("rms", "layernorm") if dense else ("rms",))
            or (cfg.pos, cfg.tie_embeddings, cfg.shared_layers) != ("rope", False, False)):
        raise ValueError("only the dense decoder of deepseek-7b's and minitron-8b's kinds (swiglu or relu2, "
                         "rms or layernorm) and the MoE decoder of qwen-moe's (swiglu, rms), each with rope, an "
                         "untied head and no shared layers, are ported")


def _check_encoder(cfg: ModelConfig) -> None:
    """The encoder as ModernBERT has it: unshared pre-LN layers with a GeGLU
    MLP, LayerNorms, rotary positions, global attention every
    ``global_every`` layers and a local window in the others; no qkv bias,
    no adaptive spans (the windows are hard)."""
    if (cfg.shared_layers or (cfg.act, cfg.norm, cfg.pos) != ("geglu", "layernorm", "rope") or cfg.qkv_bias
            or cfg.global_every < 1 or cfg.local_window < 2 or cfg.local_rope_theta <= 0
            or cfg.n_heads != cfg.n_kv_heads or cfg.edgebert.span.enabled):
        raise ValueError("only the encoder of ModernBERT's kind (unshared pre-LN layers, geglu, layernorm, "
                         "rope, global attention every global_every layers and a local window between, with "
                         "a local_rope_theta of its own, no qkv bias, no adaptive spans) is ported")


def _init_encoder_params(cfg: ModelConfig, gen: torch.Generator, dev: torch.device) -> Params:
    """The encoder family's tree: the token embedding and its LayerNorm (no
    position table: rotary positions), the layers stacked on a leading
    [n_layers] axis (``attn_norm``, which layer 0 does not apply; q, k, v, o
    of d x d; ``mlp_norm``; the GeGLU MLP's ``w_up`` [d, 2 d_ff], its halves
    the gelu input and the gate, and ``w_down``), and one off-ramp per layer
    in ModernBERT's head form, stacked the same way (its own LayerNorm,
    ``dense``, ``head_norm``, the classifier ``cls_w`` / ``cls_b``): the
    last one is the published model's final norm, head and classifier.
    Normal weights scaled by 1 / sqrt(fan-in), the embedding by 0.02, unit
    norm scales (the norms have no bias), a zero classifier bias."""
    dtype = _DTYPES[cfg.dtype]
    d, L_, ff = cfg.d_model, cfg.n_layers, cfg.d_ff
    C = cfg.num_classes or cfg.edgebert.early_exit.num_classes

    def dense(shape):
        return _normal(gen, (L_,) + tuple(shape), 1.0 / math.sqrt(shape[0]), dev).to(dev, dtype)

    def norm(*lead):
        return {"scale": torch.ones(lead + (d,), dtype=dtype, device=dev)}

    return {
        "embed": {"tok": _normal(gen, (cfg.vocab_size, d), 0.02, dev).to(dev, dtype), "norm": norm()},
        "layers": {"attn_norm": norm(L_), "attn": {k: dense((d, d)) for k in ("wq", "wk", "wv", "wo")},
                   "mlp_norm": norm(L_), "mlp": {"w_up": dense((d, 2 * ff)), "w_down": dense((ff, d))}},
        "offramps": {"norm": norm(L_), "dense": dense((d, d)), "head_norm": norm(L_), "cls_w": dense((d, C)),
                     "cls_b": torch.zeros((L_, C), dtype=dtype, device=dev)},
    }


DECODER_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
REMAT_POLICIES = ("none", "dots", "full")


def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = "cuda",
) -> Params:
    """Random params on ``device``.  The albert family draws from
    ``generator`` (a seed-0 CPU generator when None); the decoder families
    and the encoder family from ``generator`` on the generator's own device
    (a seed-0 generator on ``device`` when None), so a 7B tree made for the
    card is drawn there.
    On ``device="meta"`` the tree has every leaf's shape and dtype and
    nothing is drawn or allocated (the sharding rules' input)."""
    if cfg.family in DECODER_FAMILIES + ("encoder",):
        (_check_encoder if cfg.family == "encoder" else _check_dense)(cfg)
        dev = resolve_device(device)
        # the meta device has no generator: shapes only, nothing drawn
        gen = generator if generator is not None else torch.Generator(
            device="cpu" if dev.type == "meta" else dev).manual_seed(0)
        return (_init_encoder_params if cfg.family == "encoder" else _init_dense_params)(cfg, gen, dev)
    if (cfg.family, cfg.act, cfg.norm, cfg.qkv_bias, cfg.tie_embeddings) != (
        "albert", "gelu", "layernorm", False, True
    ):
        raise ValueError("only the ALBERT configs (gelu, layernorm, tied embeddings) and the dense, "
                         "MoE, ssm, hybrid, encdec and vlm decoders are ported")
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dtype = _DTYPES[cfg.dtype]
    d, hd, H, KV = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def dense(shape, scale=None, dt=dtype):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return _normal(gen, shape, scale, dev).to(dev, dt)

    def embed(shape):
        return _normal(gen, shape, 0.02, dev).to(dev, dtype)

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
    p.update(_edgebert_params(cfg, gen, dev, dtype))
    return p


class ModelOutput(NamedTuple):
    logits: Optional[torch.Tensor] = None          # LM logits [B, S, V]
    cls_logits: Optional[torch.Tensor] = None      # [B, C]
    aux_loss: Any = 0.0                            # router / span regularizers (a float32 scalar)
    all_cls_logits: Optional[torch.Tensor] = None  # [L, B, C] off-ramp sweep
    all_entropies: Optional[torch.Tensor] = None   # [L, B]
    exit_layer: Optional[torch.Tensor] = None      # [B]


def _per_layer_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] through each of the stacked projections w [L, d, k] ->
    [L, B, S, k] (``sharding.dtensor_forms`` swaps in a DTensor form)."""
    return torch.einsum("bsd,ldk->lbsk", x, w)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The "dots" policy (JAX's ``checkpoint_dots_with_no_batch_dims``):
    keep the outputs of matrix products with no batch dimension, recompute
    everything else.  Chosen by contraction, not by op name: ``x @ w``
    lowers to ``mm`` (``addmm`` with a bias), and ``torch.einsum`` lowers a
    product with no batch dimension (``_per_layer_proj``'s) to a ``bmm``
    over a batch of 1."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _unstack(node) -> list:
    """A tree of leaves stacked on a leading [n] axis -> n trees, one per
    layer, each leaf taken by one ``unbind(0)`` (the ``lax.scan`` over the
    stack): unbind's backward stacks the n gradients into one [n, ...]
    gradient, where indexing layer by layer would give each layer a
    zero-filled [n, ...] gradient to add."""
    if not isinstance(node, dict):
        return list(node.unbind(0))
    parts = {k: _unstack(v) for k, v in node.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


class Model:
    """The albert, dense, MoE, ssm, hybrid, encdec and vlm families of the
    JAX package's ``Model``: one shared post-LN encoder layer with entropy
    off-ramps and AdaptivFloat activations, a stack of pre-LN decoder layers
    (SwiGLU, squared ReLU or MoE) with a KV cache and per-token early exit
    on the LM head, a stack of RWKV6 layers with a recurrent state, Mamba2
    blocks with a recurrent state and a shared attention block with a KV
    cache, an encoder and a decoder with cross-attention, or groups of
    decoder layers each closed by a gated cross layer over image
    embeddings."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family in DECODER_FAMILIES:
            _check_dense(cfg)
        elif cfg.family == "encoder":
            _check_encoder(cfg)
        elif cfg.family != "albert" or not cfg.shared_layers:
            raise ValueError("only the albert family (one shared layer), the encoder family and the dense, "
                             "MoE, ssm, hybrid, encdec and vlm families are ported")
        if cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {cfg.remat_policy!r}: one of {', '.join(REMAT_POLICIES)}")
        self.cfg = cfg
        # the shared attention block's config: its width, and no qkv bias
        self._shared_cfg = (dataclasses.replace(cfg, d_model=2 * cfg.d_model, qkv_bias=False)
                            if cfg.family == "hybrid" else None)

    # ------------------------------------------------------------ embedding
    def embed(self, p: Params, tokens: torch.Tensor, positions=None) -> torch.Tensor:
        h = p["embed"]["tok"][tokens.long()]
        if "norm" in p["embed"]:               # the encoder family's embedding LayerNorm
            return L.apply_norm(p["embed"]["norm"], h, eps=self.cfg.norm_eps)
        if "proj" in p["embed"]:
            h = h @ p["embed"]["proj"]
        if self.cfg.pos == "learned":
            if positions is None:
                positions = torch.arange(tokens.shape[-1], device=h.device)
            h = h + p["embed"]["pos"][positions]
        return h

    def lm_logits(self, p: Params, h: torch.Tensor) -> torch.Tensor:
        if not self.cfg.tie_embeddings:
            return h @ p["lm_head"]
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
    def _sp_constrain(self, h: torch.Tensor) -> torch.Tensor:
        """The residual stream's layout between blocks on a mesh (the JAX
        package's ``_sp_constrain``): ``h`` itself here, where nothing is
        sharded; ``sharding.dtensor_forms`` swaps in the DTensor layout."""
        return h

    def _dense_layer_step(
        self,
        lp: Params,
        h: torch.Tensor,               # [B, S, D]
        *,
        causal: bool,
        span_z: Optional[torch.Tensor] = None,
        kv_len: Optional[Any] = None,  # [B] valid tokens per row
        positions: Optional[torch.Tensor] = None,   # [S] or [B, S] (rope)
        cache: Optional[tuple] = None,              # (k, v) of this layer, written in place
        cache_pos: Any = None,                      # [B] (or scalar) cache write position
        use_kernels: bool = False,
        block_masks: Optional[Dict[str, Any]] = None,
        per_lane: bool = False,
        moe_grouped: Optional[bool] = None,
        with_aux: bool = False,
    ):
        """One layer (the JAX package's ``_dense_layer_step``) -> the new h,
        or with ``with_aux`` (h, the MoE router's aux loss, a float32 zero
        for any other layer): post-LN for the albert family, pre-LN for the
        decoder families.  An MoE layer routes each batch row on its own
        with ``moe_grouped``, all rows together without it (None: the
        config's ``moe_grouped_dispatch``).  The decoder's two pre-norms
        take ``use_kernels`` as the JAX package's take ``use_pallas``: a
        LayerNorm goes to the layernorm kernel, an RMS norm has none.  Every
        family's layer ends in the activation quantization, which takes
        ``use_kernels`` too (the quantize kernel) and one bias per batch row
        with ``per_lane``."""
        cfg = self.cfg
        attn = dict(causal=causal, positions=positions, span_z=span_z, span_ramp=cfg.edgebert.span.ramp,
                    kv_len=kv_len, cache=cache, cache_pos=cache_pos, use_kernels=use_kernels)
        if cfg.family == "albert":
            attn_out = L.attention_layer(lp["attn"], h, cfg, **attn)
            h = L.apply_norm(lp["norm1"], h + attn_out, use_kernels=use_kernels)
            mo = L.apply_mlp(lp["mlp"], h, use_kernels=use_kernels, block_masks=block_masks)
            h = L.apply_norm(lp["norm2"], h + mo, use_kernels=use_kernels)
            return self._maybe_actquant(h, use_kernels=use_kernels, per_lane=per_lane)
        h = self._sp_constrain(h)
        h = self._sp_constrain(h + L.attention_layer(
            lp["attn"], L.apply_norm(lp["norm1"], h, kind=cfg.norm, use_kernels=use_kernels), cfg, **attn))
        hn = L.apply_norm(lp["norm2"], h, kind=cfg.norm, use_kernels=use_kernels)
        if "moe" in lp:
            mo, aux = moe.apply_moe(lp["moe"], hn, cfg, grouped=moe_grouped)
        else:
            mo = L.apply_mlp(lp["mlp"], hn, use_kernels=use_kernels, block_masks=block_masks, act=cfg.act)
            aux = torch.zeros((), dtype=torch.float32, device=h.device) if with_aux else None
        h = self._maybe_actquant(self._sp_constrain(h + mo), use_kernels=use_kernels, per_lane=per_lane)
        return (h, aux) if with_aux else h

    def is_global(self, layer: int) -> bool:
        """Whether encoder layer ``layer`` attends globally (else in its
        local window)."""
        return layer % self.cfg.global_every == 0

    def encoder_layer_step(
        self,
        lp: Params,
        h: torch.Tensor,               # [B, S, D]
        *,
        layer: int,
        kv_len: Optional[Any] = None,  # [B] valid tokens per row
        use_kernels: bool = False,
        block_masks: Optional[Dict[str, Any]] = None,
        per_lane: bool = False,
    ) -> torch.Tensor:
        """One encoder layer (ModernBERT's ``ModernBertEncoderLayer``), pre-LN:
        h + attention(attn_norm(h)) (layer 0's attn_norm is the identity),
        then h + GeGLU(mlp_norm(h)), then the activation quantization.  A
        global layer attends to every key below the row's kv_len with RoPE
        at ``rope_theta``; a local one to the keys within ``local_window //
        2`` of the query (the span kernel's window ``local_window // 2 + 1``)
        with RoPE at ``local_rope_theta``."""
        cfg = self.cfg
        eps = cfg.norm_eps
        glob = self.is_global(layer)
        x = h if layer == 0 else L.apply_norm(lp["attn_norm"], h, eps=eps, use_kernels=use_kernels)
        h = h + L.attention_layer(lp["attn"], x, cfg, causal=False, kv_len=kv_len, use_kernels=use_kernels,
                                  rope_theta=cfg.rope_theta if glob else cfg.local_rope_theta,
                                  window=None if glob else cfg.local_window // 2 + 1)
        x = L.apply_norm(lp["mlp_norm"], h, eps=eps, use_kernels=use_kernels)
        h = h + L.apply_mlp(lp["mlp"], x, use_kernels=use_kernels, block_masks=block_masks, act=cfg.act)
        return self._maybe_actquant(h, use_kernels=use_kernels, per_lane=per_lane)

    def encoder_offramp(self, p: Params, h: torch.Tensor, layer: int) -> torch.Tensor:
        """The off-ramp after encoder layer ``layer`` on the CLS rows (token
        0) of ``h`` [B, S, D] -> logits [B, C], in ModernBERT's head form:
        its own LayerNorm (in the published model's last off-ramp, the final
        norm), ``dense``, GELU (exact erf form), ``head_norm``, then the
        classifier ``cls_w`` / ``cls_b``; on the reference ops (no kernel
        computes this head)."""
        o, eps = self._layer(p, layer, "offramps")[0], self.cfg.norm_eps
        x = L.apply_norm(o["norm"], h[:, 0].float(), eps=eps)
        x = L.apply_norm(o["head_norm"], F.gelu(x @ o["dense"]), eps=eps)
        return x @ o["cls_w"] + o["cls_b"]

    def _rwkv_layer_step(self, lp: Params, h: torch.Tensor, *, states: Optional[Params] = None,
                         decode: bool = False, per_lane: bool = False):
        """One RWKV6 layer (the JAX package's ``_rwkv_layer_step``) -> (h,
        new states {"last_tm", "wkv", "last_cm"}).  Its two LayerNorms and
        its activation quantization (one bias per batch row with
        ``per_lane``) take no kernel flag in the JAX package, so they stay
        on the reference ops here too."""
        st = states or {}
        h = self._sp_constrain(h)
        tout, (last_tm, wkv) = rwkv6.apply_rwkv6(lp["tmix"], L.apply_norm(lp["norm1"], h), self.cfg,
                                                 last_x=st.get("last_tm"), wkv_state=st.get("wkv"),
                                                 decode=decode)
        h = self._sp_constrain(h + tout)
        cout, last_cm = rwkv6.apply_channel_mix(lp["cmix"], L.apply_norm(lp["norm2"], h), last_x=st.get("last_cm"))
        return (self._maybe_actquant(h + cout, per_lane=per_lane),
                {"last_tm": last_tm, "wkv": wkv, "last_cm": last_cm})

    def _mamba_block_step(self, lp: Params, h: torch.Tensor, *, states: Optional[Params] = None,
                          decode: bool = False, per_lane: bool = False):
        """One Mamba2 block (the JAX package's ``_mamba_block_step``): RMS
        pre-norm, the mixer, the residual, the activation quantization (one
        bias per batch row with ``per_lane``) -> (h, new states {"conv",
        "ssm"}).  Its norm and its quantization take no kernel flag in the
        JAX package (and an RMS norm has no kernel)."""
        st = states or {}
        h = self._sp_constrain(h)
        out, (conv, ssm) = mamba2.apply_mamba2(lp["mixer"], L.apply_norm(lp["norm"], h, kind=self.cfg.norm),
                                               self.cfg, conv_state=st.get("conv"), ssm_state=st.get("ssm"),
                                               decode=decode)
        return self._maybe_actquant(h + out, per_lane=per_lane), {"conv": conv, "ssm": ssm}

    def _shared_attn_step(self, sp: Params, h: torch.Tensor, x0: torch.Tensor, *, span_z=None, cache=None,
                          cache_pos=None, positions=None, use_kernels: bool = False) -> torch.Tensor:
        """The zamba2 shared block (the JAX package's ``_shared_attn_step``)
        on concat(h, x0), x0 the embedding output: attention at width
        2 d_model under the block's config (rotary positions at each lane's
        own positions, its KV written into ``cache`` in place), the GELU
        MLP, then h + z @ out_proj."""
        cfg = self.cfg
        z = torch.cat([h, x0], dim=-1)
        z = self._sp_constrain(z)
        zi = L.apply_norm(sp["norm1"], z, kind=cfg.norm, use_kernels=use_kernels)
        z = self._sp_constrain(z + L.attention_layer(
            sp["attn"], zi, self._shared_cfg, causal=True, positions=positions, span_z=span_z,
            span_ramp=cfg.edgebert.span.ramp, cache=cache, cache_pos=cache_pos, use_kernels=use_kernels))
        z = self._sp_constrain(z + L.apply_mlp(
            sp["mlp"], L.apply_norm(sp["norm2"], z, kind=cfg.norm, use_kernels=use_kernels), act="gelu"))
        return h + z @ sp["out_proj"]

    def _encode(self, p: Params, frames: torch.Tensor) -> torch.Tensor:
        """The encoder over stubbed frame embeddings [B, S_enc, d]: learned
        positions, pre-LN non-causal layers (one remat region each), the
        final norm; all on the reference ops, as the JAX package passes no
        kernel flag here."""
        h = frames + p["enc_pos"][None, :frames.shape[1]].to(frames.dtype)
        step = self._remat(lambda lp, h: self._dense_layer_step(lp, h, causal=False))
        for lp in _unstack(p["enc_layers"]):
            h = step(lp, h)
        return L.apply_norm(p["enc_norm"], h, kind=self.cfg.norm)

    def _precomputed_cross(self, xp: Params, h: torch.Tensor, ek: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
        """The decoder's cross-attention to the encoder's cached K/V (its
        norm on the reference ops, as in the JAX package)."""
        cfg = self.cfg
        B, S, _ = h.shape
        q = (L.apply_norm(xp["norm"], h, kind=cfg.norm) @ xp["xattn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
        if "bq" in xp["xattn"]:
            q = q + xp["xattn"]["bq"].reshape(cfg.n_heads, cfg.head_dim)
        return L.attention(q, ek, ev, causal=False).reshape(B, S, -1) @ xp["xattn"]["wo"]

    def _cross_layer_step(self, lp: Params, h: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """The gated cross layer of the training forward (the JAX package's
        ``_cross_layer_step``): attention from the normed h to the image
        embeddings [B, n_img, d] (keys and values projected from them, no
        positions, no mask), then the SwiGLU MLP, each added through
        tanh of its gate, then the activation quantization; on the
        reference ops, as in the JAX package."""
        cfg = self.cfg
        x = L.attention_layer(lp["xattn"], L.apply_norm(lp["norm1"], h, kind=cfg.norm), cfg, causal=False,
                              kv_source=img)
        h = h + torch.tanh(lp["gate_attn"]).to(h.dtype) * x
        m = L.apply_mlp(lp["mlp"], L.apply_norm(lp["norm2"], h, kind=cfg.norm), act=cfg.act)
        return self._maybe_actquant(h + torch.tanh(lp["gate_mlp"]).to(h.dtype) * m)

    def _cross_decode(self, lp: Params, h: torch.Tensor, ik: torch.Tensor, iv: torch.Tensor) -> torch.Tensor:
        """The gated cross layer against the image K/V in the cache [B,
        n_img, KV, head_dim] (the JAX package's ``_cross_decode``): returns
        what the layer adds to h, the gated attention and the gated MLP of
        norm2(h + attention)."""
        cfg = self.cfg
        B, S, _ = h.shape
        q = (L.apply_norm(lp["norm1"], h, kind=cfg.norm) @ lp["xattn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
        out = L.attention(q, ik, iv, causal=False).reshape(B, S, -1) @ lp["xattn"]["wo"]
        x = torch.tanh(lp["gate_attn"]).to(h.dtype) * out
        m = L.apply_mlp(lp["mlp"], L.apply_norm(lp["norm2"], h + x, kind=cfg.norm), act=cfg.act)
        return x + torch.tanh(lp["gate_mlp"]).to(h.dtype) * m

    def _vlm_groups(self):
        """(group g, self layers of the group) over the vlm family's stack:
        ``cross_attn_every - 1`` self layers, then cross layer g."""
        n_self = self.cfg.cross_attn_every - 1
        return [(g, range(g * n_self, (g + 1) * n_self))
                for g in range(self.cfg.n_layers // self.cfg.cross_attn_every)]

    def _layer(self, p: Params, i: int, key: str = "layers"):
        """(layer params, span) of layer ``i``: the shared layer (albert) or
        views into the stacked layers under ``key`` (dense, MoE, ssm,
        hybrid, vlm, encoder; the encdec family's "enc_layers" and
        "dec_cross", the vlm family's "cross_layers" and the encoder
        family's "offramps" too)."""
        if self.cfg.family == "albert":
            return p["layer"], self._span_for_layer(p, 0)

        def take(node):
            return {k: take(v) for k, v in node.items()} if isinstance(node, dict) else node[i]

        return take(p[key]), None

    def _span_for_layer(self, p: Params, i: int) -> Optional[torch.Tensor]:
        if "span_z" not in p:
            return None
        z = p["span_z"]
        return z[0] if z.shape[0] == 1 else z[i]

    def _layer_spans(self, p: Params, n: int) -> list:
        """The training forwards' ``_span_for_layer`` for layers 0..n-1:
        one ``unbind`` where ``span_z`` has a row per layer (see
        ``_unstack``), its one row for every layer otherwise."""
        z = p.get("span_z")
        if z is None:
            return [None] * n
        return [z[0]] * n if z.shape[0] == 1 else list(z.unbind(0))

    def _remat(self, fn):
        """``fn`` as one rematerialisation region under the config's
        ``remat_policy`` (the JAX package's ``_remat`` around a scan body):
        "none" keeps every activation for the backward; "full"
        (``torch.utils.checkpoint``) keeps the region's inputs and runs the
        region again in the backward; "dots" keeps the outputs of matrix
        products with no batch dimension too (``_save_dots``).  Params and
        activations enter the region as ``fn``'s arguments.  The port has
        no dropout, so the second run repeats the first bit for bit; with
        grad off there is no backward, and ``fn`` runs as it is."""
        policy = self.cfg.remat_policy
        if policy == "none" or not torch.is_grad_enabled():
            return fn
        kw = {"context_fn": lambda: create_selective_checkpoint_contexts(_save_dots)} if policy == "dots" else {}

        def region(*args):
            # no region draws a random number, so no RNG state to replay
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)

        return region

    # ------------------------------------------------------------- forward
    def apply_train(self, p: Params, batch: Dict[str, Any]) -> ModelOutput:
        """The training forward over whole sequences, each family's as the
        JAX package has it: the albert family's dense all-layers pass (every
        off-ramp's logits and entropy when early exit is on), or a decoder's
        causal pass to the LM logits [B, S, V] (the MoE family with its
        router aux loss summed over layers; the ssm and hybrid families from
        a zero state through the chunked WKV and SSD; the encdec family over
        ``batch["enc_input"]`` frames, the vlm family over
        ``batch["image_embeds"]``; the encoder family's all-layers pass with
        an off-ramp after each, over ``batch["lengths"]`` valid tokens per
        row where given).  It runs on the reference ops only (no
        kernel has a backward, and the JAX package passes no kernel flag
        here), so autograd differentiates it end to end, as XLA
        differentiates the JAX package's."""
        forward = {"albert": self._forward_albert, "dense": self._forward_dense, "moe": self._forward_dense,
                   "ssm": self._forward_ssm, "hybrid": self._forward_hybrid, "encdec": self._forward_encdec,
                   "vlm": self._forward_vlm, "encoder": self._forward_encoder}[self.cfg.family]
        return forward(p, torch.as_tensor(batch["tokens"], device=p["embed"]["tok"].device), batch)

    def _aux_input(self, batch: Dict[str, Any], key: str, what: str, device) -> torch.Tensor:
        if key not in batch:
            raise ValueError(f'the {self.cfg.family} training forward needs batch["{key}"], {what}')
        return torch.as_tensor(batch[key], device=device)

    def _lm_output(self, p: Params, h: torch.Tensor, aux: Optional[torch.Tensor] = None,
                   norm: Optional[str] = None) -> ModelOutput:
        h = L.apply_norm(p["final_norm"], h, kind=norm or self.cfg.norm)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        return ModelOutput(logits=self.lm_logits(p, h), aux_loss=aux)

    def _forward_dense(self, p: Params, tokens: torch.Tensor, batch) -> ModelOutput:
        """The dense and MoE decoders (the JAX package's ``_forward_dense``):
        each MoE layer routes the whole batch as the config groups it, and
        the router aux losses are summed over the layers; layer i takes
        ``span_z[i]`` (row 0 for every layer when ``span_z`` has one row),
        and the classifier head, where the tree has one, gives
        ``cls_logits`` from the final-normed first position."""
        h = self.embed(p, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        layers = _unstack(p["layers"])
        step = self._remat(lambda lp, h, span_z: self._dense_layer_step(lp, h, causal=True, span_z=span_z,
                                                                        with_aux=True))
        for lp, span_z in zip(layers, self._layer_spans(p, len(layers))):
            h, a = step(lp, h, span_z)
            aux = aux + a
        h = L.apply_norm(p["final_norm"], h, kind=self.cfg.norm)
        cls = self.cls_logits(p, h) if "classifier" in p else None
        return ModelOutput(logits=self.lm_logits(p, h), cls_logits=cls, aux_loss=aux)

    def _forward_ssm(self, p: Params, tokens: torch.Tensor, batch) -> ModelOutput:
        """RWKV6 (the JAX package's ``_forward_ssm``): every layer's chunked
        WKV from a zero state, the final LayerNorm."""
        h = self.embed(p, tokens)
        step = self._remat(lambda lp, h: self._rwkv_layer_step(lp, h)[0])
        for lp in _unstack(p["layers"]):
            h = step(lp, h)
        return self._lm_output(p, h, norm="layernorm")

    def _forward_hybrid(self, p: Params, tokens: torch.Tensor, batch) -> ModelOutput:
        """zamba2 (the JAX package's ``_forward_hybrid``): the Mamba2 blocks
        (chunked SSD from a zero state), the shared block on concat(h, x0)
        after every ``attn_every``-th block, x0 the embedding output.  The
        JAX package has two forms of the same computation, a scan with a
        ``cond`` per block and (``hybrid_grouped``) a scan over groups of
        ``attn_every`` blocks with the remainder blocks after.  Their values
        are the same; they differ in the remat regions, which are the scan
        bodies: a block, with the shared block inside the region of the
        block it follows, or (``hybrid_grouped``) a group with its shared
        block, then each remainder block."""
        cfg = self.cfg
        h = x0 = self.embed(p, tokens)
        blocks, every = _unstack(p["layers"]), cfg.attn_every

        def run(lps, h, x0, shared, span_z, attn):
            for lp in lps:
                h = self._mamba_block_step(lp, h)[0]
            return self._shared_attn_step(shared, h, x0, span_z=span_z) if attn else h

        if cfg.hybrid_grouped and every:
            n_grp = len(blocks) // every
            regions = [(blocks[g * every:(g + 1) * every], True) for g in range(n_grp)]
            regions += [([lp], False) for lp in blocks[n_grp * every:]]
        else:
            regions = [([lp], bool(every) and (i + 1) % every == 0) for i, lp in enumerate(blocks)]
        step = self._remat(run)
        span_z = self._span_for_layer(p, 0)
        for lps, attn in regions:
            h = step(lps, h, x0, p["shared_attn"], span_z, attn)
        return self._lm_output(p, h)

    def _forward_encdec(self, p: Params, tokens: torch.Tensor, batch) -> ModelOutput:
        """whisper (the JAX package's ``_forward_encdec``): the encoder over
        ``batch["enc_input"]`` once, then each decoder layer (its self
        attention taking ``span_z[i]``, the encoder none) followed by its
        cross-attention to the encoder's output."""
        cfg = self.cfg
        enc = self._encode(p, self._aux_input(batch, "enc_input", "the encoder frames [B, enc_seq_len, d_model]",
                                              tokens.device))
        h = self.embed(p, tokens)

        def layer(lp, xp, h, enc, span_z):
            h = self._dense_layer_step(lp, h, causal=True, span_z=span_z)
            return h + L.attention_layer(xp["xattn"], L.apply_norm(xp["norm"], h, kind=cfg.norm), cfg,
                                         causal=False, kv_source=enc)

        step = self._remat(layer)
        layers = _unstack(p["layers"])
        for lp, xp, span_z in zip(layers, _unstack(p["dec_cross"]), self._layer_spans(p, len(layers))):
            h = step(lp, xp, h, enc, span_z)
        return self._lm_output(p, h)

    def _forward_vlm(self, p: Params, tokens: torch.Tensor, batch) -> ModelOutput:
        """llama-3.2-vision (the JAX package's ``_forward_vlm``): each group's
        self layers, then its gated cross layer over
        ``batch["image_embeds"]``.  The self layers' spans repeat the JAX
        package's form: self layer i takes ``span_z[i]`` only when
        ``span_z`` has a row per self layer (n_layers - n_layers /
        cross_attn_every), and ``span_z[0]`` otherwise, which is every
        self layer under ``init_params``' [n_layers, n_heads]."""
        img = self._aux_input(batch, "image_embeds", "the image embeddings [B, n_image_tokens, d_model]",
                              tokens.device)
        h = self.embed(p, tokens)
        span = p.get("span_z")
        layers = _unstack(p["layers"])
        spans = (self._layer_spans(p, len(layers)) if span is None or span.shape[0] in (1, len(layers))
                 else [span[0]] * len(layers))

        def group(lps, spans, xp, h, img):
            for lp, span_z in zip(lps, spans):
                h = self._dense_layer_step(lp, h, causal=True, span_z=span_z)
            return self._cross_layer_step(xp, h, img)

        step = self._remat(group)
        for (_, selfs), xp in zip(self._vlm_groups(), _unstack(p["cross_layers"])):
            h = step([layers[i] for i in selfs], [spans[i] for i in selfs], xp, h, img)
        return self._lm_output(p, h)

    def _forward_albert(self, p: Params, tokens: torch.Tensor, batch) -> ModelOutput:
        """The shared layer n_layers times, non-causal (the JAX package's
        ``_forward_albert``)."""
        cfg = self.cfg
        h = self.embed(p, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        span_z = self._span_for_layer(p, 0)

        def layer_fn(i, h):
            return self._dense_layer_step(p["layer"], h, causal=False, span_z=span_z)

        if cfg.edgebert.early_exit.enabled and "offramp" in p:
            all_logits, all_ent = ee.exit_all_layers(layer_fn, cfg.n_layers, h, self._offramp(p))
            exit_layer, _ = ee.exit_decisions(all_ent, cfg.edgebert.early_exit.entropy_threshold)
            return ModelOutput(
                cls_logits=ee.select_exit_logits(all_logits, exit_layer), aux_loss=aux,
                all_cls_logits=all_logits, all_entropies=all_ent, exit_layer=exit_layer,
            )
        step = self._remat(lambda lp, h, span_z: self._dense_layer_step(lp, h, causal=False, span_z=span_z))
        for _ in range(cfg.n_layers):
            h = step(p["layer"], h, span_z)
        cls = self.cls_logits(p, h) if "classifier" in p else None
        logits = self.lm_logits(p, h) if cfg.vocab_size else None
        return ModelOutput(logits=logits, cls_logits=cls, aux_loss=aux)

    def _forward_encoder(self, p: Params, tokens: torch.Tensor, batch) -> ModelOutput:
        """Every encoder layer, bidirectional, each followed by its off-ramp
        (``encoder_offramp``): every off-ramp's logits and entropy, the exit
        layers under the config's threshold and the exit logits.  The
        activation quantization takes one bias per batch row (each row a
        sentence padded to the batch's length, as the serving step gives
        each lane its own), and ``batch["lengths"]`` masks each row's
        padding out of attention."""
        cfg = self.cfg
        h = self.embed(p, tokens)
        lengths = batch.get("lengths")
        kv_len = None if lengths is None else torch.as_tensor(lengths, device=h.device)
        step = self._remat(lambda lp, h, i: self.encoder_layer_step(lp, h, layer=i, kv_len=kv_len, per_lane=True))
        logits = []
        for i, lp in enumerate(_unstack(p["layers"])):
            h = step(lp, h, i)
            logits.append(self.encoder_offramp(p, h, i))
        all_logits = torch.stack(logits)
        all_ent = entropy_from_logits(all_logits)
        exit_layer, _ = ee.exit_decisions(all_ent, cfg.edgebert.early_exit.entropy_threshold)
        return ModelOutput(cls_logits=ee.select_exit_logits(all_logits, exit_layer),
                           aux_loss=torch.zeros((), dtype=torch.float32, device=h.device),
                           all_cls_logits=all_logits, all_entropies=all_ent, exit_layer=exit_layer)

    # ---- token-level early exit (the decoder's training-time form) ----
    def _head_entropy(self, p: Params, h: torch.Tensor, use_kernels: bool = False):
        """The LM-head off-ramp: logits of the final-normed h and their
        entropy (``dispatch.entropy``, the softmax_entropy kernel, on the
        kernel route)."""
        lg = self.lm_logits(p, L.apply_norm(p["final_norm"], h, kind=self.cfg.norm, use_kernels=use_kernels))
        return lg, (dispatch.entropy(lg) if use_kernels else entropy_from_logits(lg))

    def _check_decoder(self, early_exit: bool = False) -> None:
        """Decode, prefill and the cache serve the dense, MoE, albert, ssm,
        hybrid and encdec families; per-token exit and speculative decode
        (``early_exit``) the dense, MoE and albert families only, as in the
        JAX package."""
        families = ("dense", "moe", "albert") if early_exit else ("albert",) + DECODER_FAMILIES
        if self.cfg.family not in families:
            what = "per-token exit and speculative decode" if early_exit else "decode"
            raise ValueError(f"{what}: the {', '.join(families)} families, not {self.cfg.family}")

    def forward_token_exit(self, p: Params, tokens: torch.Tensor, threshold: float):
        """Per-TOKEN early exit over a whole sequence: after each layer,
        tokens whose LM-head entropy is below ``threshold`` freeze (their
        hidden state stops evolving).  Returns (logits [B, S, V],
        exit_layer [B, S]).  MoE layers route all B x S tokens together,
        as the JAX package's call does."""
        if self.cfg.family not in ("dense", "moe"):
            raise ValueError(f"token exit: the dense and MoE decoder LMs, not {self.cfg.family}")
        n = self.cfg.n_layers
        h = self.embed(p, torch.as_tensor(tokens, device=p["embed"]["tok"].device))
        B, S, _ = h.shape
        done = torch.zeros((B, S), dtype=torch.bool, device=h.device)
        exit_layer = torch.full((B, S), n, dtype=torch.int32, device=h.device)
        for i in range(n):
            h_new = self._dense_layer_step(self._layer(p, i)[0], h, causal=True)
            h = torch.where(done[..., None], h, h_new)
            _, ent = self._head_entropy(p, h)
            exit_now = ~done & (ent < threshold)
            exit_layer = torch.where(exit_now, i + 1, exit_layer)
            done = done | exit_now
        return self._head_entropy(p, h)[0], exit_layer

    # ============================================================ decode ====
    def init_cache(self, batch_size: int, max_seq: int, device: DeviceLike = "cuda") -> Params:
        """The zeroed decode state, every leaf [n, B, ...] (layer, then
        lane): the KV-cache families' {"k", "v"} [n_layers, B, max_seq, KV,
        head_dim] in the config's dtype, or uint8 AF8 codes
        (``kv_cache_dtype="af8"``); the ssm family's recurrent state,
        whatever ``max_seq``: the token-shift inputs "last_tm" and
        "last_cm" [n_layers, B, 1, d] in the config's dtype and the WKV
        state "wkv" [n_layers, B, H, K, K] in float32; the hybrid family's
        conv state "conv" [n_layers, B, 3, d_inner + 2 ssm_state] and SSM
        state "ssm" [n_layers, B, H, P, N] in the config's dtype, with the
        shared block's "k" / "v" [n_attn, B, max_seq, KV, head_dim]; the
        encdec family's "k" / "v" and the encoder's cross K/V "enc_k" /
        "enc_v" [n_layers, B, enc_seq_len, KV, head_dim] in the config's
        dtype (``prefill`` writes them); the vlm family's "k" / "v" for its
        self layers and the image K/V "img_k" / "img_v" [n_cross, B,
        n_image_tokens, KV, head_dim] in the config's dtype (``prefill``
        writes them; the serving prefill leaves them zero, as the JAX
        server does)."""
        self._check_decoder()
        cfg = self.cfg
        dev = resolve_device(device)
        dtype = _DTYPES[cfg.dtype]
        B = batch_size

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        if cfg.family == "ssm":
            n, d, H, K = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim
            return {"last_tm": zeros(n, B, 1, d), "last_cm": zeros(n, B, 1, d),
                    "wkv": zeros(n, B, H, K, K, dt=torch.float32)}
        kv_dtype = torch.uint8 if cfg.kv_cache_dtype == "af8" else dtype

        def kv(n):
            return {"k": zeros(n, B, max_seq, cfg.n_kv_heads, cfg.head_dim, dt=kv_dtype),
                    "v": zeros(n, B, max_seq, cfg.n_kv_heads, cfg.head_dim, dt=kv_dtype)}

        if cfg.family == "hybrid":
            n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
            cache = {"conv": zeros(cfg.n_layers, B, mamba2.CONV_K - 1, mamba2.d_inner(cfg) + 2 * cfg.ssm_state),
                     "ssm": zeros(cfg.n_layers, B, mamba2.n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state)}
            return {**cache, **kv(n_attn)} if n_attn else cache
        if cfg.family == "vlm":
            n_cross = cfg.n_layers // cfg.cross_attn_every
            img = (n_cross, B, cfg.n_image_tokens, cfg.n_kv_heads, cfg.head_dim)
            return {**kv(cfg.n_layers - n_cross), "img_k": zeros(*img), "img_v": zeros(*img)}
        cache = kv(cfg.n_layers)
        if cfg.family == "encdec":
            enc = (cfg.n_layers, B, cfg.enc_seq_len, cfg.n_kv_heads, cfg.head_dim)
            cache.update(enc_k=zeros(*enc), enc_v=zeros(*enc))
        return cache

    def _rwkv_layers(self, p: Params, h: torch.Tensor, cache: Params, *, decode: bool, per_lane: bool = False):
        """Every RWKV6 layer over h, writing each layer's new state into
        ``cache`` in place: a decode step from the cache's state, or a
        prefill from a zero state (the chunked WKV)."""
        for i in range(self.cfg.n_layers):
            states = {k: cache[k][i] for k in ("last_tm", "last_cm", "wkv")} if decode else None
            h, new = self._rwkv_layer_step(self._layer(p, i)[0], h, states=states, decode=decode, per_lane=per_lane)
            for k, v in new.items():
                cache[k][i].copy_(v)
        return h

    def _hybrid_layers(self, p: Params, h: torch.Tensor, cache: Params, *, positions, cache_pos, decode: bool,
                       per_lane: bool = False):
        """Every Mamba2 block over h, writing each block's conv and SSM state
        into ``cache`` in place (a decode step from the cache's state, or a
        prefill from a zero state, the chunked SSD), and the shared block
        after blocks i with (i + 1) % attn_every == 0, on concat(h, x0) with
        its own KV cache row per call and ``span_z[0]``."""
        cfg = self.cfg
        x0 = h
        n_attn = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        attn_idx = 0
        for i in range(cfg.n_layers):
            states = {k: cache[k][i] for k in ("conv", "ssm")} if decode else None
            h, new = self._mamba_block_step(self._layer(p, i)[0], h, states=states, decode=decode, per_lane=per_lane)
            for k, v in new.items():
                cache[k][i].copy_(v)
            if cfg.attn_every and (i + 1) % cfg.attn_every == 0 and attn_idx < n_attn:
                h = self._shared_attn_step(p["shared_attn"], h, x0, span_z=self._span_for_layer(p, 0),
                                           cache=(cache["k"][attn_idx], cache["v"][attn_idx]),
                                           cache_pos=cache_pos, positions=positions)
                attn_idx += 1
        return h

    def _vlm_layers(self, p: Params, h: torch.Tensor, cache: Params, *, positions, cache_pos, per_lane: bool = False):
        """Every group of the vlm stack over h: its self layers with their
        KV written into ``cache`` in place, then its cross layer against
        the cache's image K/V (no kernel flag and no span reaches them in
        the JAX package's decode and prefill, and the cross layer adds no
        activation quantization there)."""
        for g, selfs in self._vlm_groups():
            for i in selfs:
                h = self._dense_layer_step(self._layer(p, i)[0], h, causal=True, positions=positions,
                                           cache=(cache["k"][i], cache["v"][i]), cache_pos=cache_pos,
                                           per_lane=per_lane)
            h = h + self._cross_decode(self._layer(p, g, "cross_layers")[0], h, cache["img_k"][g], cache["img_v"][g])
        return h

    def _positions(self, pos: Any, S: int, device) -> tuple:
        """(pos as a [B] or [1] tensor, positions [B, S]) for a cache
        position per lane (or one for all)."""
        pos_t = torch.as_tensor(pos, device=device).reshape(-1)
        return pos_t, pos_t[:, None] + torch.arange(S, device=device)

    def decode_step(self, p: Params, cache: Params, tokens: torch.Tensor, pos: Any, aux: Optional[Params] = None,
                    use_kernels: bool = False, per_lane: bool = True):
        """One decode step: tokens [B, S] at cache position ``pos`` ([B] or
        scalar) through every layer, writing their K/V into ``cache`` in
        place.  ``per_lane`` computes each lane as the JAX serving step's
        per-lane ``vmap`` does: an MoE layer routes each lane's tokens on
        their own, and the activation quantization takes one bias per lane;
        ``per_lane=False`` is the JAX model's batched call, which its
        serving prefill makes: MoE layers route as the config groups them
        (all lanes together by default) and one bias covers the batch.  The
        dense and MoE layers take ``span_z[i]`` and ``use_kernels`` (the
        quantize kernel after each layer).  The ssm family steps its
        recurrent state instead (``pos`` unused), in place too; only its
        final LayerNorm takes ``use_kernels``, as in the JAX package.  The
        hybrid family steps its blocks' conv and SSM state and the shared
        block's KV cache (with ``span_z[0]``); its norms are RMS, which has
        no kernel, so ``use_kernels`` changes nothing for it, as in the JAX
        package.  The encdec family attends each layer's encoder K/V in the
        cache (``prefill`` writes them); only its final LayerNorm takes
        ``use_kernels``, and its layers take no span, as in the JAX
        package.  The vlm family runs each group's self layers (no span),
        then the group's gated cross layer against the image K/V in the
        cache; its layers take no kernel flag in the JAX package, and its
        final norm is RMS.  The activation quantization of every family but
        the dense and MoE ones stays on the reference ops, as the JAX
        package passes them no ``use_pallas``.  ``aux`` is the JAX
        signature's and unused.  Returns (logits [B, S, V], cache)."""
        self._check_decoder()
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=p["embed"]["tok"].device)
        if cfg.family == "ssm":
            h = self._rwkv_layers(p, self.embed(p, tokens), cache, decode=True, per_lane=per_lane)
            h = L.apply_norm(p["final_norm"], h, use_kernels=use_kernels)
            return self.lm_logits(p, h), cache
        pos_t, positions = self._positions(pos, tokens.shape[1], tokens.device)
        h = self.embed(p, tokens, positions=positions)
        if cfg.family == "hybrid":
            h = self._hybrid_layers(p, h, cache, positions=positions, cache_pos=pos_t, decode=True, per_lane=per_lane)
        elif cfg.family == "vlm":
            h = self._vlm_layers(p, h, cache, positions=positions, cache_pos=pos_t, per_lane=per_lane)
        else:
            encdec = cfg.family == "encdec"
            for i in range(cfg.n_layers):
                # the encdec family's layers pass no kernel flag and no span in the JAX package
                h = self._dense_layer_step(self._layer(p, i)[0], h, causal=True, positions=positions,
                                           span_z=None if encdec else self._span_for_layer(p, i),
                                           cache=(cache["k"][i], cache["v"][i]), cache_pos=pos_t,
                                           use_kernels=use_kernels and not encdec,
                                           per_lane=per_lane, moe_grouped=per_lane or None)
                if encdec:
                    h = h + self._precomputed_cross(self._layer(p, i, "dec_cross")[0], h, cache["enc_k"][i],
                                                    cache["enc_v"][i])
        # an RMS final norm has no kernel: use_kernels is a no-op for it
        h = L.apply_norm(p["final_norm"], h, kind=cfg.norm, use_kernels=use_kernels)
        return self.lm_logits(p, h), cache

    def decode_step_ee(self, p: Params, cache: Params, tokens: torch.Tensor, pos: Any,
                       threshold: Any, use_kernels: bool = False):
        """One decode step with PER-TOKEN early exit (EdgeBERT's entropy
        off-ramp generalized to autoregressive decode).

        After every layer the LM head (post final-norm) is evaluated on the
        current hidden state; once its entropy drops below ``threshold``
        (scalar or one per lane) the token FREEZES: the remaining layers
        still write their K/V rows from the frozen input (state
        propagation), but the token's representation stops evolving, and
        the returned exit depth is what the modeled hardware executes.  The
        computation is masked, so the step keeps its shapes.

        Layer i takes ``span_z[i]``.  Each lane is computed as the JAX
        serving step's lane ``vmap`` computes it: MoE layers route each
        lane on its own and the activation quantization takes one bias per
        lane.  Returns ``(logits [B, 1, V], cache, exit_layer [B]
        (1-based), first_entropy [B])``, the last the entropy after layer
        1."""
        self._check_decoder(early_exit=True)
        n = self.cfg.n_layers
        tokens = torch.as_tensor(tokens, device=p["embed"]["tok"].device)
        dev = tokens.device
        pos_t, positions = self._positions(pos, tokens.shape[1], dev)
        h = self.embed(p, tokens, positions=positions)
        B = h.shape[0]
        thr = torch.as_tensor(threshold, dtype=torch.float32, device=dev).reshape(-1, 1)
        done = torch.zeros((B, 1), dtype=torch.bool, device=dev)
        logits = torch.zeros((B, 1, self.cfg.vocab_size), dtype=torch.float32, device=dev)
        exit_layer = torch.zeros(B, dtype=torch.int32, device=dev)
        first_ent = torch.zeros(B, dtype=torch.float32, device=dev)
        for i in range(n):
            lp = self._layer(p, i)[0]
            h_new = self._dense_layer_step(lp, h, causal=True, positions=positions, span_z=self._span_for_layer(p, i),
                                           cache=(cache["k"][i], cache["v"][i]), cache_pos=pos_t,
                                           use_kernels=use_kernels, per_lane=True, moe_grouped=True)
            # frozen tokens keep their exited representation; the layer's KV
            # write above came from that frozen input (state propagation)
            h = torch.where(done[..., None], h, h_new)
            lg, ent = self._head_entropy(p, h, use_kernels)           # [B, 1, V], [B, 1]
            exit_now = ~done & (ent < thr)
            take = (exit_now | ~done) if i == n - 1 else exit_now
            logits = torch.where(take[..., None], lg, logits)
            exit_layer = torch.where(take[:, 0], i + 1, exit_layer)
            if i == 0:
                first_ent = ent[:, 0]
            done = done | exit_now
        return logits, cache, exit_layer, first_ent

    def decode_step_spec(self, p: Params, cache: Params, tokens: torch.Tensor, pos: Any,
                         thresholds: Any, spec_window: int, eos_id: int = -1,
                         use_kernels: bool = False):
        """Self-speculative fused decode step via the entropy off-ramps.

        Each lane runs up to ``spec_window`` slots, and every slot is
        EXACTLY one ``decode_step_ee``: the off-ramp at layer k emits the
        draft (the frozen hidden state), layers k+1..L verify it (state
        propagation pushes the draft through them, so the returned logits
        are the verified output).  A lane keeps speculating while its tokens
        take an off-ramp (``exit_layer < n_layers``) and are not EOS; the
        first token the verifier forces to full depth is still emitted but
        ends the block.  ``accepted[:, j]`` marks the accepted prefix;
        slots after it recompute the lane's frozen (token, position), whose
        K/V rows are the ones the next step writes again, so rollback is
        not advancing the host position past the prefix.

        The JAX package runs one lane per call and ``vmap``s lanes; here the
        lanes are the batch: ``tokens`` [B, 1], ``pos`` [B] (or scalar),
        ``thresholds`` scalar, [W] or [B, W] (slot j gates the token at
        ``pos + j``); MoE layers route each lane on its own and the
        activation quantization takes one bias per lane.  Returns
        ``(tokens [B, W], logits [B, W, V], cache, exit_layers [B, W],
        first_ent [B, W], accepted [B, W])``."""
        self._check_decoder(early_exit=True)
        W = int(spec_window)
        if W < 1:
            raise ValueError("spec_window must be >= 1")
        n = self.cfg.n_layers
        cur = torch.as_tensor(tokens, device=p["embed"]["tok"].device).long()
        dev, B = cur.device, cur.shape[0]
        thr = torch.as_tensor(thresholds, dtype=torch.float32, device=dev)
        thr = thr.reshape(-1, W).expand(B, W) if thr.ndim else thr.expand(B, W)
        posn = torch.as_tensor(pos, device=dev).reshape(-1).expand(B).long()
        alive = torch.ones(B, dtype=torch.bool, device=dev)
        outs = []
        for j in range(W):
            accept = alive                      # accepted iff it entered alive
            lg, cache, xl, fe = self.decode_step_ee(p, cache, cur, posn, thr[:, j], use_kernels)
            tok = lg[:, -1, :].argmax(dim=-1)
            alive = accept & (xl < n) & (tok != eos_id)
            cur = torch.where(accept[:, None], tok[:, None], cur)
            posn = posn + accept.long()
            outs.append((tok, lg[:, -1, :], xl, fe, accept))
        toks, lgs, xls, fes, accs = (torch.stack(t, dim=1) for t in zip(*outs))
        return toks, lgs, cache, xls, fes, accs

    # ---------------------------------------------------------------- prefill
    def prefill(self, p: Params, tokens: torch.Tensor, cache: Params, aux: Optional[Params] = None):
        """The whole prompt through the model in one pass, filling the cache
        at positions 0..S-1 (in place); MoE layers route all B x S tokens
        together, as the JAX package's call does.  The ssm family runs the
        chunked WKV, and the hybrid family the chunked SSD, from a zero
        state, whatever the cache holds (as the JAX package's prefill does),
        and write the state after the prompt into the cache in place (the
        hybrid family needs 3 prompt tokens or more: its conv state is the
        last 3; the JAX package fails on fewer).  The encdec family encodes
        ``aux["enc_input"]`` (frames [B, enc_seq_len, d_model]) once and
        writes every layer's cross K/V into the cache; the vlm family
        projects ``aux["image_embeds"]`` ([B, n_image_tokens, d_model]) to
        every cross layer's image K/V and writes them into the cache.  Every norm and every
        activation quantization stays on the reference ops, one bias over the
        whole batch, as in the JAX package; the dense, MoE, encdec and vlm
        layers take no span there (the JAX package passes none), the hybrid
        family's shared block ``span_z[0]``.  Returns (last-token logits
        [B, 1, V], cache)."""
        self._check_decoder()
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=p["embed"]["tok"].device)
        h = self.embed(p, tokens)
        if cfg.family == "ssm":
            h = L.apply_norm(p["final_norm"], self._rwkv_layers(p, h, cache, decode=False))
            return self.lm_logits(p, h[:, -1:]), cache
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        if cfg.family == "hybrid":
            if tokens.shape[1] < mamba2.CONV_K - 1:
                raise ValueError(f"the hybrid prefill needs {mamba2.CONV_K - 1} prompt tokens or more (the conv "
                                 f"state is the last {mamba2.CONV_K - 1}), got {tokens.shape[1]}")
            h = self._hybrid_layers(p, h, cache, positions=positions, cache_pos=0, decode=False)
        elif cfg.family == "vlm":
            if not aux or "image_embeds" not in aux:
                raise ValueError('the vlm prefill needs aux["image_embeds"], the image embeddings '
                                 "[B, n_image_tokens, d_model]")
            img = torch.as_tensor(aux["image_embeds"], device=tokens.device)
            xattn = p["cross_layers"]["xattn"]
            for name, w in (("img_k", "wk"), ("img_v", "wv")):
                cache[name].copy_(L._split_heads(_per_layer_proj(img, xattn[w]), cfg.n_kv_heads, cfg.head_dim))
            h = self._vlm_layers(p, h, cache, positions=positions, cache_pos=0)
        else:
            encdec = cfg.family == "encdec"
            if encdec:
                if not aux or "enc_input" not in aux:
                    raise ValueError('the encdec prefill needs aux["enc_input"], the encoder frames '
                                     "[B, enc_seq_len, d_model]")
                enc = self._encode(p, torch.as_tensor(aux["enc_input"], device=tokens.device))
                for name, w in (("enc_k", "wk"), ("enc_v", "wv")):
                    cache[name].copy_(L._split_heads(_per_layer_proj(enc, p["dec_cross"]["xattn"][w]),
                                                     cfg.n_kv_heads, cfg.head_dim))
            for i in range(cfg.n_layers):
                lp, span_z = self._layer(p, i)
                h = self._dense_layer_step(lp, h, causal=True, positions=positions, span_z=span_z,
                                           cache=(cache["k"][i], cache["v"][i]), cache_pos=0)
                if encdec:
                    h = h + self._precomputed_cross(self._layer(p, i, "dec_cross")[0], h, cache["enc_k"][i],
                                                    cache["enc_v"][i])
        h = L.apply_norm(p["final_norm"], h, kind=cfg.norm)
        return self.lm_logits(p, h[:, -1:]), cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
