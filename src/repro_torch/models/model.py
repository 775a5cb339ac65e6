"""The port's model (``repro/models/model.py``): the albert family and the
dense and MoE decoder families.

``init_params`` returns a tree with exactly the keys and shapes of the JAX
package's ``Model.init_params`` for those families, with the same init
scales; the decoder families' layers are stacked on a leading
``[n_layers]`` axis as the JAX package's ``_stack_init`` stacks them (the
MoE family's expert weights too: ``[n_layers, E, d, ff]``).  The random numbers
come from a ``torch.Generator`` and so differ from JAX's; parity tests
bring the JAX tree across with ``repro_torch.bridge`` instead.

``Model`` carries the layer math the classifier serving step and the dense
all-layers forward (``apply_train``) run: embedding, the post-LN shared
encoder layer, activation fake-quant, the early-exit off-ramp; and the
decoder's: the pre-LN layer (RMS norm, rotary positions, qkv biases where
the config has them, SwiGLU or the MoE layer of ``models/moe.py``), the
untied LM head, the KV cache (``init_cache``, ``prefill``, ``decode_step``)
and per-token early exit (``decode_step_ee``, ``decode_step_spec``,
``forward_token_exit``).  Its methods take a tree of tensors on one device
and compute there; the decode methods take each lane's cache position as a
``[B]`` tensor (the JAX package ``vmap``s one-lane calls with a scalar) and
write the cache in place.

MoE routing couples the tokens of one routing through expert capacity, so
each method keeps the JAX package's grouping: the decode methods route each
lane on its own (the serving step's per-lane ``vmap``; ``decode_step`` with
``moe_per_lane=False`` routes the lanes together, as the serving prefill
needs), ``prefill`` and ``forward_token_exit`` route the whole batch
together (the JAX model's batched calls).
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import early_exit as ee
from repro_torch.core.adaptivfloat import AFFormat, fake_quant
from repro_torch.core.entropy import entropy_from_logits
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models import moe

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _normal(gen: torch.Generator, shape: Sequence[int], scale: float) -> torch.Tensor:
    # scaled in place: a stacked 7B weight is gigabytes, and a copy doubles it
    return torch.randn(tuple(shape), generator=gen, device=gen.device).mul_(scale)


def _init_dense_params(cfg: ModelConfig, gen: torch.Generator, dev: torch.device) -> Params:
    """The decoder families' tree: token embedding (with a projection where
    ``embed_dim`` differs from ``d_model``, as in the smoke config), the
    layers stacked on a leading [n_layers] axis (zero qkv biases with
    ``qkv_bias``, as the JAX package's ``init_attention`` makes them; the
    SwiGLU MLP, or for the MoE family ``moe.init_moe``'s tree), the final
    RMS norm and the untied LM head."""
    dtype = _DTYPES[cfg.dtype]
    d, hd, H, KV, L_ = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers

    def stacked(shape, scale=None):
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        return _normal(gen, (L_,) + tuple(shape), scale).to(dev, dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    embed = {"tok": _normal(gen, (cfg.vocab_size, cfg.embed_dim), 0.02).to(dev, dtype)}
    if cfg.embed_dim != d:
        embed["proj"] = _normal(gen, (cfg.embed_dim, d), 1.0 / math.sqrt(cfg.embed_dim)).to(dev, dtype)
    attn = {"wq": stacked((d, H * hd)), "wk": stacked((d, KV * hd)),
            "wv": stacked((d, KV * hd)), "wo": stacked((H * hd, d))}
    if cfg.qkv_bias:
        attn.update(bq=torch.zeros(L_, H * hd, dtype=dtype, device=dev),
                    bk=torch.zeros(L_, KV * hd, dtype=dtype, device=dev),
                    bv=torch.zeros(L_, KV * hd, dtype=dtype, device=dev))
    layers = {"norm1": {"scale": ones(L_, d)}, "attn": attn, "norm2": {"scale": ones(L_, d)}}
    if cfg.family == "moe":
        layers["moe"] = moe.init_moe(cfg, gen, dev, dtype, lead=(L_,))
    else:
        layers["mlp"] = {"w_gate": stacked((d, cfg.d_ff)), "w_up": stacked((d, cfg.d_ff)),
                         "w_down": stacked((cfg.d_ff, d))}
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": {"scale": ones(d)},
        "lm_head": _normal(gen, (d, cfg.vocab_size), 0.02).to(dev, dtype),
    }


def _check_dense(cfg: ModelConfig) -> None:
    """The decoders as deepseek-7b and the qwen MoE configs have them:
    pre-LN with RMS norm, rotary positions, SwiGLU (in every expert too),
    with or without qkv biases, an untied LM head, none of the EdgeBERT
    encoder features (spans, activation quantization, off-ramps); the MoE
    family with its experts and top-k."""
    eb = cfg.edgebert
    if (cfg.family not in ("dense", "moe")
            or (cfg.family == "moe" and not (cfg.n_experts and cfg.top_k))
            or (cfg.act, cfg.norm, cfg.pos, cfg.tie_embeddings, cfg.shared_layers) != (
                "swiglu", "rms", "rope", False, False)
            or eb.span.enabled or eb.quant.enabled or eb.early_exit.enabled or cfg.num_classes):
        raise ValueError("only the dense decoder of deepseek-7b's kind and the MoE decoder of qwen-moe's "
                         "(swiglu, rms, rope, untied head, no EdgeBERT encoder features) are ported")


def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = "cuda",
) -> Params:
    """Random params on ``device``.  The albert family draws from
    ``generator`` (a seed-0 CPU generator when None); the decoder families
    from ``generator`` on the generator's own device (a seed-0 generator on
    ``device`` when None), so a 7B tree made for the card is drawn there."""
    if cfg.family in ("dense", "moe"):
        _check_dense(cfg)
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
        return _init_dense_params(cfg, gen, dev)
    if (cfg.family, cfg.act, cfg.norm, cfg.qkv_bias, cfg.tie_embeddings) != (
        "albert", "gelu", "layernorm", False, True
    ):
        raise ValueError("only the ALBERT configs (gelu, layernorm, tied embeddings) and the dense "
                         "and MoE decoders are ported")
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
    aux_loss: Any = 0.0                            # router / span regularizers (a float32 scalar)
    all_cls_logits: Optional[torch.Tensor] = None  # [L, B, C] off-ramp sweep
    all_entropies: Optional[torch.Tensor] = None   # [L, B]
    exit_layer: Optional[torch.Tensor] = None      # [B]


class Model:
    """The albert, dense and MoE families of the JAX package's ``Model``:
    one shared post-LN encoder layer with entropy off-ramps and AdaptivFloat
    activations, or a stack of pre-LN decoder layers (SwiGLU or MoE) with a
    KV cache and per-token early exit on the LM head."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family in ("dense", "moe"):
            _check_dense(cfg)
        elif cfg.family != "albert" or not cfg.shared_layers:
            raise ValueError("only the albert family (one shared layer) and the dense and MoE families "
                             "are ported")
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
    ) -> torch.Tensor:
        """One layer (the JAX package's ``_dense_layer_step``) -> the new h:
        post-LN for the albert family, pre-LN for the decoder families.  An
        MoE layer routes each batch row on its own with ``moe_grouped``, all
        rows together without it (None: the config's
        ``moe_grouped_dispatch``); its aux loss is not kept."""
        cfg = self.cfg
        attn = dict(causal=causal, positions=positions, span_z=span_z, span_ramp=cfg.edgebert.span.ramp,
                    kv_len=kv_len, cache=cache, cache_pos=cache_pos, use_kernels=use_kernels)
        if cfg.family == "albert":
            attn_out = L.attention_layer(lp["attn"], h, cfg, **attn)
            h = L.apply_norm(lp["norm1"], h + attn_out, use_kernels=use_kernels)
            mo = L.apply_mlp(lp["mlp"], h, use_kernels=use_kernels, block_masks=block_masks)
            h = L.apply_norm(lp["norm2"], h + mo, use_kernels=use_kernels)
            return self._maybe_actquant(h, use_kernels=use_kernels, per_lane=per_lane)
        h = h + L.attention_layer(lp["attn"], L.apply_norm(lp["norm1"], h, kind=cfg.norm), cfg, **attn)
        hn = L.apply_norm(lp["norm2"], h, kind=cfg.norm)
        if "moe" in lp:
            return h + moe.apply_moe(lp["moe"], hn, cfg, grouped=moe_grouped)[0]
        return h + L.apply_mlp(lp["mlp"], hn, use_kernels=use_kernels, block_masks=block_masks, act=cfg.act)

    def _layer(self, p: Params, i: int):
        """(layer params, span) of layer ``i``: the shared layer (albert) or
        views into the stacked layers (dense, MoE)."""
        if self.cfg.family == "albert":
            return p["layer"], self._span_for_layer(p, 0)

        def take(node):
            return {k: take(v) for k, v in node.items()} if isinstance(node, dict) else node[i]

        return take(p["layers"]), None

    def _span_for_layer(self, p: Params, i: int) -> Optional[torch.Tensor]:
        if "span_z" not in p:
            return None
        z = p["span_z"]
        return z[0] if z.shape[0] == 1 else z[i]

    # ------------------------------------------------------------- forward
    def apply_train(self, p: Params, batch: Dict[str, Any]) -> ModelOutput:
        """Dense all-layers forward of the albert family (every off-ramp's
        logits and entropy when early exit is on).  It runs on the reference
        ops only (no kernel has a backward), so autograd differentiates it
        end to end, as XLA differentiates the JAX package's."""
        cfg = self.cfg
        if cfg.family != "albert":
            raise NotImplementedError("the dense family's training forward is not ported")
        tokens = torch.as_tensor(batch["tokens"], device=p["embed"]["tok"].device)
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
        for i in range(cfg.n_layers):
            h = layer_fn(i, h)
        cls = self.cls_logits(p, h) if "classifier" in p else None
        logits = self.lm_logits(p, h) if cfg.vocab_size else None
        return ModelOutput(logits=logits, cls_logits=cls, aux_loss=aux)

    # ---- token-level early exit (the decoder's training-time form) ----
    def _head_entropy(self, p: Params, h: torch.Tensor, use_kernels: bool = False):
        """The LM-head off-ramp: logits of the final-normed h and their
        entropy (``dispatch.entropy``, the softmax_entropy kernel, on the
        kernel route)."""
        lg = self.lm_logits(p, L.apply_norm(p["final_norm"], h, kind=self.cfg.norm, use_kernels=use_kernels))
        return lg, (dispatch.entropy(lg) if use_kernels else entropy_from_logits(lg))

    def _check_decoder(self) -> None:
        if self.cfg.family not in ("dense", "moe", "albert"):
            raise ValueError("KV-cache decode: the dense, MoE and albert families")

    def forward_token_exit(self, p: Params, tokens: torch.Tensor, threshold: float):
        """Per-TOKEN early exit over a whole sequence: after each layer,
        tokens whose LM-head entropy is below ``threshold`` freeze (their
        hidden state stops evolving).  Returns (logits [B, S, V],
        exit_layer [B, S]).  MoE layers route all B x S tokens together,
        as the JAX package's call does."""
        if self.cfg.family not in ("dense", "moe"):
            raise ValueError("token exit: decoder LMs")
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
        """Zeroed KV cache {"k", "v"}: [n_layers, B, max_seq, KV, head_dim]
        in the config's dtype, or uint8 AF8 codes (``kv_cache_dtype="af8"``)."""
        self._check_decoder()
        cfg = self.cfg
        dtype = torch.uint8 if cfg.kv_cache_dtype == "af8" else _DTYPES[cfg.dtype]
        shape = (cfg.n_layers, batch_size, max_seq, cfg.n_kv_heads, cfg.head_dim)
        dev = resolve_device(device)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    def _positions(self, pos: Any, S: int, device) -> tuple:
        """(pos as a [B] or [1] tensor, positions [B, S]) for a cache
        position per lane (or one for all)."""
        pos_t = torch.as_tensor(pos, device=device).reshape(-1)
        return pos_t, pos_t[:, None] + torch.arange(S, device=device)

    def decode_step(self, p: Params, cache: Params, tokens: torch.Tensor, pos: Any,
                    use_kernels: bool = False, moe_per_lane: bool = True):
        """One decode step: tokens [B, S] at cache position ``pos`` ([B] or
        scalar) through every layer, writing their K/V into ``cache`` in
        place.  MoE layers route each lane's tokens on their own
        (``moe_per_lane``, the JAX serving step's per-lane ``vmap``), or
        with ``moe_per_lane=False`` as the config groups them, all lanes
        together by default (the JAX model's batched call, which its
        serving prefill makes).  Returns (logits [B, S, V], cache)."""
        self._check_decoder()
        tokens = torch.as_tensor(tokens, device=p["embed"]["tok"].device)
        pos_t, positions = self._positions(pos, tokens.shape[1], tokens.device)
        h = self.embed(p, tokens, positions=positions)
        for i in range(self.cfg.n_layers):
            lp, span_z = self._layer(p, i)
            h = self._dense_layer_step(lp, h, causal=True, positions=positions, span_z=span_z,
                                       cache=(cache["k"][i], cache["v"][i]), cache_pos=pos_t,
                                       use_kernels=use_kernels, moe_grouped=moe_per_lane or None)
        h = L.apply_norm(p["final_norm"], h, kind=self.cfg.norm, use_kernels=use_kernels)
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

        MoE layers route each lane on its own (the JAX serving step's lane
        ``vmap``).  Returns ``(logits [B, 1, V], cache, exit_layer [B]
        (1-based), first_entropy [B])``, the last the entropy after layer
        1."""
        self._check_decoder()
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
            lp, span_z = self._layer(p, i)
            h_new = self._dense_layer_step(lp, h, causal=True, positions=positions, span_z=span_z,
                                           cache=(cache["k"][i], cache["v"][i]), cache_pos=pos_t,
                                           use_kernels=use_kernels, moe_grouped=True)
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
        ``pos + j``); MoE layers route each lane on its own.  Returns
        ``(tokens [B, W], logits [B, W, V], cache, exit_layers [B, W],
        first_ent [B, W], accepted [B, W])``."""
        self._check_decoder()
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
    def prefill(self, p: Params, tokens: torch.Tensor, cache: Params):
        """The whole prompt through the model in one pass, filling the cache
        at positions 0..S-1 (in place); MoE layers route all B x S tokens
        together, as the JAX package's call does.  Returns (last-token
        logits [B, 1, V], cache)."""
        self._check_decoder()
        tokens = torch.as_tensor(tokens, device=p["embed"]["tok"].device)
        h = self.embed(p, tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        for i in range(self.cfg.n_layers):
            lp, span_z = self._layer(p, i)
            h = self._dense_layer_step(lp, h, causal=True, positions=positions, span_z=span_z,
                                       cache=(cache["k"][i], cache["v"][i]), cache_pos=0)
        h = L.apply_norm(p["final_norm"], h, kind=self.cfg.norm)
        return self.lm_logits(p, h[:, -1:]), cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
