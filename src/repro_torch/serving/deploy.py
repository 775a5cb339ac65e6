"""Deployed EdgeBERT: the accelerator's dataflow on the port's kernels
(paper Fig. 9).

`deploy_albert` bakes an ALBERT-EdgeBERT parameter tree into its on-chip form:
  * matmul weights -> AF8 codes (uint8 + per-tensor bias) — §V-C's 8-bit PU,
    executed by the `af_matmul` kernel (codes decoded exactly into bf16,
    float32 products from an exact split on the tensor cores);
  * learned spans -> integer registers; attention runs the `span_attention`
    kernel (dead heads gathered out, survivors windowed) — §V-D1;
  * LayerNorm -> the fused two-moment kernel — §V-D3;
  * off-ramp evaluation (pooler, classifier, softmax + entropy) -> one
    off-ramp head kernel on the AF8 weights — Alg. 1 + Eq. 4;
  * embeddings come back from the eNVM round-trip (bitmask in SLC, AF8 codes
    in MLC2) — §III-D.

`DeployedAlbert.classify` then runs sentences layer by layer with entropy
early exit, every hot op on a kernel; `classify_with_dvfs` replays the
per-sentence DVFS controller (Alg. 1) over the recorded entropy traces.
This is the port of the JAX package's ``serving/deploy.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import envm
from repro_torch.core.adaptive_span import hard_spans
from repro_torch.core.adaptivfloat import AFFormat, af_encode
from repro_torch.kernels import ops


@dataclass
class AFWeight:
    codes: torch.Tensor            # uint8 [in, out], on the model's device
    e_min: int                     # per-tensor exponent bias (host int)
    fmt: AFFormat


def _host_f32(t: Any) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def _encode_w(w: Any, fmt: AFFormat, device: torch.device) -> AFWeight:
    # encoded on the host, where the float ops are those the parity tests
    # hold bit-exact against the JAX package; only the codes go to the device
    codes, e_min = af_encode(_host_f32(w), fmt)
    return AFWeight(codes=codes.to(device), e_min=int(e_min), fmt=fmt)


def _mm(x: torch.Tensor, w: AFWeight) -> torch.Tensor:
    """AF8 matmul kernel over flattened leading dims."""
    lead = x.shape[:-1]
    y = ops.af_matmul_op(x.reshape(-1, x.shape[-1]).float().contiguous(), w.codes, w.e_min,
                         w.fmt.n_bits, w.fmt.n_exp)
    return y.reshape(*lead, y.shape[-1])


@dataclass
class DeployedAlbert:
    cfg: ModelConfig
    device: torch.device
    embed_tok: torch.Tensor          # eNVM-readback embeddings [V, E]
    embed_proj: Optional[AFWeight]
    embed_pos: Optional[torch.Tensor]
    layer: Dict[str, Any]            # AF-encoded shared encoder layer
    offramp: Dict[str, Any]
    spans: np.ndarray                # integer spans (registers)
    threshold: float
    # off-ramp entropy traces of the most recent classify() batch, one list
    # per sentence — replayed by the DVFS controller (Alg. 1)
    last_entropy_traces: List[List[float]] = field(default_factory=list)

    # ------------------------------------------------------------- layers --
    def _encoder_layer(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        lp = self.layer
        B, S, d = h.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = _mm(h, lp["wq"]).reshape(B, S, H, hd)
        k = _mm(h, lp["wk"]).reshape(B, S, KV, hd)
        v = _mm(h, lp["wv"]).reshape(B, S, KV, hd)
        attn = ops.span_attention_op(q, k, v, self.spans, causal=False)
        attn = _mm(attn.reshape(B, S, H * hd), lp["wo"])
        h = ops.layernorm_op(h + attn, lp["norm1_scale"], lp["norm1_bias"])
        up = _mm(h, lp["w_up"])
        act = F.gelu(up, approximate="tanh")          # jax.nn.gelu's default form
        mo = _mm(act, lp["w_down"])
        return ops.layernorm_op(h + mo, lp["norm2_scale"], lp["norm2_bias"])

    # -------------------------------------------------------------- public --
    def classify(self, tokens: Any) -> Tuple[np.ndarray, np.ndarray]:
        """Early-exit classification. tokens [B, S] -> (logits [B, C], exit [B]).

        Layer-by-layer host loop (the accelerator's serial schedule): lanes
        that clear the entropy threshold stop computing.  Each sentence's
        off-ramp entropy trace is kept in ``self.last_entropy_traces``.
        """
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        h = self.embed_tok[tokens]
        if self.embed_proj is not None:
            h = _mm(h, self.embed_proj)
        if self.embed_pos is not None:
            h = h + self.embed_pos[None, : tokens.shape[1]]
        h = h.float().contiguous()
        B = tokens.shape[0]
        done = np.zeros(B, bool)
        out_logits = np.zeros((B, cfg.edgebert.early_exit.num_classes), np.float32)
        exit_layer = np.full(B, cfg.n_layers, np.int32)
        self.last_entropy_traces = [[] for _ in range(B)]
        for li in range(cfg.n_layers):
            active = np.nonzero(~done)[0]
            if len(active) == 0:
                break
            idx = torch.as_tensor(active, device=self.device)
            h_act = self._encoder_layer(h.index_select(0, idx))
            # the JAX package copies h through the host every layer; here the
            # active rows are written in place on the device (same result:
            # exited rows keep the state they exited with)
            h.index_copy_(0, idx, h_act)
            # the off-ramp (pooler, classifier, softmax/entropy: the GB
            # unit) in one kernel on the AF8 weights, and one copy back per
            # layer of its packed [B, C + 2] rows
            packed = ops.offramp_head_op(h_act, self.offramp).cpu().numpy()
            C = packed.shape[1] - 2
            lg, ent = packed[:, :C], packed[:, C]
            for j, i in enumerate(active):
                self.last_entropy_traces[i].append(float(ent[j]))
                if ent[j] < self.threshold or li == cfg.n_layers - 1:
                    done[i] = True
                    out_logits[i] = lg[j]
                    exit_layer[i] = li + 1
        return out_logits, exit_layer

    def classify_with_dvfs(self, tokens: Any, controller, arbiter=None, deadlines_s=None):
        """Kernel-path classification + DVFS schedule.

        Returns (logits [B, C], exit_layer [B], reports).  Without
        ``arbiter``: one ``DVFSReport`` per sentence from replaying Alg. 1
        over its entropy trace (the single-stream analysis).  With a
        ``BatchedDVFSArbiter``: the batch shares one LDO/ADPLL, so the
        lock-step batch is arbitrated layer step by layer step (one (V, f)
        per step, switching stalls charged) and per-sentence
        ``LaneDVFSReport``s come back instead.  ``deadlines_s`` (length B,
        entries optional) gives each sentence its own latency budget;
        ``None`` entries use the controller target.
        """
        if arbiter is not None and arbiter.c is not controller:
            raise ValueError("the arbiter was built over another controller than the one passed")
        logits, exit_layer = self.classify(tokens)
        if deadlines_s is not None and len(deadlines_s) != len(exit_layer):
            raise ValueError("deadlines_s must have one entry per sentence")
        if arbiter is not None:
            reports = arbiter.replay_batch(
                self.last_entropy_traces, exit_layer, deadlines_s=deadlines_s
            )
            return logits, exit_layer, reports
        reports = [
            controller.sentence_report(
                trace,
                exit_layer=int(el),
                target_latency_s=None if deadlines_s is None else deadlines_s[i],
            )
            for i, (trace, el) in enumerate(zip(self.last_entropy_traces, exit_layer))
        ]
        return logits, exit_layer, reports


def deploy_albert(
    params: Dict[str, Any],
    cfg: ModelConfig,
    *,
    envm_cell: str = "MLC2",
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> DeployedAlbert:
    """Bake ``params`` (a tree of tensors or arrays, keyed as the JAX
    package's ``Model.init_params``) into the deployed model on ``device``.

    Weights and the embedding table are stored in the AdaptivFloat format of
    ``cfg.edgebert.quant`` (AF(8, 3) in the ALBERT configs, the format the
    JAX package's deploy fixes)."""
    if cfg.family != "albert" or not cfg.shared_layers:
        raise ValueError("deploy_albert needs an albert config with shared layers")
    dev = resolve_device(device)
    fmt = AFFormat(cfg.edgebert.quant.n_bits, cfg.edgebert.quant.n_exp)

    def dense(t):
        return torch.as_tensor(t).detach().to(dev, torch.float32)

    lp = params["layer"]
    enc = {
        "wq": _encode_w(lp["attn"]["wq"], fmt, dev),
        "wk": _encode_w(lp["attn"]["wk"], fmt, dev),
        "wv": _encode_w(lp["attn"]["wv"], fmt, dev),
        "wo": _encode_w(lp["attn"]["wo"], fmt, dev),
        "w_up": _encode_w(lp["mlp"]["w_up"], fmt, dev),
        "w_down": _encode_w(lp["mlp"]["w_down"], fmt, dev),
        # LN params stay dense fp32 (the paper keeps them unquantized)
        "norm1_scale": dense(lp["norm1"]["scale"]),
        "norm1_bias": dense(lp["norm1"]["norm_bias"]),
        "norm2_scale": dense(lp["norm2"]["scale"]),
        "norm2_bias": dense(lp["norm2"]["norm_bias"]),
    }
    o = params["offramp"]
    offramp = {
        "pooler_w": _encode_w(o["offramp_pooler_w"], fmt, dev),
        "pooler_b": dense(o["offramp_pooler_b"]),
        "cls_w": _encode_w(o["offramp_cls_w"], fmt, dev),
        "cls_b": dense(o["offramp_cls_b"]),
    }
    # embeddings through the eNVM round-trip (SLC bitmask + MLC data cells)
    emb_rb, _ = envm.store_and_readback(
        _host_f32(params["embed"]["tok"]).numpy(), data_cell=envm_cell, fmt=fmt, seed=seed,
    )
    spans = (
        hard_spans(_host_f32(params["span_z"]).numpy()[0])
        if "span_z" in params
        else np.full(cfg.n_heads, cfg.edgebert.span.max_span, np.int32)
    )
    return DeployedAlbert(
        cfg=cfg,
        device=dev,
        embed_tok=torch.from_numpy(emb_rb).to(dev),
        embed_proj=_encode_w(params["embed"]["proj"], fmt, dev) if "proj" in params["embed"] else None,
        embed_pos=dense(params["embed"]["pos"]) if "pos" in params["embed"] else None,
        layer=enc,
        offramp=offramp,
        spans=spans,
        threshold=cfg.edgebert.early_exit.entropy_threshold,
    )
