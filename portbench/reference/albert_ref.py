"""The EdgeBERT classifier, plain PyTorch float32 (ALBERT, arXiv:1909.11942,
with EdgeBERT's features, arXiv:2011.14203), as it is served.

A sentence is padded with token 0 to its length bucket.  The factorized
embedding (token table, projection to d, learned positions) feeds ONE
shared post-LN encoder layer run up to ``n_layers`` times: attention over
the sentence's own tokens (keys past its length masked), residual and
LayerNorm (variance as E[x^2] - E[x]^2), the GELU MLP (tanh form) whose
pruned tiles are zeros in the weights, residual and LayerNorm, then
AdaptivFloat quantization of the layer's output with one bias over the
sentence's whole padded [bucket, d] slab.  After every layer the off-ramp
reads the first (CLS) row: tanh pooler, classifier, and the softmax
entropy of its logits.  The sentence exits at the first layer whose entropy
is below the threshold (at the last layer otherwise)."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from portbench.reference import af


def layernorm(x, scale, bias, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x * x).mean(dim=-1, keepdim=True) - mean * mean
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (nats) of softmax(logits) over the last axis."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def layer_pre(p: Dict, h: torch.Tensor, lengths: torch.Tensor, m: Dict) -> torch.Tensor:
    """The shared encoder layer on [B, S, d] before its AdaptivFloat
    quantization."""
    B, S, d = h.shape
    H, dh = m["n_heads"], m["head_dim"]
    a = p["attn"]
    q = (h @ a["wq"]).reshape(B, S, H, dh).transpose(1, 2)
    k = (h @ a["wk"]).reshape(B, S, H, dh).transpose(1, 2)
    v = (h @ a["wv"]).reshape(B, S, H, dh).transpose(1, 2)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
    keep = torch.arange(S, device=h.device)[None, :] < lengths[:, None]            # [B, S] keys
    s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
    o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, S, H * dh) @ a["wo"]
    eps = m["norm_eps"]
    h = layernorm(h + o, p["norm1"]["scale"], p["norm1"]["norm_bias"], eps)
    f = torch.nn.functional.gelu(h @ p["mlp"]["w_up"], approximate="tanh") @ p["mlp"]["w_down"]
    return layernorm(h + f, p["norm2"]["scale"], p["norm2"]["norm_bias"], eps)


def quantize_slab(h: torch.Tensor, m: Dict) -> torch.Tensor:
    """AdaptivFloat on [B, S, d], one bias per sentence's padded slab."""
    q8 = m["quant"]
    if not q8:
        return h
    return af.quantize(h, q8["n_bits"], q8["n_exp"], h.abs().amax(dim=(1, 2), keepdim=True))


def layer(p: Dict, h: torch.Tensor, lengths: torch.Tensor, m: Dict) -> torch.Tensor:
    """The shared encoder layer on [B, S, d], its AdaptivFloat output."""
    return quantize_slab(layer_pre(p, h, lengths, m), m)


def embed(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    e = params["embed"]
    return e["tok"][tokens.long()] @ e["proj"] + e["pos"][: tokens.shape[1]]


def offramp(params: Dict, cls: torch.Tensor) -> torch.Tensor:
    o = params["offramp"]
    return torch.tanh(cls @ o["offramp_pooler_w"] + o["offramp_pooler_b"]) @ o["offramp_cls_w"] + o["offramp_cls_b"]


def first_entropies(params: Dict, tokens: torch.Tensor, lengths: torch.Tensor, m: Dict,
                    tol: float, max_ties: int = 10) -> list:
    """Every off-ramp entropy after layer 1 that the layer's float32 output,
    moved by at most ``tol``, can give: a CLS element within ``tol`` of an
    AdaptivFloat rounding boundary may land on either neighbour, and an
    amax within ``tol`` (relative) of a binade edge may take either bias.
    Per sentence, a tensor of candidates (one when nothing is that close;
    the ``max_ties`` closest ties are enumerated)."""
    q8 = m["quant"]
    pre = layer_pre(params["layer"], embed(params, tokens), lengths, m)
    amax = pre.abs().amax(dim=(1, 2))
    out = []
    for i in range(pre.shape[0]):
        x = pre[i, 0]
        rows = []
        for a in {float(amax[i] * (1 - tol)), float(amax[i]), float(amax[i] * (1 + tol))} if q8 else {0.0}:
            if not q8:
                rows.append(x[None])
                continue
            a = torch.tensor(a, device=x.device)
            lo = af.quantize(x - tol, q8["n_bits"], q8["n_exp"], a)
            hi = af.quantize(x + tol, q8["n_bits"], q8["n_exp"], a)
            base = af.quantize(x, q8["n_bits"], q8["n_exp"], a)
            ties = torch.nonzero(lo != hi).flatten()
            if len(ties) > max_ties:
                mid = (lo[ties] + hi[ties]) / 2
                ties = ties[(x[ties] - mid).abs().argsort()[:max_ties]]
            n = len(ties)
            pick = ((torch.arange(2 ** n, device=x.device)[:, None] >> torch.arange(n, device=x.device)) & 1).bool()
            var = base.expand(2 ** n, -1).clone()
            if n:
                var[:, ties] = torch.where(pick, hi[ties], lo[ties])
            rows.append(var)
        out.append(entropy(offramp(params, torch.cat(rows))))
    return out


def traces(params: Dict, tokens: torch.Tensor, lengths: torch.Tensor, m: Dict,
           n_layers: int = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded sentences ``tokens`` [B, S] of ``lengths`` [B] through the
    first ``n_layers`` layers -> (off-ramp logits [L, B, C], entropies
    [L, B])."""
    h = embed(params, tokens)
    logits, ents = [], []
    for _ in range(n_layers or m["n_layers"]):
        h = layer(params["layer"], h, lengths, m)
        lg = offramp(params, h[:, 0])
        logits.append(lg)
        ents.append(entropy(lg))
    return torch.stack(logits), torch.stack(ents)


def exit_layers(ents: torch.Tensor, threshold: float) -> torch.Tensor:
    """[L, B] entropies -> 1-based exit layer per sentence."""
    below = ents < threshold
    below[-1] = True
    return below.int().argmax(dim=0) + 1
