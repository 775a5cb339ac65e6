"""ModernBERT-large's early-exit classifier, plain PyTorch float32
(Warner et al., arXiv:2412.13663; the layer equations of ``transformers``'
``modeling_modernbert.py``), with EdgeBERT's features (arXiv:2011.14203),
as it is served.

A document is padded with token 0 to its length bucket.  The embedding is
the token table and a LayerNorm (no position table).  Each of the unshared
layers is pre-LN: h + attention(attn_norm(h)), then h + GeGLU(mlp_norm(h)),
where layer 0's attn_norm is the identity.  Attention is bidirectional with
rotary positions (rotate-half form) over the document's own tokens (keys
past its length masked): layer i attends to every key when i %
``global_every`` == 0 (RoPE theta ``rope_theta``), else to the keys j with
|i - j| <= ``local_window`` // 2 (theta ``local_rope_theta``).  A padded
position with no visible key attends to nothing and gets zero.  The GeGLU
MLP is Wo(gelu(first half of Wi x) * second half), GELU in its exact erf
form.  LayerNorms carry a scale and no bias; no linear layer has a bias
but the classifier.  Attention is computed in blocks of queries (each over
the keys the block can see), so that 8192 positions fit.

Departures from the published model, each EdgeBERT's:

* an off-ramp after every layer, in ModernBERT's head form on the CLS row
  (token 0, ``classifier_pooling="cls"``): its own LayerNorm, ``dense``,
  GELU, ``head_norm``, the classifier; the last layer's is the published
  final norm, head and classifier.  The document exits at the first layer
  whose off-ramp entropy is below the threshold (at the last otherwise), as
  DeeBERT gives each unshared layer a ramp;
* the MLP's weights pruned (the pruned tiles are zeros in the weights);
* AdaptivFloat quantization of each layer's output with one bias over the
  document's whole padded [bucket, d] slab (padded positions included, as
  the served step quantizes each lane's slab)."""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from portbench.reference import af


def layernorm(x: torch.Tensor, p: Dict, eps: float) -> torch.Tensor:
    return torch.nn.functional.layer_norm(x, x.shape[-1:], p["scale"], None, eps)


def entropy(logits: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (nats) of softmax(logits) over the last axis."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def take(node, i: int):
    """Layer ``i`` of a tree stacked on a leading [n_layers] axis."""
    return {k: take(v, i) for k, v in node.items()} if isinstance(node, dict) else node[i]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0 .. S-1 on x [B, H, S, dh], rotate-half form."""
    S, dh = x.shape[2], x.shape[3]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
              half: Optional[int], block: int = 256) -> torch.Tensor:
    """[B, H, S, dh] queries against keys below each row's length, within
    ``half`` positions of the query where given, in blocks of ``block``
    queries (each against the keys the block can see); a query with no
    visible key gets zeros.  The scale goes onto the queries once (1/8 at
    dh 64, exact) and the masked scores get -inf added in place: a block of
    8192 keys is read and written as few times as the softmax needs."""
    B, H, S, dh = q.shape
    out = torch.empty_like(q)
    q = q * (1.0 / math.sqrt(dh))
    for a in range(0, S, block):
        b = min(a + block, S)
        k0, k1 = (0, S) if half is None else (max(0, a - half), min(S, b + half))
        kj = torch.arange(k0, k1, device=q.device)
        ok = (kj[None, :] < lengths[:, None])[:, None, :]                        # [B, 1, keys]
        if half is not None:
            qi = torch.arange(a, b, device=q.device)
            ok = ok & ((qi[:, None] - kj[None, :]).abs() <= half)[None]         # [B, queries, keys]
        mask = torch.zeros(ok.shape, device=q.device).masked_fill_(~ok, float("-inf"))[:, None]
        s = (q[:, :, a:b] @ k[:, :, k0:k1].transpose(-1, -2)).add_(mask)
        p = torch.softmax(s, dim=-1)
        if half is not None:
            p = torch.where(ok.any(dim=-1, keepdim=True)[:, None], p, 0.0)
        out[:, :, a:b] = p @ v[:, :, k0:k1]
    return out


def is_global(i: int, m: Dict) -> bool:
    return i % m["global_every"] == 0


def layer_pre(params: Dict, i: int, h: torch.Tensor, lengths: torch.Tensor, m: Dict,
              glob: Optional[bool] = None) -> torch.Tensor:
    """Encoder layer ``i`` on [B, S, d] before its AdaptivFloat quantization
    (``glob`` overrides the layer's kind of attention)."""
    B, S, d = h.shape
    H, dh, eps = m["n_heads"], m["head_dim"], m["norm_eps"]
    lp = take(params["layers"], i)
    glob = is_global(i, m) if glob is None else glob
    x = h if i == 0 else layernorm(h, lp["attn_norm"], eps)
    a = lp["attn"]
    q, k, v = ((x @ a[w]).reshape(B, S, H, dh).transpose(1, 2) for w in ("wq", "wk", "wv"))
    theta = m["rope_theta"] if glob else m["local_rope_theta"]
    o = attention(rope(q, theta), rope(k, theta), v, lengths, None if glob else m["local_window"] // 2)
    h = h + o.transpose(1, 2).reshape(B, S, H * dh) @ a["wo"]
    x = layernorm(h, lp["mlp_norm"], eps)
    u, g = (x @ lp["mlp"]["w_up"]).chunk(2, dim=-1)
    return h + (torch.nn.functional.gelu(u) * g) @ lp["mlp"]["w_down"]


def quantize_slab(h: torch.Tensor, m: Dict) -> torch.Tensor:
    """AdaptivFloat on [B, S, d], one bias per document's padded slab."""
    q8 = m["quant"]
    if not q8:
        return h
    return af.quantize(h, q8["n_bits"], q8["n_exp"], h.abs().amax(dim=(1, 2), keepdim=True))


def embed(params: Dict, tokens: torch.Tensor, m: Dict) -> torch.Tensor:
    e = params["embed"]
    return layernorm(e["tok"][tokens.long()], e["norm"], m["norm_eps"])


def offramp(params: Dict, i: int, cls: torch.Tensor, m: Dict) -> torch.Tensor:
    """Off-ramp ``i`` on CLS rows [B, d] -> logits [B, C]."""
    o, eps = take(params["offramps"], i), m["norm_eps"]
    x = torch.nn.functional.gelu(layernorm(cls, o["norm"], eps) @ o["dense"])
    return layernorm(x, o["head_norm"], eps) @ o["cls_w"] + o["cls_b"]


def traces(params: Dict, tokens: torch.Tensor, lengths: torch.Tensor, m: Dict,
           layers: Optional[Sequence[int]] = None, global_layers: Sequence[int] = (),
           local_layers: Sequence[int] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded documents ``tokens`` [B, S] of ``lengths`` [B] through the
    layers ``layers`` (default: every layer in order; a step runs that
    layer's weights and off-ramp) -> (off-ramp logits [L, B, C], entropies
    [L, B]).  The layers in ``global_layers`` attend globally and those in
    ``local_layers`` in the local window, whatever their kind (faults the
    check's tests plant)."""
    h = embed(params, tokens, m)
    logits, ents = [], []
    for i in (range(m["n_layers"]) if layers is None else layers):
        glob = True if i in global_layers else False if i in local_layers else None
        h = quantize_slab(layer_pre(params, i, h, lengths, m, glob), m)
        lg = offramp(params, i, h[:, 0], m)
        logits.append(lg)
        ents.append(entropy(lg))
    return torch.stack(logits), torch.stack(ents)


def first_entropies(params: Dict, tokens: torch.Tensor, lengths: torch.Tensor, m: Dict,
                    tol: float, max_ties: int = 10) -> list:
    """Every off-ramp entropy after layer 1 that the layer's float32 output,
    moved by at most ``tol``, can give: a CLS element within ``tol`` of an
    AdaptivFloat rounding boundary may land on either neighbour, and an
    amax within ``tol`` (relative) of a binade edge may take either bias.
    Per document, a tensor of candidates (one when nothing is that close;
    the ``max_ties`` closest ties are enumerated)."""
    q8 = m["quant"]
    pre = layer_pre(params, 0, embed(params, tokens, m), lengths, m)
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
        out.append(entropy(offramp(params, 0, torch.cat(rows), m)))
    return out


def exit_layers(ents: torch.Tensor, threshold: float) -> torch.Tensor:
    """[L, B] entropies -> 1-based exit layer per document."""
    below = ents < threshold
    below[-1] = True
    return below.int().argmax(dim=0) + 1
