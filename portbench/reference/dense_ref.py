"""The dense pre-LN decoder with an LM-head off-ramp after every layer,
plain PyTorch float32 (deepseek-7b, arXiv:2401.02954: RMSNorm, rotary
positions, multi-head attention, SwiGLU, an untied LM head), with
per-token early exit as it is served.

A served request is the prompt followed by its generated tokens.  Every
position runs every layer.  A position fed to a fused decode step exits at
a layer; after it, its hidden state is frozen, and the later layers still
read that frozen state for its keys and values (the serving step's state
propagation).  Prompt positions before the last run at full depth.  After
each layer the off-ramp is the final RMSNorm, the LM head and the softmax
entropy of its logits.  ``forward`` computes the whole sequence at once
(causal attention) and hands each layer's off-ramp of the fed positions to
a callback."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from portbench.reference.albert_ref import entropy


def rmsnorm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions on [T, H, dh], the two halves of each head rotated
    as pairs (x_i, x_{i + dh/2})."""
    dh = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward(params: Dict, m: Dict, seq: torch.Tensor, frozen_after: torch.Tensor, fed_from: int,
            on_layer: Callable[[int, torch.Tensor, torch.Tensor], None]) -> None:
    """``seq`` [T] token ids; ``frozen_after`` [T] the layer after which each
    position's state is frozen (``n_layers``: never); the off-ramp of the
    positions ``fed_from`` .. T-1 goes to ``on_layer(layer (1-based),
    logits [G, V], entropies [G])`` after every layer."""
    T = seq.shape[0]
    L, H, dh, eps = m["n_layers"], m["n_heads"], m["head_dim"], m["norm_eps"]
    dev = seq.device
    pos = torch.arange(T, device=dev)
    causal = pos[None, :] <= pos[:, None]                                    # [q, k]
    lp = params["layers"]
    h = params["embed"]["tok"][seq.long()]
    for i in range(L):
        a = lp["attn"]
        x = rmsnorm(h, lp["norm1"]["scale"][i], eps)
        q = rope((x @ a["wq"][i]).reshape(T, H, dh), pos, m["rope_theta"]).transpose(0, 1)
        k = rope((x @ a["wk"][i]).reshape(T, H, dh), pos, m["rope_theta"]).transpose(0, 1)
        v = (x @ a["wv"][i]).reshape(T, H, dh).transpose(0, 1)
        s = (q @ k.transpose(-1, -2)) / dh ** 0.5
        s = s.masked_fill(~causal[None], float("-inf"))
        o = (torch.softmax(s, dim=-1) @ v).transpose(0, 1).reshape(T, H * dh) @ a["wo"][i]
        h2 = h + o
        x = rmsnorm(h2, lp["norm2"]["scale"][i], eps)
        f = lp["mlp"]
        h_new = h2 + (torch.nn.functional.silu(x @ f["w_gate"][i]) * (x @ f["w_up"][i])) @ f["w_down"][i]
        h = torch.where((frozen_after <= i)[:, None], h, h_new)
        lg = rmsnorm(h[fed_from:], params["final_norm"]["scale"], eps) @ params["lm_head"]
        on_layer(i + 1, lg, entropy(lg))
        del lg
