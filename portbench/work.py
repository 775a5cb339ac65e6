"""Operations and bytes the work needs, counted from the configuration's
shapes and the requests' sizes, never from what an implementation
launches.  Bytes are float32 (4 each): each input read once, each output
written once.  Pruned weights count only their nonzero tiles
(``density``)."""
from __future__ import annotations

from typing import Dict, Iterable

F32 = 4


# ---------------------------------------------------------------- classifier
def albert_sentence_flops(m: Dict, n: int, depth: int, density: float) -> float:
    """One sentence of ``n`` real tokens through ``depth`` layers of the
    shared encoder layer, with the factorized embedding's projection and
    the off-ramp (pooler and classifier on the CLS row) after each layer."""
    d, ff, E, C = m["d_model"], m["d_ff"], m["embed_dim"], m["num_classes"]
    embed = 2.0 * n * E * d
    proj = 2.0 * n * 4 * d * d                   # q, k, v, o
    attn = 2.0 * 2.0 * n * n * d                 # scores and the weighted sum
    mlp = 2.0 * 2.0 * n * d * ff * density       # w_up and w_down, nonzero tiles
    offramp = 2.0 * d * d + 2.0 * d * C
    return embed + depth * (proj + attn + mlp + offramp)


def albert_step_kernel_work(m: Dict, S: int, lanes_kv: Iterable[int], density: float) -> Dict[str, tuple]:
    """(operations, bytes) per port kernel for one fused step of a bucket
    of ``S`` positions over lanes whose valid lengths are ``lanes_kv``:
    two LayerNorms, the grouped AdaptivFloat quantize, the attention
    kernel (queries at every position, keys below each lane's length), the
    two block-sparse MLP products and the off-ramp head.  Keyed by the
    kernel family's name, each value summed over its calls in the step."""
    kv = list(lanes_kv)
    B = len(kv)
    d, ff, H, dh, C = m["d_model"], m["d_ff"], m["n_heads"], m["head_dim"], m["num_classes"]
    M = B * S
    act = M * d * F32
    ln = (2 * 8.0 * M * d, 2 * (2 * act + 2 * d * F32))
    quant = (4.0 * M * d, 2 * act + B * F32)
    attn_flops = sum(4.0 * S * k * H * dh for k in kv)
    attn_bytes = sum((2 * S + 2 * k) * H * dh * F32 for k in kv)
    w = density * d * ff * F32
    bs = (2 * 2.0 * M * d * ff * density, 2 * (M * (d + ff) * F32 + w))
    head = (2.0 * B * d * d + 2.0 * B * d * C + 6.0 * B * C,
            B * d * F32 + (d * d + d + d * C + C) * F32 + B * (C + 2) * F32)
    return {"layernorm": ln, "af_quantize": quant, "span_attention": (attn_flops, attn_bytes),
            "block_sparse_matmul": bs, "softmax_entropy": head}


# ------------------------------------------------------------------- decoder
def dense_layer_weights(m: Dict) -> float:
    """Parameters of one pre-LN SwiGLU layer (attention and MLP)."""
    d, ff, H, KV, dh = m["d_model"], m["d_ff"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return d * H * dh + 2 * d * KV * dh + H * dh * d + 3 * d * ff


def dense_token_flops(m: Dict, ctx: int, lm_head_layers: int) -> float:
    """One token at context ``ctx`` (positions it attends to) through every
    layer, with the LM head evaluated after ``lm_head_layers`` of them."""
    L, d, V = m["n_layers"], m["d_model"], m["vocab_size"]
    H, dh = m["n_heads"], m["head_dim"]
    return L * (2.0 * dense_layer_weights(m) + 4.0 * ctx * H * dh) + lm_head_layers * 2.0 * d * V


def dense_step_bytes(m: Dict, contexts: Iterable[int], lm_head_layers: int) -> float:
    """Bytes one fused decode step needs: every layer's weights once, the LM
    head and final norm once for each layer after which some lane still
    needed its off-ramp, each lane's keys and values up to its position
    read and its new row written, and the token embeddings."""
    L, d, V = m["n_layers"], m["d_model"], m["vocab_size"]
    KV, dh = m["n_kv_heads"], m["head_dim"]
    ctx = list(contexts)
    weights = L * (dense_layer_weights(m) + 2 * d) * F32
    head = lm_head_layers * (d * V + d) * F32
    kv = sum(L * 2 * (c + 1) * KV * dh * F32 for c in ctx)
    return weights + head + kv + len(ctx) * d * F32
