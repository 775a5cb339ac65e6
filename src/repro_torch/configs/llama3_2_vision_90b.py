"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — 80 self-attn layers + 20 gated cross-attn layers (every 5th).
Vision frontend STUB: the caller supplies (B, 1601, d_model) patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

A copy of the JAX package's ``configs/llama3_2_vision_90b.py``.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,            # 80 self + 20 cross (cross_attn_every=5)
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    act="swiglu",
    norm="rms",
    pos="rope",
    rope_theta=500000.0,
    cross_attn_every=5,
    n_image_tokens=1601,
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        name="llama-3.2-vision-smoke",
        n_layers=4,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab_size=512,
        cross_attn_every=2,
        n_image_tokens=16,
        max_seq_len=256,
    )
