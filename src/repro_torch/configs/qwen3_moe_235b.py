"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) expert d_ff=1536
vocab=151936, MoE 128 experts top-8, no shared expert. [hf:Qwen/Qwen3-30B-A3B; hf]
A copy of the JAX package's ``configs/qwen3_moe_235b.py``.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,               # = moe_d_ff (per-expert)
    moe_d_ff=1536,
    n_experts=128,
    top_k=8,
    vocab_size=151936,
    act="swiglu",
    norm="rms",
    pos="rope",
    rope_theta=1000000.0,
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        name="qwen3-moe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=64,
        moe_d_ff=64,
        n_experts=8,
        top_k=2,
        vocab_size=512,
        max_seq_len=256,
    )
