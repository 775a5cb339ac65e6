"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) expert d_ff=1408
vocab=151936, 60 routed experts top-4 + shared expert (4x1408=5632).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]  A copy of the JAX package's
``configs/qwen2_moe_a2p7b.py``.

Sharding note: 60 experts do not divide the 16-way model axis -> this arch
overrides expert-parallel with expert-TP (moe_d_ff 1408 = 16*88).
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    moe_d_ff=1408,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    shared_expert_d_ff=5632,
    vocab_size=151936,
    act="swiglu",
    norm="rms",
    pos="rope",
    qkv_bias=True,
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        name="qwen2-moe-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=64,
        moe_d_ff=64,
        n_experts=6,
        top_k=2,
        n_shared_experts=1,
        shared_expert_d_ff=128,
        vocab_size=512,
        max_seq_len=256,
    )
