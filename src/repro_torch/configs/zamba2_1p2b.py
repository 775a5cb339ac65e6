"""zamba2-1.2b [hybrid] — 38 Mamba2 blocks d_model=2048 + one shared attention
block (32H on concat([h, x0]) of width 2*d_model) invoked every 6 Mamba blocks,
d_ff=8192 (shared block MLP), vocab=32000, ssm_state=64. [arXiv:2411.15242; hf]

Runs long_500k (sub-quadratic: Mamba2 state recurrence; shared attention during
decode is O(window) against the KV cache).

A copy of the JAX package's ``configs/zamba2_1p2b.py``.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,             # mamba2 blocks
    d_model=2048,
    n_heads=32,              # shared attention block heads (on 2*d_model)
    n_kv_heads=32,
    head_dim=128,            # 2*2048/32 = 128
    d_ff=8192,
    vocab_size=32000,
    act="gelu",
    norm="rms",
    pos="rope",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_chunk=128,
    attn_every=6,
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        name="zamba2-1.2b-smoke",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,          # 2*64/4
        d_ff=128,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=32,
        attn_every=2,
        max_seq_len=256,
    )
