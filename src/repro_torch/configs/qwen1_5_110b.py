"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.

QKV bias per Qwen1.5 family. [hf:Qwen/Qwen1.5-0.5B; hf]

A copy of the JAX package's ``configs/qwen1_5_110b.py``.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=49152,
    vocab_size=152064,
    act="swiglu",
    norm="rms",
    pos="rope",
    rope_theta=1000000.0,
    qkv_bias=True,
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        name="qwen1.5-110b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab_size=512,
        max_seq_len=256,
    )
