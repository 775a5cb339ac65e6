"""deepseek-7b [dense] — 30L d_model=4096 32H (GQA kv=32 = MHA) d_ff=11008 vocab=102400.

LLaMA-style architecture. [arXiv:2401.02954; hf]  A copy of the JAX package's
``configs/deepseek_7b.py``.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=102400,
    act="swiglu",
    norm="rms",
    pos="rope",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        name="deepseek-7b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=8,
        head_dim=8,
        d_ff=96,
        vocab_size=512,
        max_seq_len=256,
    )
