"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.

[arXiv:2403.17297; hf]

A copy of the JAX package's ``configs/internlm2_20b.py``.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    act="swiglu",
    norm="rms",
    pos="rope",
    rope_theta=1000000.0,
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        name="internlm2-20b-smoke",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=512,
        max_seq_len=256,
    )
