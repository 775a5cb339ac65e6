"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.

Pruned Nemotron-4; squared-ReLU MLP per Nemotron family. [arXiv:2407.14679; hf]

A copy of the JAX package's ``configs/minitron_8b.py``.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    act="relu2",
    norm="layernorm",
    pos="rope",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        name="minitron-8b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab_size=512,
        max_seq_len=256,
    )
