"""whisper-medium [audio] — enc-dec, 24L each, d_model=1024 16H (kv=16) d_ff=4096
vocab=51865. Conv frontend is a STUB: ``input_specs()`` supplies precomputed
(B, 1500, d_model) frame embeddings (30 s x 50 Hz).  [arXiv:2212.04356; unverified]

Shape-sheet seq_len applies to the DECODER; encoder frames fixed at 1500.

A copy of the JAX package's ``configs/whisper_medium.py``.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,          # decoder layers
    n_enc_layers=24,
    enc_seq_len=1500,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    act="gelu",
    norm="layernorm",
    pos="learned",
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        name="whisper-medium-smoke",
        n_layers=2,
        n_enc_layers=2,
        enc_seq_len=32,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        max_seq_len=256,
    )
