"""ALBERT-base-v2 — the paper's baseline model (Fig. 2b).

12 encoder layers sharing ONE set of parameters (cross-layer sharing), embedding
factorized to 128, d_model=768, 12 heads, d_ff=3072, vocab=30000, max seq 128
(GLUE fine-tuning length used throughout the paper).
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="albert-base-v2",
    family="albert",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=30000,
    embed_dim=128,            # factorized embedding (ALBERT)
    shared_layers=True,       # cross-layer parameter sharing
    act="gelu",
    norm="layernorm",
    pos="learned",
    max_seq_len=512,
    num_classes=3,            # MNLI-style
    tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        name="albert-smoke",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        embed_dim=32,
        max_seq_len=128,
    )
