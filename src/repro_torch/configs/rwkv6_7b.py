"""rwkv6-7b (Finch) [ssm] — 32L d_model=4096 (attention-free) d_ff=14336
vocab=65536 — data-dependent decay time-mix. [arXiv:2404.05892; hf]

Adaptive attention span is INAPPLICABLE (no attention heads; the learned
data-dependent decay w_t is RWKV6's native analogue of a span) — see
DESIGN.md §Arch-applicability.  Runs long_500k (linear in sequence length).

A copy of the JAX package's ``configs/rwkv6_7b.py``.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,              # wkv heads = d_model / head_size(64)
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    act="relu2",             # rwkv channel-mix uses squared relu
    norm="layernorm",
    pos="none",
    ssm_state=64,            # per-head state is head_dim x head_dim
    ssm_head_dim=64,
)


def smoke_config() -> ModelConfig:
    return replace(
        CONFIG,
        name="rwkv6-7b-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        ssm_state=16,
        ssm_head_dim=16,
        max_seq_len=256,
    )
