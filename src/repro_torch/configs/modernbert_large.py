"""ModernBERT-large (Warner et al., arXiv:2412.13663;
huggingface.co/answerdotai/ModernBERT-large ``config.json``) under
EdgeBERT's deployed stack: entropy early exit with an off-ramp after every
layer, the MLP pruned to 0.5 in 32 x 32 tiles, AdaptivFloat(8, 3)
activations at each layer's end.

28 unshared pre-LN layers, hidden 1024, 16 heads of 64, a GeGLU MLP of
2 x 2624 (``Wi``) and 2624 -> 1024 (``Wo``), LayerNorms without bias (eps
1e-5), no linear biases, no position embedding.  Layer i attends globally
(RoPE theta 160000) when i % 3 == 0, locally otherwise (keys within 64
positions, RoPE theta 10000).  Vocabulary 50368, context 8192.  A
configuration of the port alone: the JAX package has no encoder family.
"""
from dataclasses import replace

from repro_torch.configs.base import (
    EarlyExitConfig,
    EdgeBertConfig,
    ModelConfig,
    PruneConfig,
    QuantConfig,
)

CONFIG = ModelConfig(
    name="modernbert-large",
    family="encoder",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=2624,
    vocab_size=50368,
    act="geglu",
    norm="layernorm",
    pos="rope",
    rope_theta=160000.0,
    local_rope_theta=10000.0,
    global_every=3,
    local_window=128,
    norm_eps=1e-5,
    tie_embeddings=True,       # the classifier has no LM head; the published MLM head is tied
    dtype="float32",
    max_seq_len=8192,
    num_classes=3,
    remat_policy="none",
    edgebert=EdgeBertConfig(
        quant=QuantConfig(enabled=True, n_bits=8, n_exp=3),
        early_exit=EarlyExitConfig(enabled=True, entropy_threshold=0.4, num_classes=3),
        prune=PruneConfig(enabled=True, method="magnitude", encoder_sparsity=0.5, block_size=32),
    ),
)


def smoke_config():
    return replace(CONFIG, name="modernbert-smoke", n_layers=6, d_model=64, n_heads=4, n_kv_heads=4,
                   head_dim=16, d_ff=96, vocab_size=512, local_window=8, max_seq_len=64)
