"""ALBERT + full EdgeBERT optimization stack (the paper's deployed configuration).

Matches Table IV's MNLI row by default: 50% encoder MaP, 60% embedding MaP,
adaptive span (max 128), early exit T_E=0.4, AdaptivFloat 8-bit (3-bit exp),
embeddings resident in MLC2 eNVM.
"""
from dataclasses import replace

from repro_torch.configs.albert_base import CONFIG as ALBERT
from repro_torch.configs.base import (
    EarlyExitConfig,
    EdgeBertConfig,
    PruneConfig,
    QuantConfig,
    SpanConfig,
)

CONFIG = replace(
    ALBERT,
    name="albert-edgebert",
    edgebert=EdgeBertConfig(
        quant=QuantConfig(enabled=True, n_bits=8, n_exp=3),
        span=SpanConfig(enabled=True, max_span=128, ramp=32, loss_coef=2e-3),
        early_exit=EarlyExitConfig(enabled=True, entropy_threshold=0.4, num_classes=3),
        prune=PruneConfig(
            enabled=True,
            method="magnitude",
            encoder_sparsity=0.5,
            embedding_sparsity=0.6,
        ),
        distill_alpha=0.5,
        envm_embeddings=True,
    ),
)


def smoke_config():
    from repro_torch.configs.albert_base import smoke_config as albert_smoke

    return replace(albert_smoke(), name="albert-edgebert-smoke", edgebert=CONFIG.edgebert)
