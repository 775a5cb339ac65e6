from repro_torch.configs.base import (
    EarlyExitConfig,
    EdgeBertConfig,
    ModelConfig,
    PruneConfig,
    QuantConfig,
    SpanConfig,
    get_config,
    get_smoke_config,
)
