from repro_torch.sharding.rules import (
    Sharding,
    ShardingRules,
    batch_shardings,
    cache_shardings,
    distribute,
    logical_to_mesh,
    param_shardings,
)
