"""``repro_torch.parallel`` — distributed execution on ``torch.distributed``
(port of ``repro.parallel``): the sharding policy and spec tables
(:mod:`.sharding`), the sharded planned SpMM and its gradients
(:mod:`.spmm`), and a pool of CPU ranks on one host for rehearsing them
(:mod:`.rehearsal`)."""
from repro_torch.parallel.sharding import (
    LOGICAL_RULES,
    ShardingPolicy,
    batch_pspecs,
    cache_pspecs,
    constrain,
    gather_shard,
    local_shard,
    logits_pspec,
    param_pspecs,
)

__all__ = [
    "LOGICAL_RULES",
    "ShardingPolicy",
    "batch_pspecs",
    "cache_pspecs",
    "constrain",
    "gather_shard",
    "local_shard",
    "logits_pspec",
    "param_pspecs",
]
