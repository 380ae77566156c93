"""Distribution substrate: logical-axis sharding rules (DP / TP / SP) on
``torch.distributed``."""
from .sharding import (
    DECODE_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    ShardingRules,
    active_mesh,
    constrain,
    logical_to_spec,
    named_sharding,
    tree_shardings,
    use_mesh,
)

__all__ = [
    "DECODE_RULES",
    "SERVE_RULES",
    "TRAIN_RULES",
    "ShardingRules",
    "active_mesh",
    "constrain",
    "logical_to_spec",
    "named_sharding",
    "tree_shardings",
    "use_mesh",
]
