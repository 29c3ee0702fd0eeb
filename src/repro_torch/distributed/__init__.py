from repro_torch.distributed.sharding import (
    logical_rules,
    resolve_axes_tree,
    resolve_spec,
    batch_spec,
    constrain,
)

__all__ = [
    "logical_rules", "resolve_axes_tree", "resolve_spec", "batch_spec",
    "constrain",
]
