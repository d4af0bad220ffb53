from repro_torch.sharding.partition import (
    AxisAssignment,
    ModuleAssignment,
    PartitionSpec,
    sanitize_spec,
    param_specs,
    expert_shards,
    opt_state_specs,
    named,
    to_placements,
    activation_spec,
    tokens_spec,
)

__all__ = [
    "AxisAssignment",
    "ModuleAssignment",
    "PartitionSpec",
    "sanitize_spec",
    "param_specs",
    "expert_shards",
    "opt_state_specs",
    "named",
    "to_placements",
    "activation_spec",
    "tokens_spec",
]
