"""Sharding tier: parameter specs and the logical-axis rules that place them
on a mesh (``rules.py``), the collectives of the multi-device tier on any
backend (``collectives.py``), and the sharded SpMV/SpMM executor
(``ShardedPlannedMatrix``: ``dispatch`` in one process, ``shard_map`` a
rank a shard of a ``torch.distributed`` world)."""
from .rules import (RULES_1POD, RULES_2POD, RULES_SERVE, RULES_ZERO1,
                    NamedSharding, ParamSpec, ShardingRules, active_rules,
                    init_params, logical_to_sharding, param_count,
                    rules_for_mesh, stack_spec, use_rules,
                    with_logical_constraint)
from .spmv import ShardedPlannedMatrix, build_sharded, shard_csr

__all__ = ["ParamSpec", "init_params", "param_count", "stack_spec",
           "NamedSharding", "ShardingRules", "RULES_1POD", "RULES_2POD",
           "RULES_SERVE", "RULES_ZERO1", "rules_for_mesh",
           "logical_to_sharding", "use_rules", "active_rules",
           "with_logical_constraint", "ShardedPlannedMatrix",
           "build_sharded", "shard_csr"]
