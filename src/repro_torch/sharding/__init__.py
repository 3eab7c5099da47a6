"""Sharding tier: parameter specs (the one-device subset of the JAX
package's ``sharding/rules.py``; its meshes and ``ShardingRules`` come with
ROADMAP.md item A16c) and the sharded SpMV/SpMM executor
(``ShardedPlannedMatrix``; the multi-device ``shard_map`` mode is item
A15b)."""
from .rules import ParamSpec, init_params, param_count, stack_spec
from .spmv import ShardedPlannedMatrix, build_sharded, shard_csr

__all__ = ["ParamSpec", "init_params", "param_count", "stack_spec",
           "ShardedPlannedMatrix", "build_sharded", "shard_csr"]
