"""Parameter specs (the one-device subset of the JAX package's sharding
tier; meshes and the sharded SpMV executor come with ROADMAP A15)."""
from .rules import ParamSpec, init_params, param_count, stack_spec

__all__ = ["ParamSpec", "init_params", "param_count", "stack_spec"]
