"""The LM substrate's attention architectures (block kinds ``attn`` and
``local``), ported from the JAX package's ``models/``."""
from .convert import params_from_jax
from .model import (decode_step, forward, init, init_caches, layer_kinds,
                    model_spec, n_params, prefill)

__all__ = ["decode_step", "forward", "init", "init_caches", "layer_kinds",
           "model_spec", "n_params", "params_from_jax", "prefill"]
