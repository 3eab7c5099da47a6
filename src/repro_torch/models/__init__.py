"""The LM substrate — every block kind of the ten architectures (attention,
MoE, Mamba-2, xLSTM), served and trained — ported from the JAX package's
``models/``."""
from .convert import (jax_spec, opt_state_from_jax, opt_state_to_jax,
                      params_from_jax, params_to_jax)
from .model import (backbone, decode_step, forward, init, init_caches,
                    layer_kinds, loss_fn, model_spec, n_active_params,
                    n_params, prefill)

__all__ = ["backbone", "decode_step", "forward", "init", "init_caches",
           "jax_spec", "layer_kinds", "loss_fn", "model_spec",
           "n_active_params", "n_params", "opt_state_from_jax",
           "opt_state_to_jax", "params_from_jax", "params_to_jax",
           "prefill"]
