"""The LM substrate's serving path — every block kind of the ten
architectures (attention, MoE, Mamba-2, xLSTM) — ported from the JAX
package's ``models/``."""
from .convert import params_from_jax
from .model import (decode_step, forward, init, init_caches, layer_kinds,
                    model_spec, n_active_params, n_params, prefill)

__all__ = ["decode_step", "forward", "init", "init_caches", "layer_kinds",
           "model_spec", "n_active_params", "n_params", "params_from_jax",
           "prefill"]
