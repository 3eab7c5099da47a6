"""The pure functions of the JAX package's ``launch/dryrun.py``.

The reference's dry run lowers and compiles every (architecture x shape x
mesh) cell on 512 placeholder TPU devices and reads XLA's memory and cost
analysis against the HBM of one TPU chip.  None of that has a CUDA counterpart
(no HLO, no placeholder mesh; ROADMAP.md item A16c): what the port keeps is
the model-FLOP count the ``train`` phase of ``chip_smoke.py`` divides by a
step's time for its MFU, and the two helpers that need no compiler.
"""
from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig
from ..models.model import n_active_params


def unrolled_cfg(cfg: ModelConfig) -> ModelConfig:
    """The layer pattern expanded to full depth (one repetition of a
    ``period == n_layers`` pattern)."""
    full = (tuple(cfg.layer_pattern) * cfg.scan_reps +
            tuple(cfg.remainder_pattern))
    return cfg.replace(layer_pattern=full, n_layers=len(full))


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("SKIP(design): pure full-attention arch defines no "
                "sub-quadratic mechanism for 524k context (DESIGN.md §5)")
    return ""


def model_flops_for(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Model FLOPs of one step: 6 N D for training (2 N D forward, 4 N D
    backward), 2 N D otherwise, N the active parameters, D the tokens."""
    n_act = n_active_params(cfg)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_act * tokens


__all__ = ["unrolled_cfg", "skip_reason", "model_flops_for"]
