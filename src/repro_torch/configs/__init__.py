"""Architecture registry: ``get_config("<id>")`` with hyphen/underscore
tolerance; ``ARCH_IDS`` lists the ten assigned architectures."""
from importlib import import_module

from .base import (ModelConfig, ShapeConfig, SHAPES, smoke_config,
                   ATTN_KINDS, SSM_KINDS, XLSTM_KINDS)

ARCH_IDS = (
    "internvl2-2b", "dbrx-132b", "mixtral-8x22b", "xlstm-1.3b",
    "gemma3-12b", "h2o-danube-1.8b", "minitron-8b", "qwen3-1.7b",
    "zamba2-1.2b", "musicgen-medium",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch: str) -> ModelConfig:
    key = arch.replace("_", "-")
    if key not in _MODULES:
        # tolerate exact module-style names too
        matches = [a for a in ARCH_IDS if a.replace("-", "_").replace(".", "_")
                   == arch]
        if not matches:
            raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
        key = matches[0]
    mod = import_module(f"repro_torch.configs.{_MODULES[key]}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
