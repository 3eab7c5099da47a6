"""Optimizer: AdamW, the port of the JAX package's ``optim/adamw.py`` (its
gradient compression, ``optim/compress.py``, is multi-device: ROADMAP.md
item A16c)."""
from . import adamw
from .adamw import AdamWConfig, AdamWMixedState, AdamWState

__all__ = ["adamw", "AdamWConfig", "AdamWMixedState", "AdamWState"]
