"""Optimizer: AdamW (the port of the JAX package's ``optim/adamw.py``) and
the int8 compressed all-reduce with error feedback (``optim/compress.py``)."""
from . import adamw, compress
from .adamw import AdamWConfig, AdamWMixedState, AdamWState

__all__ = ["adamw", "compress", "AdamWConfig", "AdamWMixedState",
           "AdamWState"]
