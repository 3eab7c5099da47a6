"""Checkpoints in the JAX package's on-disk format (``checkpoint/ckpt.py``)."""
from .ckpt import (AsyncCheckpointer, available_steps, gc_keep_last,
                   latest_step, restore, save)

__all__ = ["AsyncCheckpointer", "available_steps", "gc_keep_last",
           "latest_step", "restore", "save"]
