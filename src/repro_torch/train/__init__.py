"""The fault-tolerant trainer (``train/loop.py``)."""
from .loop import (StragglerWatchdog, TrainConfig, Trainer, TrainState,
                   run_with_restarts)

__all__ = ["StragglerWatchdog", "TrainConfig", "Trainer", "TrainState",
           "run_with_restarts"]
