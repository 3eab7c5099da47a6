"""The synthetic token pipeline (a copy of the JAX package's
``data/pipeline.py``)."""
from .pipeline import DataConfig, Prefetcher, SyntheticLM, data_config_for

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM", "data_config_for"]
