"""Pipeline parallelism: GPipe over a ``pipe`` mesh dim (``gpipe.py``)."""
from .gpipe import bubble_fraction, pipeline_forward, reference_forward

__all__ = ["bubble_fraction", "pipeline_forward", "reference_forward"]
