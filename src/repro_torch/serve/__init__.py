"""Serving: the LM decode engine with continuous batching.  The SpMV
service and its guard come with ROADMAP A13."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
