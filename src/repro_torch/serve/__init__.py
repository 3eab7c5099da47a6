"""Serving: the LM decode engine with continuous batching, and the
register-once / query-many SpMV service behind its guarded degradation
ladder (``docs/robustness.md``)."""
from . import faults
from .engine import Request, ServeEngine
from .faults import FaultRegistry, InjectedFault
from .guard import CircuitBreaker, GuardedImpl, GuardError, guard_ladder
from .spmv_service import (AdmissionError, EvictedError, MatrixEntry,
                           SpMVService)

__all__ = [
    "Request", "ServeEngine", "MatrixEntry", "SpMVService",
    # fault tolerance (docs/robustness.md)
    "GuardedImpl", "CircuitBreaker", "GuardError", "guard_ladder",
    "AdmissionError", "EvictedError",
    "faults", "FaultRegistry", "InjectedFault",
]
