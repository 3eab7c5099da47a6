"""Deterministic fault injection for the resilience layer (stdlib-only).

The degradation ladder in :mod:`repro_torch.serve.guard` is only
trustworthy if every rung can be *made* to fail on demand, in CI, without flaky
monkeypatching.  This module provides named **fault points** that the
pipeline consults at well-defined sites:

=================  ========================================================
point              where it fires
=================  ========================================================
``kernel.raise``   the tuned (kernel/hybrid) rung of a GuardedImpl raises
                   :class:`InjectedFault` before running
``kernel.nan``     the tuned rung's output is poisoned to NaN after running
                   (exercises the ``isfinite`` probe, not the except path)
``transform.raise``a host format conversion (``transform.host_csr_to_*``)
                   raises :class:`InjectedFault`
``store.corrupt``  :class:`~repro_torch.core.plan_store.PlanStore.put` scribbles
                   over the entry it just wrote (exercises checksum
                   verification + quarantine on the next load)
``clock.skew``     every timestamp the ``SpMVService`` takes jumps forward
                   by ``SKEW_S`` (exercises deadline-flush robustness)
``delta.corrupt``  the streaming tier's ``apply_delta`` poisons the
                   incrementally updated container right before validation
                   (exercises the degrade-to-full-re-transform path: a bad
                   delta apply must never serve wrong results)
=================  ========================================================

Faults are **deterministic**: each armed point draws from its own seeded
``random.Random``, so a probability-``p`` fault fires on the same calls in
every run.  Arm via code::

    from repro_torch.serve import faults
    faults.arm("kernel.nan", prob=1.0, seed=0)
    ...
    faults.clear()                       # or faults.disarm("kernel.nan")

or through the environment — ``REPRO_FAULTS=point:prob:seed`` (comma
separated for several points; ``prob``/``seed`` optional, defaulting to
``1.0``/``0``)::

    REPRO_FAULTS=kernel.nan:1.0:0 python examples/quickstart.py

or scoped, for tests::

    with faults.inject("kernel.raise", prob=1.0, seed=3):
        ...

The registry is intentionally tiny and dependency-free: call sites pay one
dict lookup when nothing is armed, and the module imports no torch —
the *effect* of a fault (raising, poisoning an array) is produced by the call
site, the registry only answers "does this point fire now?" and counts.
"""
from __future__ import annotations

import os
import random
import threading
from typing import Dict, Optional, Tuple

#: the known fault-point vocabulary (arming an unknown point is an error —
#: a typo'd point would otherwise silently never fire)
FAULT_POINTS = ("kernel.raise", "kernel.nan", "transform.raise",
                "store.corrupt", "clock.skew", "delta.corrupt")

#: seconds a fired ``clock.skew`` adds to a timestamp
SKEW_S = 1.0


class InjectedFault(RuntimeError):
    """The failure an armed ``*.raise`` fault point produces.  A distinct
    type so tests (and swallowed-error accounting) can tell injected
    failures from organic ones."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point!r}")
        self.point = point


class _Fault:
    __slots__ = ("point", "prob", "seed", "rng", "fired", "checked")

    def __init__(self, point: str, prob: float, seed: int):
        self.point = point
        self.prob = float(prob)
        self.seed = int(seed)
        self.rng = random.Random(int(seed))
        self.fired = 0
        self.checked = 0


class FaultRegistry:
    """Armed fault points + deterministic fire decisions.  One
    process-wide default lives behind :func:`get`; tests may construct
    their own and pass it to a GuardedImpl explicitly."""

    def __init__(self) -> None:
        self._armed: Dict[str, _Fault] = {}
        self._lock = threading.Lock()

    # -- arming --------------------------------------------------------------
    def arm(self, point: str, prob: float = 1.0, seed: int = 0) -> None:
        if point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {point!r}; one of "
                             f"{FAULT_POINTS}")
        if not (0.0 <= prob <= 1.0):
            raise ValueError(f"fault probability must be in [0, 1]; "
                             f"got {prob}")
        with self._lock:
            self._armed[point] = _Fault(point, prob, seed)

    def disarm(self, point: str) -> None:
        with self._lock:
            self._armed.pop(point, None)

    def clear(self) -> None:
        with self._lock:
            self._armed.clear()

    def armed(self, point: Optional[str] = None):
        """The armed points (names), or whether one specific point is."""
        with self._lock:
            if point is not None:
                return point in self._armed
            return tuple(sorted(self._armed))

    # -- firing --------------------------------------------------------------
    def should_fire(self, point: str) -> bool:
        """Deterministic decision for one arrival at ``point``.  Unarmed
        points cost a single dict lookup and never fire."""
        f = self._armed.get(point)
        if f is None:
            return False
        with self._lock:
            f.checked += 1
            fire = f.prob >= 1.0 or f.rng.random() < f.prob
            if fire:
                f.fired += 1
        return fire

    def maybe_raise(self, point: str) -> None:
        if self.should_fire(point):
            raise InjectedFault(point)

    def skew(self, t: float) -> float:
        """``clock.skew``'s effect: a fired reading jumps ``SKEW_S``
        forward; everything else passes through untouched."""
        return t + SKEW_S if self.should_fire("clock.skew") else t

    def counts(self) -> Dict[str, Dict[str, int]]:
        """Per-point ``{checked, fired}`` — the registry's own stats."""
        with self._lock:
            return {p: {"checked": f.checked, "fired": f.fired}
                    for p, f in self._armed.items()}

    # -- env bootstrap -------------------------------------------------------
    def arm_from_env(self, spec: Optional[str] = None) -> Tuple[str, ...]:
        """Arm every point in a ``REPRO_FAULTS``-style spec
        (``point[:prob[:seed]]``, comma separated).  Malformed entries
        raise — a chaos run with a typo'd spec must fail loudly, not run
        green with no faults."""
        spec = (os.environ.get("REPRO_FAULTS", "")
                if spec is None else spec).strip()
        if not spec:
            return ()
        armed = []
        for part in spec.split(","):
            fields = part.strip().split(":")
            if not fields[0]:
                continue
            point = fields[0]
            prob = float(fields[1]) if len(fields) > 1 and fields[1] else 1.0
            seed = int(fields[2]) if len(fields) > 2 and fields[2] else 0
            self.arm(point, prob=prob, seed=seed)
            armed.append(point)
        return tuple(armed)


class inject:
    """Scoped arming: ``with faults.inject("kernel.raise"): ...`` arms on
    entry and restores the point's previous state on exit."""

    def __init__(self, point: str, prob: float = 1.0, seed: int = 0,
                 registry: Optional[FaultRegistry] = None):
        self.point = point
        self.prob = prob
        self.seed = seed
        self.registry = registry

    def __enter__(self) -> FaultRegistry:
        reg = self.registry if self.registry is not None else get()
        self._reg = reg
        self._was_armed = reg.armed(self.point)
        reg.arm(self.point, prob=self.prob, seed=self.seed)
        return reg

    def __exit__(self, *exc) -> None:
        # restore by disarming; a previously armed point is re-armed fresh
        # (its rng state is not preserved — nesting the same point is rare
        # and deterministic-from-seed either way)
        self._reg.disarm(self.point)
        return None


# ---------------------------------------------------------------------------
# the process-wide default (env-bootstrapped, like repro_torch.obs)
# ---------------------------------------------------------------------------
_default: Optional[FaultRegistry] = None
_default_lock = threading.Lock()


def get() -> FaultRegistry:
    """The process-wide registry (created on first use; arms whatever
    ``REPRO_FAULTS`` names)."""
    global _default
    reg = _default
    if reg is None:
        with _default_lock:
            reg = _default
            if reg is None:
                reg = FaultRegistry()
                reg.arm_from_env()
                _default = reg
    return reg


def set_default(reg: Optional[FaultRegistry]) -> Optional[FaultRegistry]:
    """Swap the process-wide registry (``None`` resets to lazy env
    bootstrap); returns the previous one so tests can restore it."""
    global _default
    with _default_lock:
        prev = _default
        _default = reg
        return prev


# -- delegating conveniences (what instrumented call sites use) -------------
def arm(point: str, prob: float = 1.0, seed: int = 0) -> None:
    get().arm(point, prob=prob, seed=seed)


def disarm(point: str) -> None:
    get().disarm(point)


def clear() -> None:
    get().clear()


def armed(point: Optional[str] = None):
    return get().armed(point)


def should_fire(point: str) -> bool:
    return get().should_fire(point)


def maybe_raise(point: str) -> None:
    get().maybe_raise(point)


def skew(t: float) -> float:
    return get().skew(t)


def counts() -> Dict[str, Dict[str, int]]:
    return get().counts()


def active() -> bool:
    """Whether any point is armed — the one-branch fast-path check hot
    sites may use before paying for labels."""
    return bool(get().armed())


__all__ = ["FAULT_POINTS", "SKEW_S", "InjectedFault", "FaultRegistry",
           "inject", "get", "set_default", "arm", "disarm", "clear",
           "armed", "should_fire", "maybe_raise", "skew", "counts",
           "active"]
