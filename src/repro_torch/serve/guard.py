"""Guarded execution: degrade down a ladder instead of dying.

The paper's whole premise is that the tuned path (ELL/SELL + run-time
transformation, tuned launch geometry) is an *optimization over* an
always-correct CRS baseline — ``k·B·(t_crs − t_f) > t_trans`` only pays
off because falling back to CRS is always possible and cheap.  This module
makes that fallback a first-class serving construct:

* :class:`GuardedImpl` — wraps one operator (a ``(key, op)`` pair in the
  service) as an ordered ladder of rungs, e.g.::

      tuned (kernel-tier hybrid)  →  reference-format  →  reference CSR

  A call runs the highest healthy rung; a failure — exception, non-finite
  output (cheap ``isfinite`` probe), or blown wall-clock budget — demotes
  the call down the ladder transparently.  The last rung is the semantic
  oracle and is never probed: whatever it returns is the answer.

* :class:`CircuitBreaker` — per ``(key, format, op)``: after ``failures``
  consecutive tuned-rung failures the breaker *opens* and calls skip the
  broken rung outright (stop paying the failure cost per call); after
  ``cooldown_s`` it goes *half-open* and lets exactly one probe call
  through — success closes it (tuned tier restored), failure re-opens it.

Failure detection, fallbacks, and breaker transitions are exported through
:mod:`repro_torch.obs` under the JAX package's names (``service.fallback``
/ ``guard.failure`` counters, ``guard.breaker`` events) and surface in
``SpMVService.stats()``.

Fault injection (:mod:`repro_torch.serve.faults`) is threaded through the
tuned rung only — ``kernel.raise`` raises before it runs, ``kernel.nan``
poisons its output (``torch.full_like(y, nan)``) — so the whole ladder is
testable deterministically; the fallback rungs run clean, which is exactly
the claim being tested: injected tuned-tier failures never change served
results.

On CUDA a kernel runs asynchronously, so what the ladder can see differs
from the JAX package's:

* the finite probe is ``torch.isfinite(y).all().item()``: one
  device-to-host sync a guarded call, as ``jax.device_get`` is in the
  reference;
* the budget check synchronizes the card before it reads the clock, so the
  budget covers the kernel, not its launch;
* a fault of the card or of a kernel's build (:func:`is_device_fault`: a
  ``KernelBuildError``, a ``KernelLaunchError``, a CUDA error raised by
  torch) is raised to the caller from whatever rung meets it, never served
  around: a kernel that does not build or launch must not turn into a
  quiet plain-PyTorch service, and a *sticky* error (an illegal address)
  poisons the CUDA context, so the lower rungs would fail too;
* with ``probe_finite=False`` and no budget nothing synchronizes inside the
  ladder, so an asynchronous kernel error surfaces at the caller's next
  sync (``SpMVService`` synchronizes after every product), outside it.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .. import obs as _obs
from ..kernels.build import KernelBuildError, KernelLaunchError
from . import faults as _faults

#: breaker states
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

#: numeric encoding of the state machine for the ``service.breaker_state``
#: gauge (Prometheus gauges carry floats, not strings)
STATE_CODES = {CLOSED: 0, OPEN: 1, HALF_OPEN: 2}


def is_device_fault(e: BaseException) -> bool:
    """Whether ``e`` is a failure of the card or of a kernel's build, which
    no rung can route around: ``nvcc`` refused a source, a C entry point
    returned a ``cudaError_t``, or torch met a CUDA error (an
    ``AcceleratorError``, or a ``RuntimeError`` reading ``CUDA error`` where
    torch has no such type)."""
    if isinstance(e, (KernelBuildError, KernelLaunchError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and str(e).startswith("CUDA error")


class GuardError(RuntimeError):
    """Every rung of a guarded ladder failed.  Carries the per-rung
    failures so the caller can see the whole cascade, not just the last
    straw."""

    def __init__(self, key: str, op: str,
                 causes: Sequence[Tuple[str, BaseException]]):
        lines = "; ".join(f"{rung}: {e!r}" for rung, e in causes)
        super().__init__(
            f"all {len(causes)} rungs failed for ({key!r}, {op!r}): {lines}")
        self.key = key
        self.op = op
        self.causes = list(causes)


@dataclass
class CircuitBreaker:
    """Closed → open after ``failures`` consecutive failures → half-open
    probe after ``cooldown_s`` → closed on probe success.  All timestamps
    come from ``clock`` so tests drive it with a FakeClock (no sleeps)."""
    key: str = ""
    fmt: str = ""
    op: str = ""
    failures: int = 3
    cooldown_s: float = 30.0
    clock: Callable[[], float] = time.perf_counter
    state: str = CLOSED
    consecutive: int = 0
    opened_at: float = 0.0
    opens: int = 0                 # lifetime closed→open transitions
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def allow(self) -> bool:
        """Whether the guarded rung may run now.  An open breaker past its
        cooldown transitions to half-open and admits exactly one probe."""
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if self.clock() - self.opened_at >= self.cooldown_s:
                    self._transition(HALF_OPEN)
                    return True        # the probe call
                return False
            # HALF_OPEN: one probe is already in flight; further calls
            # skip the rung until it reports back
            return False

    def record_success(self) -> None:
        with self._lock:
            self.consecutive = 0
            if self.state != CLOSED:
                self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self.consecutive += 1
            if self.state == HALF_OPEN or (self.state == CLOSED and
                                           self.consecutive >= self.failures):
                self.opened_at = self.clock()
                self.opens += 1
                self._transition(OPEN)

    def _transition(self, to: str) -> None:
        frm, self.state = self.state, to
        tel = _obs.get()
        if tel.enabled:
            tel.event("guard.breaker", key=self.key, fmt=self.fmt,
                      op=self.op, frm=frm, to=to,
                      consecutive=self.consecutive)
            tel.gauge("guard.breaker_open", key=self.key, fmt=self.fmt,
                      op=self.op).set(1.0 if to == OPEN else 0.0)
            # full state machine as a labelled gauge (0=closed, 1=open,
            # 2=half_open) so dashboards see half-open probes, not just
            # the open/closed projection above
            tel.gauge("service.breaker_state", key=self.key, fmt=self.fmt,
                      op=self.op).set(float(STATE_CODES[to]))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self.state,
                    "state_code": STATE_CODES[self.state],
                    "consecutive": self.consecutive,
                    "opens": self.opens, "failures": self.failures,
                    "cooldown_s": self.cooldown_s}


@dataclass
class Rung:
    """One ladder level: a self-contained thunk from input to output."""
    name: str                       # e.g. "tuned", "reference", "csr"
    fn: Callable[[Any], Any]
    #: kernel fault points fire on this rung (the tuned tier only)
    inject: bool = False


class GuardedImpl:
    """One guarded operator: an ordered rung ladder plus the tuned rung's
    circuit breaker.  Stats are kept locally (cheap ints, no telemetry
    dependency) *and* mirrored to ``repro_torch.obs`` when enabled."""

    def __init__(self, key: str, op: str, rungs: Sequence[Rung], *,
                 breaker: Optional[CircuitBreaker] = None,
                 probe_finite: bool = True,
                 budget_s: Optional[float] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 fault_registry: Optional[Any] = None):
        if not rungs:
            raise ValueError("GuardedImpl needs at least one rung")
        self.key = key
        self.op = op
        self.rungs = list(rungs)
        self.breaker = breaker
        self.probe_finite = probe_finite
        self.budget_s = budget_s
        self.clock = clock
        self.faults = fault_registry
        self.calls = 0
        self.short_circuits = 0       # breaker-open skips of the top rung
        self.fallback_calls = 0       # calls served below the top rung
        self.served_by: Dict[str, int] = {r.name: 0 for r in self.rungs}
        self.failures: Dict[str, int] = {}   # "rung/reason" -> count

    # -- failure detection ---------------------------------------------------
    def _finite(self, y: Any) -> bool:
        # one device-to-host sync: the card finishes the rung's work first
        with _obs.get().span("guard.probe", on=y):
            ok = torch.isfinite(y).all()
        return bool(ok.item())

    def _fail(self, rung: Rung, reason: str, tel) -> None:
        k = f"{rung.name}/{reason}"
        self.failures[k] = self.failures.get(k, 0) + 1
        if self.breaker is not None and rung is self.rungs[0]:
            self.breaker.record_failure()
        if tel.enabled:
            tel.counter("guard.failure", key=self.key, op=self.op,
                        rung=rung.name, reason=reason).inc()

    # -- the ladder ----------------------------------------------------------
    def __call__(self, x: Any) -> Any:
        self.calls += 1
        tel = _obs.get()
        reg = self.faults if self.faults is not None else _faults.get()
        causes: List[Tuple[str, BaseException]] = []
        start = 0
        if (self.breaker is not None and len(self.rungs) > 1
                and not self.breaker.allow()):
            # open breaker: stop paying the failure cost per call
            start = 1
            self.short_circuits += 1
            if tel.enabled:
                tel.counter("guard.short_circuit", key=self.key,
                            op=self.op).inc()
        last = len(self.rungs) - 1
        for i in range(start, len(self.rungs)):
            rung = self.rungs[i]
            try:
                if rung.inject:
                    reg.maybe_raise("kernel.raise")
                t0 = self.clock()
                y = rung.fn(x)
                if rung.inject and reg.should_fire("kernel.nan"):
                    y = torch.full_like(y, float("nan"))
                if i < last:
                    # the last rung is the oracle: served as-is, unprobed
                    if self.budget_s is not None:
                        if y.device.type == "cuda":
                            torch.cuda.synchronize(y.device)
                        if self.clock() - t0 > self.budget_s:
                            self._fail(rung, "budget", tel)
                            causes.append((rung.name, TimeoutError(
                                f"rung {rung.name!r} blew its "
                                f"{self.budget_s}s budget")))
                            continue
                    if self.probe_finite and not self._finite(y):
                        self._fail(rung, "non_finite", tel)
                        causes.append((rung.name, FloatingPointError(
                            f"non-finite output from rung {rung.name!r}")))
                        continue
            except Exception as e:     # noqa: BLE001 — the ladder exists
                #                        to catch whatever the rung throws
                if is_device_fault(e):
                    raise
                self._fail(rung, "exception", tel)
                causes.append((rung.name, e))
                continue
            # success
            self.served_by[rung.name] += 1
            if self.breaker is not None and i == 0:
                self.breaker.record_success()
            if i > 0:
                self.fallback_calls += 1
                if tel.enabled:
                    tel.counter("service.fallback", key=self.key,
                                op=self.op, rung=rung.name).inc()
                    tel.event("guard.degraded", key=self.key, op=self.op,
                              rung=rung.name,
                              causes=[f"{r}: {type(e).__name__}"
                                      for r, e in causes])
            return y
        raise GuardError(self.key, self.op, causes)

    # -- observability -------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {
            "rungs": [r.name for r in self.rungs],
            "calls": self.calls,
            "served_by": dict(self.served_by),
            "fallback_calls": self.fallback_calls,
            "short_circuits": self.short_circuits,
            "failures": dict(self.failures),
            "breaker": (self.breaker.snapshot()
                        if self.breaker is not None else None),
        }


def guard_ladder(key: str, op: str, rungs: Sequence[Tuple[str, Callable]],
                 *, fmt: str = "", breaker_failures: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 probe_finite: bool = True,
                 budget_s: Optional[float] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 breaker: Optional[CircuitBreaker] = None,
                 fault_registry: Optional[Any] = None) -> GuardedImpl:
    """Convenience constructor: ``rungs`` as (name, thunk) pairs, the
    first rung marked as the fault-injectable tuned tier, a fresh breaker
    unless one is shared in."""
    if breaker is None and len(rungs) > 1:
        breaker = CircuitBreaker(key=key, fmt=fmt, op=op,
                                 failures=breaker_failures,
                                 cooldown_s=breaker_cooldown_s, clock=clock)
    built = [Rung(name=n, fn=f, inject=(i == 0))
             for i, (n, f) in enumerate(rungs)]
    return GuardedImpl(key, op, built, breaker=breaker,
                       probe_finite=probe_finite, budget_s=budget_s,
                       clock=clock, fault_registry=fault_registry)


__all__ = ["CLOSED", "OPEN", "HALF_OPEN", "STATE_CODES", "GuardError",
           "CircuitBreaker", "Rung", "GuardedImpl", "guard_ladder",
           "is_device_fault"]
