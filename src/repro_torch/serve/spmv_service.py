"""Serving path for auto-tuned sparse operators.

Production framing of the paper's on-line phase: clients register a sparse
matrix once (a model's MoE routing table, a graph adjacency, a solver
operator) and then stream many SpMV/SpMM requests against it.
Registration is where the run-time transformation happens — per-row-block
via the partition subsystem — and the amortization count
``expected_iterations`` is the paper's k in ``k * (t_crs - t_f) >
t_trans``; with B right-hand sides per call it strengthens to
``k * B * (t_crs - t_f) > t_trans``.

Two query paths:

  * direct — ``spmv(key, x)`` / ``spmm(key, X)``: one blocking call, one
    dispatcher per (matrix, op);
  * micro-batched — ``submit(key, x) -> Future`` enqueues a single vector;
    ``flush()`` (or the queue reaching ``max_batch``) stacks the pending
    vectors into one ``(n_cols, B)`` panel and serves them with a *single*
    SpMM call per matrix.  Panels are zero-padded to ``max_batch`` so the
    SpMM dispatcher serves one input signature per matrix; the ragged last
    micro-batch just carries padding columns that are sliced off.
    ``deadline_ms`` adds a latency bound: ``submit`` flushes as soon as the
    oldest pending future has waited past the deadline (and ``poll()`` lets
    a serving loop sweep overdue queues without new traffic).

With a ``tuner`` (``core.kernel_tune.KernelTuner``), registration also
runs the kernel launch-geometry search once per block format — the paper's
register-once/query-many amortization applied one level down, to the launch
shapes themselves — and every subsequent query reuses the tuned geometry
through each block format's CUDA kernel.

Resilience (docs/robustness.md):

  * every query runs through a :class:`~repro_torch.serve.guard.GuardedImpl`
    ladder — tuned → reference-format → reference-CSR — so a broken tuned
    tier (exception, NaN output, blown budget) degrades instead of
    failing; a per-``(key, format, op)`` circuit breaker stops paying the
    failure cost per call and half-open-probes its way back;
  * a :class:`~repro_torch.core.plan_store.PlanStore` (``plan_store=``)
    shares tuned plans across processes — tune once per fleet, not per
    replica — with checksummed atomic persistence and
    quarantine-on-corruption;
  * the micro-batch queue has admission control: a bounded per-key depth
    (``max_queue``) under a ``reject`` / ``shed_oldest`` / ``block``
    policy, deadline-aware rejection when the predicted wait exceeds
    ``deadline_ms``, and eviction fails outstanding futures with a typed
    :class:`EvictedError` instead of leaving them dangling.

What differs from the JAX package's service on CUDA:

  * **Device.**  ``SpMVService(device=)`` (``None`` = the CUDA card;
    ``"cpu"`` runs each kernel's plain version) is where every registration
    serves.  The CSR source is uploaded once at registration; the
    reference-CSR rung serves from that copy.
  * **Copies.**  torch tensors alias where JAX arrays are immutable:
    ``submit`` keeps its own copy of ``x`` on the service's device (a
    caller editing ``x`` afterwards does not change its answer), and a
    flush hands each future its own tensor, not a view of the shared
    panel (one client's in-place edit cannot reach another's result).
  * **Synchronization.**  Every product synchronizes the card before it
    returns, where the reference calls ``block_until_ready``.
  * **No jit.**  ``compile_count`` (``stats()[key]["compiled"]``) counts
    the distinct input signatures ``(shape, dtype)`` each dispatcher has
    served — what a jit cache holds; padded panels keep it at one SpMM
    signature per matrix.
  * **Telemetry** uses only the JAX package's names (``service.*``,
    ``guard.*``, ``store.*``, ``plan.lint``, ``stream.*``, ``sharded.*``):
    the vocabulary in ``docs/observability.md`` is shared.
  * **Streaming** (``register(streaming=True)``, :meth:`apply_delta`)
    edits the source CSR and a single-block CSR/SELL container on the
    service's device (``repro_torch.stream``): a delta never copies the
    matrix between host and card.
  * **Sharded plans** serve through ``sharding.spmv.ShardedPlannedMatrix``:
    shard by shard on one device (or round robin over several) in one
    process, or, in a ``torch.distributed`` world of a rank a shard,
    ``shard_map`` — then registration and every product are collectives
    (every rank registers the same key and serves the same calls).
"""
from __future__ import annotations

import hashlib
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import obs as _obs
from ..analyze.findings import PlanLintError
from ..analyze.planlint import lint_plan as _lint_plan
from ..core import dispatch as _dispatch
from ..core.autotune import MachineModel, TuningDB, time_fn
from ..core.formats import CSR, memory_bytes
from ..core.kernel_tune import KernelTuner, TileGeometry
from ..core.plan import (BlockPlan, ExecutionPlan, PlanFingerprint,
                         ShardedPlan, TransformRecipe, bind_tunings,
                         blocks_by_format, rederive_slab_bounds)
from ..core.policy import MemoryPolicy
from ..core.spmv import spmv as spmv_ref
from ..device import DeviceLike, resolve_device
from ..partition import HybridReport, build_hybrid, spmm_hybrid, spmv_hybrid
from . import faults as _faults
from .guard import CircuitBreaker, GuardedImpl, guard_ladder


class AdmissionError(RuntimeError):
    """The micro-batch queue refused a ``submit``: per-key depth bound
    reached under the ``reject`` policy, a queued request was shed under
    ``shed_oldest``, or the predicted wait exceeds ``deadline_ms``."""


class EvictedError(KeyError, RuntimeError):
    """The matrix entry was evicted (or re-registered away) while this
    request was outstanding.  Subclasses ``KeyError`` (callers that
    treated eviction as a missing key keep working) and ``RuntimeError``
    (a released dispatcher has always raised one)."""


def _swallow(where: str, err: BaseException) -> None:
    """Account for an intentionally swallowed error — the service keeps
    serving, but silent ``except: pass`` is how failures hide, so every
    swallow lands on a counter."""
    tel = _obs.get()
    if tel.enabled:
        tel.counter("service.swallowed_errors", where=where,
                    kind=type(err).__name__).inc()
        tel.event("service.swallowed_error", where=where, error=repr(err))


class _Dispatcher:
    """One (matrix, op) operator: ``spmv_hybrid`` / ``spmm_hybrid`` over the
    entry's per-format impls.  It records the input signatures it has
    served — ``(shape, dtype)``, what a jit cache would hold — so
    ``compile_count`` means what it means in the JAX package."""

    def __init__(self, op: str, impls: Optional[Dict[str, Callable]]):
        self._fn = spmv_hybrid if op == "spmv" else spmm_hybrid
        self.impls = impls
        self.signatures: set = set()

    def __call__(self, m: Any, x: torch.Tensor) -> torch.Tensor:
        self.signatures.add((tuple(x.shape), str(x.dtype)))
        return self._fn(m, x, impls=self.impls)

    def _cache_size(self) -> int:
        return len(self.signatures)

    def clear_cache(self) -> None:
        self.signatures.clear()


def _cache_size(fn: Optional[Callable]) -> int:
    """Served-signature count of a dispatcher (0 if unavailable)."""
    try:
        return int(fn._cache_size())
    except (AttributeError, TypeError) as e:
        # guards, overrides and evicted stubs have no signature record;
        # anything else would be a bug worth surfacing
        _swallow("cache_size", e)
        return 0


def _sync(t: torch.Tensor) -> torch.Tensor:
    """Wait for the card to finish ``t`` (the reference's
    ``block_until_ready``)."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return t


def _as_x(x: Any, device: torch.device, copy: bool = False) -> torch.Tensor:
    """A query vector or panel on ``device``, contiguous; float64 input is
    taken as float32, as the JAX package's ``jnp.asarray`` takes it.
    ``copy`` always gives the service its own tensor."""
    t = torch.as_tensor(x)
    if t.dtype == torch.float64:
        t = t.float()
    return t.to(device, copy=copy).contiguous()


@dataclass
class MatrixEntry:
    matrix: Any                 # HybridMatrix, on ``device``
    report: HybridReport
    fn: Callable                # spmv dispatcher for this block structure
    spmm_fn: Callable           # spmm dispatcher for this block structure
    t_build: float
    device: torch.device = torch.device("cpu")
    t_csr: float = 0.0          # measured whole-matrix CSR SpMV (s/call)
    t_hybrid: float = 0.0       # measured hybrid SpMV (s/call)
    n_calls: int = 0
    t_serve: float = 0.0        # cumulative wall seconds inside spmv()
    n_spmm_calls: int = 0
    n_spmm_cols: int = 0        # total RHS columns served through spmm
    builds: int = 1             # times this key's operator was (re)built
    tunings: Dict[str, Dict[str, TileGeometry]] = field(default_factory=dict)
    plan: Optional[Any] = None  # ExecutionPlan | ShardedPlan this entry serves
    from_plan: bool = False     # registration replayed a supplied plan
    max_batch: Optional[int] = None  # per-key panel width (plan-seeded);
    #                                  None falls through to the service's
    source: Optional[CSR] = None     # on ``device``, for the reference-CSR rung
    guards: Dict[str, GuardedImpl] = field(default_factory=dict)
    flush_ema_s: float = 0.0    # EMA of flush latency, drives admission
    shed: int = 0               # requests dropped by shed_oldest
    # pending entries are (future, vector, enqueue time) — the timestamp
    # drives the deadline flush policy; the vector is the service's copy
    pending: List[Tuple[Future, torch.Tensor, float]] = field(
        default_factory=list)
    # guards pending/dead: submit() may race flush()/evict() across threads
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    dead: bool = False          # set by _release; refuses new submits
    # -- streaming (repro_torch.stream): registered with streaming=True -------
    streaming: bool = False
    sketch: Optional[Any] = None        # stream.drift.DriftSketch
    stream_policy: Optional[Any] = None  # stream.drift.ReplanPolicy
    stream_kw: Dict[str, Any] = field(default_factory=dict)  # re-plan knobs
    deltas: int = 0             # DeltaBatches absorbed by this key
    replans: int = 0            # drift-triggered re-registrations
    last_stream_decision: Optional[Any] = None  # stream.drift.DriftDecision

    def formats(self) -> Dict[str, int]:
        return self.report.format_counts()

    def compile_count(self) -> int:
        return _cache_size(self.fn) + _cache_size(self.spmm_fn)


@dataclass
class SpMVService:
    """Register-once / query-many sparse matrix serving.

    >>> svc = SpMVService()
    >>> svc.register("graph0", csr, expected_iterations=1000)
    >>> y = svc.spmv("graph0", x)
    >>> Y = svc.spmm("graph0", X)            # X: (n_cols, B)
    >>> f = svc.submit("graph0", x); svc.flush(); y = f.result()
    """
    db: Optional[TuningDB] = None
    model: Optional[MachineModel] = None
    policy: Optional[MemoryPolicy] = None
    strategy: str = "variance"
    impls: Optional[Dict[str, Callable]] = None   # per-format spmv overrides
    spmm_impls: Optional[Dict[str, Callable]] = None  # per-format spmm overrides
    tuner: Optional[KernelTuner] = None  # launch-geometry search at register
    max_batch: int = 32         # micro-batch flush threshold / panel width
    pad_batches: bool = True    # zero-pad panels to max_batch (one signature)
    deadline_ms: Optional[float] = None  # flush when oldest pending exceeds
    # every timestamp the service takes (deadline ages, serve timings) comes
    # from this clock, so deadline tests run on a FakeClock with no sleeps
    clock: Callable[[], float] = time.perf_counter
    entries: Dict[str, MatrixEntry] = field(default_factory=dict)
    # where every registration serves (None = the CUDA card)
    device: DeviceLike = None
    # -- resilience knobs (docs/robustness.md) -------------------------------
    guard: bool = True          # serve through the degradation ladder
    probe_finite: bool = True   # isfinite probe on non-final rungs
    budget_ms: Optional[float] = None    # per-rung wall-clock budget
    breaker_failures: int = 3   # consecutive failures before open
    breaker_cooldown_s: float = 30.0     # open -> half-open probe delay
    plan_store: Optional[Any] = None     # core.plan_store.PlanStore
    max_queue: Optional[int] = None      # per-key pending-depth bound
    admission: str = "reject"   # "reject" | "shed_oldest" | "block"
    # breakers are keyed (key, format, op) and survive evict/re-register —
    # a matrix that keeps breaking stays broken across rebuilds until a
    # half-open probe proves otherwise
    _breakers: Dict[Tuple[str, str, str], CircuitBreaker] = field(
        default_factory=dict, repr=False)
    # fingerprint-keyed plan cache: registering a matrix whose structure
    # matches an evicted/previous registration replays the cached plan
    # instead of re-tuning (survives evict — it lives on the service)
    plan_cache_max: int = 32
    _plan_cache: Dict[Tuple, ExecutionPlan] = field(default_factory=dict,
                                                    repr=False)
    _plan_cache_hits: int = 0
    _plan_cache_misses: int = 0

    def _now(self) -> float:
        """Every service timestamp flows through here so the
        ``clock.skew`` fault point can distort it deterministically."""
        return _faults.skew(self.clock())

    # -- launch-geometry tuning at registration ------------------------------
    def _impl_bases(self) -> Dict[str, Dict[str, Callable]]:
        return {
            "spmv": dict(self.impls) if self.impls is not None
            else _dispatch.impl_table("spmv", "kernel", exclude=("hybrid",)),
            "spmm": dict(self.spmm_impls) if self.spmm_impls is not None
            else _dispatch.impl_table("spmm", "kernel", exclude=("hybrid",)),
        }

    def _tuned_impls(self, hyb, host_by_fmt: Dict[str, List[Any]]
                     ) -> Tuple[Optional[Dict], Optional[Dict],
                                Dict[str, Dict[str, TileGeometry]]]:
        """Run the launch-geometry search once per (op, block format) on
        the biggest block of that format (on the card, where it will
        serve), and bind the winners into the per-block impl dicts.  For
        CSR/CCS/BCSR the slab-coverage bound is re-derived over *all*
        blocks of that format (``host_by_fmt``, on the host), as the
        reference records it."""
        if self.tuner is None:
            return self.impls, self.spmm_impls, {}
        bases = self._impl_bases()
        by_fmt = blocks_by_format(hyb)
        tunings: Dict[str, Dict[str, TileGeometry]] = {}
        for op, base in bases.items():
            batch = 1 if op == "spmv" else self.max_batch
            per_fmt: Dict[str, TileGeometry] = {}
            for f, blocks in by_fmt.items():
                if f not in base:
                    continue
                big = max(blocks, key=lambda b: getattr(b, "nnz", 0))
                try:
                    rec = self.tuner.tune(big, op=op, batch=batch,
                                          impl=base[f])
                except (KeyError, TypeError):
                    continue
                per_fmt[f] = rec.geometry
            tunings[op] = rederive_slab_bounds(per_fmt, host_by_fmt)
        return (bind_tunings(bases["spmv"], tunings["spmv"]),
                bind_tunings(bases["spmm"], tunings["spmm"]), tunings)

    def _plan_impls(self, host_by_fmt: Dict[str, List[Any]],
                    plan: ExecutionPlan
                    ) -> Tuple[Optional[Dict], Optional[Dict],
                               Dict[str, Dict[str, TileGeometry]]]:
        """Bind a supplied (fingerprint-matched) plan's recorded launch
        geometry into the per-block impl dicts — the register-with-plan
        path that skips the tuner's search entirely.  Reference-tier plans
        serve through the service's configured impls untouched."""
        if plan.tier != "kernel":
            return self.impls, self.spmm_impls, {}
        tunings = {op: rederive_slab_bounds(per, host_by_fmt)
                   for op, per in plan.tunings_by_format().items()}
        bases = self._impl_bases()
        return (bind_tunings(bases["spmv"], tunings.get("spmv", {})),
                bind_tunings(bases["spmm"], tunings.get("spmm", {})),
                tunings)

    # -- the degradation ladder ----------------------------------------------
    def _breaker(self, key: str, fmt: str, op: str) -> CircuitBreaker:
        bk = (key, fmt, op)
        br = self._breakers.get(bk)
        if br is None:
            br = self._breakers[bk] = CircuitBreaker(
                key=key, fmt=fmt, op=op, failures=self.breaker_failures,
                cooldown_s=self.breaker_cooldown_s, clock=self._now)
        return br

    def _build_guards(self, key: str, entry: MatrixEntry, fmt: str,
                      sharded: bool = False) -> Dict[str, GuardedImpl]:
        """The per-(key, op) ladders: tuned → reference-format →
        reference-CSR (sharded entries skip the middle rung — their
        reference tier *is* per-shard CSR).  The source matrix is kept on
        the entry (on its device) purely so the last rung always exists.

        Every rung reads ``entry.matrix`` / ``entry.source`` / ``entry.fn``
        at call time rather than closing over them: a streaming key's
        containers are swapped by :meth:`apply_delta`, and the ladder (and
        its breaker) keeps serving the *current* matrix across swaps."""
        if not self.guard:
            return {}
        budget_s = self.budget_ms / 1e3 if self.budget_ms else None
        csr_mm = _dispatch.get_impl("csr", "spmm", "reference")
        rungs: Dict[str, List[Tuple[str, Callable]]] = {
            "spmv": [("tuned", lambda x: entry.fn(entry.matrix, x))],
            "spmm": [("tuned", lambda x: entry.spmm_fn(entry.matrix, x))],
        }
        if not sharded:
            rungs["spmv"].append(
                ("reference", lambda x: spmv_hybrid(entry.matrix, x)))
            rungs["spmm"].append(
                ("reference", lambda x: spmm_hybrid(entry.matrix, x)))
        rungs["spmv"].append(("csr", lambda x: spmv_ref(entry.source, x)))
        rungs["spmm"].append(("csr", lambda x: csr_mm(entry.source, x)))
        return {op: guard_ladder(
            key, op, rungs[op], fmt=fmt,
            breaker=self._breaker(key, fmt, op),
            probe_finite=self.probe_finite, budget_s=budget_s,
            clock=self._now) for op in ("spmv", "spmm")}

    # -- registration --------------------------------------------------------
    def _lint_registered_plan(self, key: str, plan: Any,
                              strict: bool) -> Any:
        """Static lint of a caller-supplied plan before it is bound.

        A plan that fails lint is refused with a typed
        :class:`~repro_torch.analyze.findings.PlanLintError` under
        ``strict``; otherwise it is dropped (counted, evented) and
        registration proceeds as if no plan was supplied, rebuilding
        fresh.  The lint is framework-free and runs on ``plan.to_dict()``."""
        if plan is None:
            return None
        errs = [f for f in _lint_plan(plan.to_dict()) if f.severity == "error"]
        if not errs:
            return plan
        tel = _obs.get()
        if tel.enabled:
            tel.counter("service.plan_lint", key=key, strict=strict).inc()
            tel.event("service.plan_lint", key=key, strict=strict,
                      errors=[f.render() for f in errs])
        err = PlanLintError(
            f"plan for {key!r} failed lint with {len(errs)} error(s):\n"
            + "\n".join(f.render() for f in errs), errs)
        if strict:
            raise err
        _swallow("plan_lint", err)
        return None

    def register(self, key: str, csr: CSR, expected_iterations: int = 100,
                 measure_baseline: bool = True, batch: int = 1,
                 plan: Optional[ExecutionPlan] = None,
                 strict_lint: bool = False,
                 streaming: bool = False,
                 stream_policy: Optional[Any] = None,
                 **build_kw) -> MatrixEntry:
        """Build the per-block-tuned operator for ``csr`` under ``key``.

        ``batch`` is the expected RHS count per call, fed to the
        batch-aware decision (amortization over ``expected_iterations *
        batch`` products).  ``measure_baseline`` times one whole-matrix CSR
        SpMV and one hybrid SpMV (a few extra calls at registration) so
        ``stats()`` can report true amortization; re-registering a key
        replaces its operator and releases the stale dispatchers.  With a
        ``tuner`` set, registration also searches kernel launch geometry
        per block format on the card and binds the winners into the
        dispatchers — queries reuse them for free.

        ``plan``: a saved :class:`~repro_torch.core.plan.ExecutionPlan`.
        When its fingerprint matches ``csr``, registration *replays* it —
        the recorded per-block decisions and launch geometry are bound
        directly, skipping both the per-block decision machinery and the
        tuner's search.  A mismatched plan falls back to a full build (and
        re-tune); either way the entry's ``plan`` attribute carries the
        plan this key is serving, so ``register`` without a plan is also
        how plans are *minted* (``svc.register(...).plan.save(path)``).

        A :class:`~repro_torch.core.plan.ShardedPlan` routes to the sharded
        tier: the entry serves through a bound
        :class:`~repro_torch.sharding.spmv.ShardedPlannedMatrix` (extra
        ``build_kw`` — ``mode``, ``devices``, ``mesh`` — reach its bind).

        Plans carrying ``batch > 1`` seed this key's micro-batch panel
        width (``entry.max_batch``) instead of the service default.

        Every supplied plan is statically linted first
        (:mod:`repro_torch.analyze.planlint`).  ``strict_lint=True`` turns
        lint errors into a raised
        :class:`~repro_torch.analyze.findings.PlanLintError`; by default a
        lint-failing plan is dropped (counted under
        ``service.plan_lint``) and registration rebuilds from scratch —
        note that a non-strict *sharded* plan failing lint therefore
        degrades to an unsharded build.

        Without a supplied plan, a fingerprint-keyed plan cache is
        consulted first — and behind it the persistent ``plan_store``
        (shared across processes): re-registering a matrix whose structure
        matches a previous registration, *anywhere in the fleet*, replays
        the stored plan with zero re-tuning; a fresh build writes its plan
        back.  Hits/misses land in ``stats()['plan_cache']`` /
        ``stats()['plan_store']``.

        ``streaming=True`` marks the key *dynamic* (docs/streaming.md):
        the entry carries a :class:`~repro_torch.stream.drift.DriftSketch`
        and a :class:`~repro_torch.stream.drift.ReplanPolicy` (override
        with ``stream_policy``), and :meth:`apply_delta` may be called to
        mutate the matrix in place.  Sharded plans do not support
        streaming (``ValueError``)."""
        csr.validate()       # malformed input fails here, typed, not as
        #                      garbage inside a kernel (MatrixValidationError)
        dev = resolve_device(self.device)
        plan = self._lint_registered_plan(key, plan, strict_lint)
        if isinstance(plan, ShardedPlan):
            if streaming:
                raise ValueError(
                    "streaming=True is not supported for sharded plans")
            return self._register_sharded(
                key, csr, plan, expected_iterations=expected_iterations,
                measure_baseline=measure_baseline, batch=batch, **build_kw)
        # keep the prior operator serving until the replacement is ready —
        # it is popped and released only at the swap below, so concurrent
        # spmv/spmm/submit against this key never see a registration gap
        prior = self.entries.get(key)
        builds = prior.builds + 1 if prior is not None else 1
        tel = _obs.get()
        cache_key = store_key = None
        if plan is None:
            cache_key = self._plan_cache_key(csr, expected_iterations,
                                             batch, build_kw)
            cached = self._plan_cache.get(cache_key)
            hit = (cached is not None and cached.fingerprint is not None
                   and cached.fingerprint.matches(csr))
            if hit:
                plan = cached
                self._plan_cache_hits += 1
            else:
                self._plan_cache_misses += 1
            if tel.enabled:
                tel.counter("service.plan_cache", key=key, hit=hit).inc()
            if plan is None and self.plan_store is not None:
                # fleet-level fallback behind the in-process cache: a
                # corrupted entry is quarantined inside get() and reads
                # as a miss — never raised to the caller
                store_key = self._store_key(cache_key)
                stored = self.plan_store.get(store_key, fingerprint=csr)
                if stored is not None and not isinstance(stored,
                                                         ShardedPlan):
                    plan = stored
                if tel.enabled:
                    tel.counter("service.plan_store", key=key,
                                hit=plan is not None).inc()
        plan_matched = (plan is not None and plan.fingerprint is not None
                        and plan.fingerprint.matches(csr))
        if tel.enabled and plan is not None:
            tel.counter("service.plan_replay", key=key,
                        hit=plan_matched).inc()
            tel.event("service.plan_replay", key=key, hit=plan_matched)
        t0 = self._now()
        with tel.span("service.register", key=key, n=csr.n_rows,
                      nnz=csr.nnz, batch=batch,
                      plan_matched=plan_matched) as reg_span:
            hyb, report, impls, spmm_impls, tunings, entry_plan, \
                plan_matched = self._build_operator(
                    key, csr, plan, plan_matched, expected_iterations,
                    batch, build_kw, dev, tel)
            fn = _Dispatcher("spmv", impls)
            spmm_fn = _Dispatcher("spmm", spmm_impls)
            source = csr.to(dev)       # uploaded once: the CSR rung's copy
            _sync(source.indptr)
            t_build = self._now() - t0
            reg_span.set(t_build=t_build, n_blocks=hyb.n_blocks)
        t_csr = t_hyb = 0.0
        if measure_baseline:
            x0 = torch.ones((csr.n_cols,), dtype=torch.float32, device=dev)
            t_csr = time_fn(spmv_ref, source, x0, iters=1, warmup=1)
            t_hyb = time_fn(fn, hyb, x0, iters=1, warmup=1)
        entry = MatrixEntry(matrix=hyb, report=report, fn=fn,
                            spmm_fn=spmm_fn, t_build=t_build, device=dev,
                            t_csr=t_csr, t_hybrid=t_hyb, builds=builds,
                            tunings=tunings, plan=entry_plan,
                            from_plan=plan_matched, source=source,
                            max_batch=(plan.batch if plan is not None
                                       and plan.batch > 1 else None))
        entry.guards = self._build_guards(key, entry, fmt="hybrid")
        if streaming:
            self._attach_streaming(entry, csr, expected_iterations,
                                   measure_baseline, batch, stream_policy,
                                   build_kw)
        if cache_key is not None and entry_plan is not None \
                and not plan_matched:
            self._plan_cache[cache_key] = entry_plan
            while len(self._plan_cache) > self.plan_cache_max:
                self._plan_cache.pop(next(iter(self._plan_cache)))
            if self.plan_store is not None:
                # tune once per fleet: publish the freshly minted plan
                if store_key is None:
                    store_key = self._store_key(cache_key)
                try:
                    self.plan_store.put(store_key, entry_plan)
                except OSError as e:
                    # a full/readonly disk must not fail registration —
                    # the plan still serves from memory
                    _swallow("plan_store_put", e)
        self.entries[key] = entry
        if prior is not None:
            # the old operator was valid to the end: serve its queued
            # vectors before releasing it rather than failing their futures
            try:
                self._flush_entry(prior, key=key, cause="reregister")
            except (RuntimeError, ValueError, TypeError,
                    ArithmeticError) as e:
                # the panel's futures already carry the exception; the
                # swallow is accounted, not silent
                _swallow("reregister_flush", e)
            self._release(key, prior)
        return entry

    def _place(self, hyb: Any, dev: torch.device, kernel: bool) -> Any:
        """Move a host-built container to the serving device; at the
        kernel tier also attach what the kernels read beside it
        (``kernels.ops.prepare``: ELL extents, the CSR SpMM kernel's
        choice) — part of the transformation, never of a product."""
        hyb = hyb.to(dev)
        if kernel:
            from ..kernels.ops import prepare
            prepare(hyb)
        return hyb

    def _build_operator(self, key: str, csr: CSR, plan, plan_matched: bool,
                        expected_iterations: int, batch: int,
                        build_kw: Dict[str, Any], dev: torch.device, tel):
        """Materialize-or-build with degrade-don't-die semantics: a plan
        replay or hybrid build whose *transform* fails (``transform.raise``
        fault, or an organic conversion bug) falls back to a single-block
        reference-CSR registration — serving correct results at baseline
        speed beats not serving.  Only the host transform degrades: the
        kernel tier's work (``kernels.ops.prepare``, the tuner's launches)
        runs after it, and a kernel that does not build or launch raises."""
        try:
            if plan_matched:
                host, report = plan.materialize(csr)
                impls, spmm_impls, tunings = self._plan_impls(
                    blocks_by_format(host), plan)
            else:
                host, report = build_hybrid(
                    csr, strategy=self.strategy, db=self.db,
                    model=self.model, policy=self.policy,
                    expected_iterations=expected_iterations,
                    batch=batch, **build_kw)
        except (RuntimeError, ValueError, TypeError, KeyError) as e:
            if tel.enabled:
                tel.counter("service.fallback", key=key, op="register",
                            rung="csr").inc()
                tel.event("service.register_degraded", key=key,
                          error=repr(e))
            csr_plan = ExecutionPlan(
                fmt="csr", rule="degraded", tier="reference",
                batch=max(int(batch), 1),
                expected_iterations=max(int(expected_iterations), 1),
                fingerprint=PlanFingerprint.of(csr))
            host, report = csr_plan.materialize(csr)
            return (self._place(host, dev, kernel=False), report,
                    self.impls, self.spmm_impls, {}, csr_plan, False)
        if plan_matched:
            hyb = self._place(host, dev, kernel=plan.tier == "kernel")
            return (hyb, report, impls, spmm_impls, tunings, plan,
                    plan_matched)
        hyb = self._place(host, dev, kernel=self.tuner is not None)
        impls, spmm_impls, tunings = self._tuned_impls(
            hyb, blocks_by_format(host))
        entry_plan = self._derive_plan(csr, host, report, tunings,
                                       expected_iterations, batch, build_kw)
        return (hyb, report, impls, spmm_impls, tunings, entry_plan,
                plan_matched)

    def _derive_plan(self, csr: CSR, hyb, report, tunings,
                     expected_iterations: int, batch: int,
                     build_kw: Optional[Dict[str, Any]] = None
                     ) -> Optional[ExecutionPlan]:
        """Package a fresh registration as a portable hybrid
        :class:`ExecutionPlan`: the per-block sub-plans minted by
        ``build_hybrid`` plus the tuner's per-format geometry winners.
        Saving it and passing it back to ``register(..., plan=...)`` on
        the same matrix replays the build with zero re-tuning."""
        subs = [d.plan for d in report.decisions]
        if any(s is None for s in subs):
            return None
        tier = "kernel" if self.tuner is not None else "reference"
        for sub in subs:
            sub.tier = tier
            for op, per in tunings.items():
                if sub.fmt in per:
                    sub.geometry[op] = per[sub.fmt]
        blocks = [BlockPlan(rows=d.rows, plan=sub)
                  for d, sub in zip(report.decisions, subs)]
        # record the build kwargs (partitioner knobs, block formats) so a
        # fingerprint-mismatched replay re-partitions under the same
        # recipe the plan was minted with, not the library defaults
        params = {**(build_kw or {}), "strategy": self.strategy,
                  "sort_rows": not hyb.identity_perm}
        fp = PlanFingerprint.of(csr)
        return ExecutionPlan(
            fmt="hybrid", rule=subs[0].rule if subs else "cost_model",
            tier=tier, batch=max(int(batch), 1),
            expected_iterations=max(int(expected_iterations), 1),
            transform=TransformRecipe("hybrid", params),
            fingerprint=fp,
            machine=self.db.machine if self.db is not None else "cost_model",
            d_mat=fp.d_mat, d_star=float("nan"), blocks=blocks)

    # -- plan cache / store --------------------------------------------------
    def _plan_cache_key(self, csr: CSR, expected_iterations: int,
                        batch: int, build_kw: Dict[str, Any]) -> Tuple:
        """Structure + registration knobs: a cached plan only replays for
        a matrix with identical structure registered the same way."""
        fp = PlanFingerprint.of(csr)
        return (fp.n, fp.nnz, fp.sig, int(batch), int(expected_iterations),
                self.strategy,
                tuple(sorted((k, repr(v)) for k, v in build_kw.items())))

    @staticmethod
    def _store_key(cache_key: Tuple) -> str:
        """The plan cache's identity, made process-portable: the tuple is
        ints/strings only, so its repr is stable across interpreters (and
        equals the JAX package's key for the same registration)."""
        return hashlib.sha256(repr(cache_key).encode("utf-8")).hexdigest()

    # -- sharded registration ------------------------------------------------
    def _register_sharded(self, key: str, csr: CSR, plan: ShardedPlan,
                          expected_iterations: int = 100,
                          measure_baseline: bool = True, batch: int = 1,
                          **bind_kw) -> MatrixEntry:
        """The sharded registration path: bind the ShardedPlan (per its
        recorded partition recipe and per-shard plans) on the service's
        device and serve the key through the resulting
        ShardedPlannedMatrix."""
        dev = resolve_device(self.device)
        prior = self.entries.get(key)
        builds = prior.builds + 1 if prior is not None else 1
        matched = plan.matches(csr)
        tel = _obs.get()
        if tel.enabled:
            tel.counter("service.plan_replay", key=key, hit=matched).inc()
            tel.event("service.plan_replay", key=key, hit=matched,
                      sharded=True)
        t0 = self._now()
        with tel.span("service.register", key=key, n=csr.n_rows,
                      nnz=csr.nnz, batch=batch, plan_matched=matched,
                      sharded=True) as reg_span:
            bind_kw.setdefault("device", dev)
            spm = plan.bind(csr, db=self.db, **bind_kw)

            def fn(m, x):
                return m.spmv(x)

            def spmm_fn(m, x):
                return m.spmm(x)

            source = csr.to(spm.device)   # the CSR rung's copy
            _sync(source.indptr)
            t_build = self._now() - t0
            reg_span.set(t_build=t_build, n_blocks=spm.n_shards,
                         mode=spm.mode)
        t_csr = t_hyb = 0.0
        if measure_baseline:
            x0 = torch.ones((csr.n_cols,), dtype=torch.float32,
                            device=spm.device)
            t_csr = time_fn(spmv_ref, source, x0, iters=1, warmup=1)
            t_hyb = time_fn(fn, spm, x0, iters=1, warmup=1)
        entry = MatrixEntry(matrix=spm, report=_ShardedReport(spm), fn=fn,
                            spmm_fn=spmm_fn, t_build=t_build,
                            device=spm.device, t_csr=t_csr, t_hybrid=t_hyb,
                            builds=builds, tunings={}, plan=plan,
                            from_plan=matched, source=source,
                            max_batch=plan.batch if plan.batch > 1
                            else None)
        entry.guards = self._build_guards(key, entry, fmt="sharded",
                                          sharded=True)
        self.entries[key] = entry
        if prior is not None:
            try:
                self._flush_entry(prior, key=key, cause="reregister")
            except (RuntimeError, ValueError, TypeError,
                    ArithmeticError) as e:
                _swallow("reregister_flush", e)
            self._release(key, prior)
        return entry

    # -- streaming (repro_torch.stream) ---------------------------------------
    def _attach_streaming(self, entry: MatrixEntry, csr: CSR,
                          expected_iterations: int, measure_baseline: bool,
                          batch: int, stream_policy: Optional[Any],
                          build_kw: Dict[str, Any]) -> None:
        """Arm a freshly registered entry for :meth:`apply_delta`: an exact
        drift sketch of the matrix as registered, a re-plan policy priced
        against the service's tuning DB, and the registration knobs a
        drift-triggered re-registration must replay."""
        from ..stream.drift import DriftSketch, ReplanPolicy
        entry.streaming = True
        entry.sketch = DriftSketch.of(csr)
        entry.stream_policy = stream_policy if stream_policy is not None \
            else ReplanPolicy(db=self.db, batch=batch,
                              default_k=float(expected_iterations))
        entry.stream_kw = {"expected_iterations": expected_iterations,
                           "measure_baseline": measure_baseline,
                           "batch": batch, **build_kw}

    def apply_delta(self, key: str, delta: Any) -> Any:
        """Absorb one :class:`~repro_torch.stream.delta.DeltaBatch` into a
        ``streaming=True`` key and return the
        :class:`~repro_torch.stream.delta.DeltaApplyResult`.

        The pending micro-batch panel is flushed first (``cause="delta"``)
        so queued futures are served against the matrix they were
        submitted for — deltas serialize with the flush queue.  A
        single-block CSR/SELL operator is updated *incrementally* on the
        service's device (O(Δnnz) tail appends, per-bucket SELL rebuilds)
        and swapped into the entry under its lock — the dispatchers and
        guard ladders read the entry at call time, so no rebind happens
        and the per-``(key, fmt, op)`` circuit breakers keep their state.
        Any other operator shape degrades to a CSR apply plus a full
        re-registration (recorded as a fallback).  After the apply, the
        drift sketch folds in the row-length changes and the policy's
        hysteresis + streaming-amortization rule decides whether the
        paper's threshold now picks a different format; if so the key is
        re-registered under its original knobs (``stream.replan``)."""
        from ..stream.delta import INCREMENTAL_FORMATS
        from ..stream.delta import apply_delta as _apply_delta
        entry = self.entries[key]
        if not entry.streaming:
            raise ValueError(
                f"matrix {key!r} was not registered with streaming=True")
        try:
            self._flush_entry(entry, key=key, cause="delta")
        except (RuntimeError, ValueError, TypeError,
                ArithmeticError) as e:
            # the panel's futures already carry the exception; the delta
            # must still land or the key's state forks from its writers
            _swallow("delta_flush", e)
        hyb = entry.matrix
        leaf = (getattr(hyb, "n_blocks", 0) == 1
                and getattr(hyb, "identity_perm", False)
                and hyb.formats[0] in INCREMENTAL_FORMATS)
        if leaf:
            fmt = hyb.formats[0]
            params: Dict[str, Any] = {}
            if entry.plan is not None and entry.plan.transform is not None:
                params = dict(entry.plan.transform.params or {})
            res = _apply_delta(entry.source, delta,
                               container=hyb.blocks[0], fmt=fmt,
                               transform_params=params, key=key)
            perm = hyb.perm
            if res.csr.n_rows != int(perm.shape[0]):  # rows appended
                perm = torch.arange(res.csr.n_rows, dtype=torch.int32,
                                    device=perm.device)
            new_hyb = hyb.__class__(
                perm=perm, blocks=(res.container,), row_offsets=(0,),
                formats=(fmt,), shape=res.csr.shape, nnz=res.csr.nnz,
                identity_perm=True)
            with entry.lock:
                entry.matrix = new_hyb
                entry.source = res.csr
                entry.deltas += 1
            entry.sketch.update(res)
        else:
            # multi-block (or non-incremental leaf) operators re-partition
            # wholesale: apply to the source CSR, then rebuild the operator
            res = _apply_delta(entry.source, delta, fmt="csr", key=key)
            res.fallback = True
            res.fallback_reason = res.fallback_reason or "nonleaf"
            res.mode = "rebuild"
            # the rebuild re-derives the sketch exactly from the new
            # matrix, so no incremental update on top of it
            entry = self._replan_streaming(key, entry, res.csr,
                                           deltas=entry.deltas + 1)
        pol = entry.stream_policy
        pol.note_update()
        current_fmt = entry.plan.fmt if entry.plan is not None else "csr"
        dec = pol.decide(entry.sketch.d_mat, current_fmt=current_fmt,
                         key=key)
        if dec.replan:
            entry = self._replan_streaming(key, entry, entry.source,
                                           deltas=entry.deltas,
                                           decision=dec)
        entry.last_stream_decision = dec
        return res

    def _replan_streaming(self, key: str, entry: MatrixEntry, csr: CSR,
                          deltas: int, decision: Optional[Any] = None
                          ) -> MatrixEntry:
        """Re-register a streaming key under its original knobs.  The new
        entry inherits the policy (its k̂ estimate and cooldown survive)
        and the delta/replan counters; the sketch is re-derived exactly
        from the post-delta matrix.  Circuit breakers live on the service
        keyed by ``(key, fmt, op)`` and are untouched — a breaker opened
        on the tuned rung stays open across the re-plan."""
        old_policy, old_replans = entry.stream_policy, entry.replans
        old_fmt = entry.plan.fmt if entry.plan is not None else "csr"
        new = self.register(key, csr, streaming=True,
                            stream_policy=old_policy, **entry.stream_kw)
        new.deltas = deltas
        new.replans = old_replans
        if decision is not None:
            new.replans += 1
            old_policy.deltas_since_replan = 0
            tel = _obs.get()
            if tel.enabled:
                tel.counter("stream.replans", key=key).inc()
                tel.event("stream.replan", key=key, old_fmt=old_fmt,
                          new_fmt=new.plan.fmt if new.plan is not None
                          else "csr", d_mat=decision.d_mat,
                          d_star=decision.d_star, k_hat=decision.k_hat,
                          reason=decision.reason)
        return new

    # -- direct paths --------------------------------------------------------
    def _run(self, entry: MatrixEntry, op: str,
             x: torch.Tensor) -> torch.Tensor:
        """One guarded (or raw) operator application, finished on the
        card before it returns."""
        g = entry.guards.get(op)
        if g is not None:
            return _sync(g(x))
        fn = entry.fn if op == "spmv" else entry.spmm_fn
        return _sync(fn(entry.matrix, x))

    def spmv(self, key: str, x: Any) -> torch.Tensor:
        entry = self.entries[key]
        t0 = self._now()
        y = self._run(entry, "spmv", _as_x(x, entry.device))
        dt = self._now() - t0
        with entry.lock:
            entry.n_calls += 1
            entry.t_serve += dt
            if entry.stream_policy is not None:
                entry.stream_policy.note_query()
        tel = _obs.get()
        if tel.enabled:
            tel.histogram("service.query_latency_s", key=key,
                          op="spmv").observe(dt)
        return y

    def spmm(self, key: str, x: Any) -> torch.Tensor:
        """Y = A @ X with X an (n_cols, B) panel — one call, B products."""
        entry = self.entries[key]
        x = _as_x(x, entry.device)
        if x.ndim != 2:
            raise ValueError(f"spmm expects (n_cols, B); got "
                             f"{tuple(x.shape)}")
        t0 = self._now()
        y = self._run(entry, "spmm", x)
        dt = self._now() - t0
        with entry.lock:
            entry.n_spmm_calls += 1
            entry.n_spmm_cols += int(x.shape[1])
            entry.t_serve += dt
            if entry.stream_policy is not None:
                # k̂ counts *products*: a B-wide panel is B queries
                entry.stream_policy.note_query(int(x.shape[1]))
        tel = _obs.get()
        if tel.enabled:
            tel.histogram("service.query_latency_s", key=key,
                          op="spmm").observe(dt)
        return y

    # -- micro-batching queue ------------------------------------------------
    def _admit(self, entry: MatrixEntry, key: str, now: float) -> None:
        """Admission control under ``entry.lock``: bounded depth per the
        configured policy, plus deadline-aware rejection when the
        predicted wait (panels ahead × recent flush latency) already
        exceeds ``deadline_ms``.  Raises :class:`AdmissionError`."""
        tel = _obs.get()
        depth = len(entry.pending)
        limit = self.max_queue
        if limit is not None and depth >= limit:
            if self.admission == "shed_oldest":
                fut, _, t_enq = entry.pending.pop(0)
                entry.shed += 1
                fut.set_exception(AdmissionError(
                    f"request shed after {(now - t_enq) * 1e3:.1f}ms: "
                    f"queue for {key!r} at depth bound {limit}"))
                if tel.enabled:
                    tel.counter("service.admission", key=key,
                                action="shed").inc()
            else:                       # "reject" (and unknown values)
                if tel.enabled:
                    tel.counter("service.admission", key=key,
                                action="reject").inc()
                raise AdmissionError(
                    f"queue for {key!r} is at its depth bound "
                    f"({limit}); retry later or flush")
        if self.deadline_ms is not None and entry.flush_ema_s > 0.0:
            panel = entry.max_batch or self.max_batch
            panels_ahead = len(entry.pending) // max(panel, 1) + 1
            predicted_ms = panels_ahead * entry.flush_ema_s * 1e3
            if predicted_ms > self.deadline_ms:
                if tel.enabled:
                    tel.counter("service.admission", key=key,
                                action="deadline").inc()
                raise AdmissionError(
                    f"predicted wait {predicted_ms:.1f}ms exceeds the "
                    f"{self.deadline_ms}ms deadline for {key!r}")

    def submit(self, key: str, x: Any) -> "Future":
        """Enqueue one SpMV; resolved by ``flush`` (auto at ``max_batch``,
        or as soon as the oldest pending future is past ``deadline_ms``)
        through a single SpMM call per matrix.  The service keeps its own
        copy of ``x``: editing ``x`` after ``submit`` does not change the
        answer.

        With ``max_queue`` set, a full queue is handled per the
        ``admission`` policy: ``reject`` raises :class:`AdmissionError`,
        ``shed_oldest`` fails the oldest pending future to make room,
        ``block`` flushes synchronously until there is room."""
        entry = self.entries[key]
        x = _as_x(x, entry.device, copy=True)
        if tuple(x.shape) != (entry.matrix.n_cols,):
            # reject here so one bad vector can never poison a whole panel
            raise ValueError(f"expected x of shape ({entry.matrix.n_cols},); "
                             f"got {tuple(x.shape)}")
        if self.max_queue is not None and self.admission == "block":
            # make room by serving, not by waiting: each flush drains the
            # queue entirely, so one pass always admits
            while True:
                with entry.lock:
                    if entry.dead:
                        raise EvictedError(f"matrix {key!r} was evicted")
                    if len(entry.pending) < self.max_queue:
                        break
                tel = _obs.get()
                if tel.enabled:
                    tel.counter("service.admission", key=key,
                                action="block").inc()
                self._flush_entry(entry, key=key, cause="admission")
        fut: Future = Future()
        now = self._now()
        with entry.lock:
            if entry.dead:
                # racing evict/re-register: never enqueue onto a released
                # entry — nothing would ever flush it
                raise EvictedError(f"matrix {key!r} was evicted")
            self._admit(entry, key, now)
            entry.pending.append((fut, x, now))
            depth = len(entry.pending)
            full = depth >= (entry.max_batch or self.max_batch)
            overdue = (self.deadline_ms is not None and
                       (now - entry.pending[0][2]) * 1e3 >= self.deadline_ms)
        tel = _obs.get()
        if tel.enabled:
            tel.gauge("service.queue_depth", key=key).set(depth)
        if full or overdue:
            self._flush_entry(entry, key=key,
                              cause="max_batch" if full else "deadline")
        return fut

    def poll(self) -> int:
        """Deadline sweep for serving loops: flush every matrix whose
        oldest pending future has waited past ``deadline_ms``.  Returns the
        number of vectors served (0 when no deadline is configured)."""
        if self.deadline_ms is None:
            return 0
        now = self._now()
        served = 0
        for k in list(self.entries):
            e = self.entries.get(k)
            if e is None:
                continue
            with e.lock:
                due = bool(e.pending) and \
                    (now - e.pending[0][2]) * 1e3 >= self.deadline_ms
            if due:
                served += self._flush_entry(e, key=k, cause="deadline")
        return served

    def flush(self, key: Optional[str] = None) -> int:
        """Serve all pending vectors (of ``key``, or every matrix) in one
        SpMM per matrix.  Returns the number of vectors served — the last
        micro-batch may be ragged (fewer than ``max_batch`` columns)."""
        if key is not None:
            entries = [(key, self.entries[key])]
        else:  # tolerate evictions racing the snapshot
            entries = [(k, e) for k in list(self.entries)
                       if (e := self.entries.get(k)) is not None]
        served, first_err = 0, None
        for k, e in entries:
            try:
                served += self._flush_entry(e, key=k, cause="explicit")
            except Exception as err:
                # that panel's futures already carry the exception; keep
                # serving the other matrices and re-raise at the end
                if first_err is None:
                    first_err = err
        if first_err is not None:
            raise first_err
        return served

    def pending_count(self, key: str) -> int:
        return len(self.entries[key].pending)

    def _flush_entry(self, entry: MatrixEntry, key: str = "",
                     cause: str = "explicit") -> int:
        with entry.lock:
            batch, entry.pending = entry.pending, []
        if not batch:
            return 0
        b = len(batch)
        tel = _obs.get()
        with tel.span("service.flush", key=key, cause=cause, batch=b):
            try:
                xs = [x for _, x, _ in batch]
                panel = entry.max_batch or self.max_batch
                if self.pad_batches and b < panel:
                    xs += [xs[0].new_zeros(xs[0].shape)] * (panel - b)
                X = torch.stack(xs, dim=1)          # (n, panel): one copy
                t0 = self._now()
                Y = self._run(entry, "spmm", X)
                # each future gets its own tensor: the panel's columns in
                # one fresh row-major copy whose rows do not overlap
                results = Y[:, :b].t().contiguous().unbind(0)
            except Exception as e:
                # never strand a future: the whole panel fails together
                for fut, _, _ in batch:
                    fut.set_exception(e)
                raise
            dt = self._now() - t0
        if tel.enabled:
            tel.counter("service.flush", key=key, cause=cause).inc()
            tel.gauge("service.queue_depth", key=key).set(0)
            tel.histogram("service.flush_latency_s", key=key).observe(dt)
            tel.event("service.flush", key=key, cause=cause, batch=b,
                      t_spmm=dt)
        with entry.lock:
            entry.n_spmm_calls += 1
            entry.n_spmm_cols += b
            entry.t_serve += dt
            if entry.stream_policy is not None:
                entry.stream_policy.note_query(b)
            # the admission controller's wait predictor: a slow-moving EMA
            # of flush latency (zero-cost under FakeClock — dt stays 0)
            entry.flush_ema_s = (dt if entry.flush_ema_s == 0.0
                                 else 0.3 * dt + 0.7 * entry.flush_ema_s)
        for (fut, _, _), y in zip(batch, results):
            fut.set_result(y)
        return b

    # -- lifecycle -----------------------------------------------------------
    def evict(self, key: str) -> None:
        """Drop a matrix and release its dispatchers."""
        entry = self.entries.pop(key, None)
        if entry is not None:
            self._release(key, entry)

    def _release(self, key: str, entry: MatrixEntry) -> None:
        with entry.lock:
            entry.dead = True
            stranded, entry.pending = entry.pending, []
        if stranded:
            tel = _obs.get()
            if tel.enabled:
                tel.counter("service.evicted_futures", key=key).inc(
                    len(stranded))
        for fut, _, _ in stranded:
            fut.set_exception(EvictedError(
                f"matrix {key!r} evicted with requests pending"))
        for fn in (entry.fn, entry.spmm_fn):
            clear = getattr(fn, "clear_cache", None)
            if callable(clear):
                clear()
        # drop the dispatchers (and the device copy of the source) so the
        # memory is collectable even if a caller keeps the MatrixEntry alive
        entry.fn = entry.spmm_fn = _evicted
        entry.guards = {}
        entry.source = None

    def _entry_telemetry(self, key: str) -> Dict[str, Any]:
        """This key's slice of the process telemetry (query-latency
        summaries, flush-cause counts, queue depth, plan-replay hits);
        empty when telemetry is disabled."""
        tel = _obs.get()
        if not tel.enabled:
            return {}
        out: Dict[str, Any] = {}
        for kind, name, labels, m in tel.metrics():
            if labels.get("key") != key:
                continue
            rest = {k: v for k, v in labels.items() if k != "key"}
            mkey = _obs.format_metric(name, rest)
            out[mkey] = m.summary() if kind == "histogram" else m.value
        return out

    def stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-matrix observability: block formats, build/serve time,
        served-signature counts, micro-batch throughput, guard/breaker
        health, and amortization — the paper's k*B*(t_crs - t_f) > t_trans
        with k*B the products served so far (None when the baseline was
        not measured).  With telemetry enabled each entry also carries its
        ``"telemetry"`` slice.  ``"guard"`` maps op → ladder snapshot
        (per-rung serve counts, failures, breaker state machine)."""
        out = {}
        for key, e in self.entries.items():
            products = e.n_calls + e.n_spmm_cols
            saved = (products * (e.t_csr - e.t_hybrid)
                     if e.t_csr > 0 else None)
            nb = getattr(e.matrix, "nbytes", None)
            out[key] = {
                "n_blocks": e.matrix.n_blocks,
                "formats": e.formats(),
                "bytes": int(nb()) if callable(nb) else memory_bytes(
                    e.matrix),
                "device": str(e.device),
                "t_build_s": e.t_build,
                "n_calls": e.n_calls,
                "n_spmm_calls": e.n_spmm_calls,
                "n_spmm_cols": e.n_spmm_cols,
                "pending": len(e.pending),
                "shed": e.shed,
                "builds": e.builds,
                "compiled": e.compile_count(),
                "tuned": {op: {f: g.to_dict() for f, g in per.items()}
                          for op, per in e.tunings.items() if per},
                "plan": (None if e.plan is None else {
                    # ShardedPlan carries axis/strategy instead of
                    # rule/tier/machine — surface whichever it has
                    "rule": getattr(e.plan, "rule", None),
                    "tier": getattr(e.plan, "tier", None),
                    "machine": getattr(e.plan, "machine", None),
                    "axis": getattr(e.plan, "axis", None),
                    "strategy": getattr(e.plan, "strategy", None),
                    "n_shards": getattr(e.plan, "n_shards", None),
                    "schema_version": e.plan.schema_version,
                    "batch": e.plan.batch,
                    "from_plan": e.from_plan,   # registration replayed one
                }),
                "guard": {op: g.snapshot() for op, g in e.guards.items()},
                "t_serve_s": e.t_serve,
                "amortized": (None if saved is None
                              else saved >= e.t_build),
                "telemetry": self._entry_telemetry(key),
            }
            if e.streaming:
                out[key]["streaming"] = {
                    "deltas": e.deltas,
                    "replans": e.replans,
                    "d_mat": e.sketch.d_mat if e.sketch is not None
                    else None,
                    "k_hat": (e.stream_policy.k_hat
                              if e.stream_policy is not None else None),
                    "last_decision": (e.last_stream_decision.reason
                                      if e.last_stream_decision is not None
                                      else None),
                }
        # reserved keys (no matrix may register under them): service-wide
        # plan-cache / plan-store / breaker health — consumers index
        # stats() by matrix key
        out["plan_cache"] = {"size": len(self._plan_cache),
                             "hits": self._plan_cache_hits,
                             "misses": self._plan_cache_misses}
        if self.plan_store is not None:
            out["plan_store"] = self.plan_store.stats()
        if self._breakers:
            out["breakers"] = {
                "/".join(bk): br.snapshot()
                for bk, br in self._breakers.items()}
        return out


class _ShardedReport:
    """HybridReport-shaped shim for sharded entries: format counts over
    the per-shard plans, per-shard decision dicts as ``decisions``."""

    def __init__(self, spm: Any):
        self.decisions = spm.report()
        self._formats = spm.plan.shard_formats()

    def format_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for f in self._formats:
            counts[f] = counts.get(f, 0) + 1
        return counts


def _evicted(m, x):
    raise EvictedError("this matrix entry was evicted; re-register it")


__all__ = ["SpMVService", "MatrixEntry", "AdmissionError", "EvictedError"]
