"""The paper's auto-tuning method: off-line D_mat–R graph, on-line decision.

Definitions (paper §2.2):
    SP_f   = t_crs / t_f            (eq. 1 — SpMV speedup of format f)
    TT_f   = t_trans_f / t_crs      (eq. 2*)
    R_f    = SP_f / TT_f            (eq. 3)
    D_mat  = sigma / mu             (eq. 4 — nnz-per-row coeff. of variation)

(*) The paper prints eq. (2) as ``t_crs / t_trans`` but its own worked
example ("cost of 1.0 ... 10x speedup ... if and only if the transformation
time to SpMV in CRS is 10") and Fig. 7 ("overheads ... 0.01x-0.51x", low =
cheap) require ``TT = t_trans / t_crs``.  We implement the self-consistent
version and note the typo here.

Off-line phase: run the benchmark suite on this machine, record
(D_mat^i, R_f^i) per matrix and format, and set per format
``D*_f = max { D_mat^i : R_f^i >= c }`` (c = 1.0 by default).

On-line phase: compute D_mat of the input (cheap — one pass over IRP) and
transform to the best format iff ``D_mat < D*``.

Beyond the paper (flagged ``generalized``):
  * multi-format selection (argmin of predicted total time) instead of the
    binary ELL-vs-CRS rule;
  * amortization over an expected iteration count k —
    transform iff  k (t_crs - t_f) > t_trans_f  (the paper's c generalizes
    to c = 1/k in its own cost algebra);
  * a measurement-free roofline cost model to pre-seed decisions on a new
    machine before any off-line data exists.

Timing: on a CUDA device :func:`time_fn` brackets the launches with CUDA
events; PyTorch runs eagerly, so there is no compile step to exclude beyond
the warm-up (which also builds a kernel at its first use).
"""
from __future__ import annotations

import functools
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..device import DeviceLike, resolve_device
from .formats import CSR, MatrixStats, memory_bytes
from .spmv import spmm, spmv
from .transform import TRANSFORMS_HOST

DEFAULT_FORMATS = ("ell_row", "ell_col", "coo_row", "coo_col", "sell",
                   "hybrid")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def _device_of(args) -> torch.device:
    for a in args:
        dev = getattr(a, "device", None)
        if isinstance(dev, torch.device):
            return dev
    return torch.device("cpu")


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 2) -> float:
    """Seconds per call of ``fn(*args)``.

    On a CUDA device (the device of the first argument that has one): warm up, synchronize, then one pair of CUDA events around
    ``iters`` back-to-back launches — the mean device time per call.  On the
    CPU: best-of-``iters`` ``perf_counter`` wall time, no synchronize."""
    dev = _device_of(args)
    for _ in range(warmup):
        fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) * 1e-3 / max(iters, 1)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best


#: cycles the card spins before a timed call (~0.5 ms on an H100), so that
#: the host has enqueued the call by the time the start event fires and the
#: events bracket device work, not the host's launch path
HEAD_START_CYCLES = 1_000_000
#: the longest spin :func:`time_device` grows to (~65 ms on an H100)
MAX_HEAD_START_CYCLES = 128 * HEAD_START_CYCLES


def time_device(thunk: Callable[[], Any],
                before: Optional[Callable[[], Any]] = None) -> float:
    """Device seconds of one call of ``thunk`` on the current CUDA device's
    current stream.

    The card first spins (``torch.cuda._sleep``) so that the host has
    enqueued the call before the start event fires: the events then bracket
    device work only, however many host operations the call enqueues.
    If the start event has already fired when the host is done enqueuing,
    the spin was too short and the host's pace leaked into the time; the
    measurement is then repeated with twice the spin, up to
    ``MAX_HEAD_START_CYCLES``.  ``before`` runs ahead of the spin on every
    attempt (for example to flush the L2)."""
    spin = HEAD_START_CYCLES
    while True:
        if before is not None:
            before()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        thunk()
        late = start.query()
        end.record()
        end.synchronize()
        if not late or spin >= MAX_HEAD_START_CYCLES:
            return start.elapsed_time(end) * 1e-3
        spin *= 2


def time_host(fn: Callable, *args, iters: int = 3) -> float:
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best


def _prepare(obj: Any) -> Any:
    """``kernels.ops.prepare``: what the kernels read beside a container."""
    from ..kernels.ops import prepare
    return prepare(obj)


def time_prepare(obj: Any) -> float:
    """Seconds of ``kernels.ops.prepare(obj)`` on ``obj``'s device, host
    clock around a call that ends in a synchronize (a CUDA device's work
    included)."""
    dev = obj.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _prepare(obj)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------
@dataclass
class FormatMeasurement:
    t_spmv: float      # seconds per SpMV in this format
    t_trans: float     # seconds for CRS -> format transformation
    sp: float          # t_crs / t_spmv
    tt: float          # t_trans / t_crs
    r: float           # sp / tt
    mem_ratio: float   # bytes(format) / bytes(csr)


@dataclass
class OfflineRecord:
    name: str
    n: int
    nnz: int
    mu: float
    sigma: float
    d_mat: float
    t_crs: float
    batch: int = 1     # right-hand sides per timed call (1 = SpMV, B = SpMM)
    formats: Dict[str, FormatMeasurement] = field(default_factory=dict)


@dataclass
class TuningDB:
    """The machine-specific product of the off-line phase.

    ``geometries`` holds the kernel launch-geometry winners recorded by
    a launch-geometry tuner (``GeometryRecord`` rows) — persisted alongside the
    ``OfflineRecord``\\s so one file ships both halves of the auto-tuning
    state (format thresholds *and* launch geometry)."""
    machine: str
    c: float
    records: List[OfflineRecord]
    d_star: Dict[str, float]          # per format
    geometries: List = field(default_factory=list)  # GeometryRecord

    # -- persistence ---------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "machine": self.machine, "c": self.c,
            "d_star": self.d_star,
            "records": [
                {**{k: v for k, v in asdict(r).items() if k != "formats"},
                 "formats": {f: asdict(m) for f, m in r.formats.items()}}
                for r in self.records
            ],
            "geometries": [g.to_dict() for g in self.geometries],
        }, indent=1)

    @staticmethod
    def from_json(s: str) -> "TuningDB":
        from .kernel_tune import GeometryRecord
        obj = json.loads(s)
        recs = []
        for r in obj["records"]:
            fmts = {f: FormatMeasurement(**m) for f, m in r.pop("formats").items()}
            recs.append(OfflineRecord(**r, formats=fmts))
        geoms = [GeometryRecord.from_dict(g)
                 for g in obj.get("geometries", [])]
        return TuningDB(machine=obj["machine"], c=obj["c"], records=recs,
                        d_star=obj["d_star"], geometries=geoms)

    # -- tuned launch geometry ----------------------------------------------
    def best_geometry(self, fmt: str, d_mat: float, op: str = "spmv",
                      batch: Optional[int] = None):
        """Nearest recorded launch-geometry winner for an unseen matrix
        (D_mat-keyed, preferring batch-matched records); None if nothing
        was recorded for (fmt, op)."""
        from .kernel_tune import nearest_geometry
        return nearest_geometry(self.geometries, fmt, op, d_mat=d_mat,
                                batch=batch)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "TuningDB":
        with open(path) as f:
            return TuningDB.from_json(f.read())

    # -- the D_mat–R graph ----------------------------------------------------
    def graph(self, fmt: str) -> List[Tuple[float, float]]:
        """(D_mat^i, R_f^i) points, sorted by D_mat — the paper's Fig. 8."""
        pts = [(r.d_mat, r.formats[fmt].r) for r in self.records
               if fmt in r.formats]
        return sorted(pts)

    def predict(self, fmt: str, d_mat: float,
                batch: Optional[int] = None) -> Dict[str, float]:
        """Nearest-neighbours (in log D) prediction of (sp, tt) for a new
        matrix — the generalized on-line model.

        ``batch``: prefer records measured at the same RHS count (SpMM
        measurements).  When none exist, fall back to all records and
        rescale each record's ``tt`` from its own measured batch to the
        queried one (``tt`` is relative to one t_crs *call*, so a call B
        products wide carries t_trans / B per unit batch); the result is
        reported with ``batch_matched=False`` but its ``tt`` is already in
        per-``batch``-call units either way."""
        recs = [r for r in self.records if fmt in r.formats]
        matched = True
        if batch is not None and recs:
            exact = [r for r in recs if r.batch == batch]
            matched = bool(exact)
            recs = exact or recs
        if not recs:
            return {"sp": 1.0, "tt": float("inf"), "batch_matched": False}

        def tt_of(r: OfflineRecord) -> float:
            tt = r.formats[fmt].tt
            if batch is not None and not matched:
                tt *= r.batch / max(batch, 1)
            return tt

        d = np.array([max(r.d_mat, 1e-9) for r in recs])
        w = 1.0 / (1e-9 + np.abs(np.log(d) - np.log(max(d_mat, 1e-9))))
        w /= w.sum()
        sp = float(sum(wi * r.formats[fmt].sp for wi, r in zip(w, recs)))
        tt = float(sum(wi * tt_of(r) for wi, r in zip(w, recs)))
        return {"sp": sp, "tt": tt, "batch_matched": matched}


# ---------------------------------------------------------------------------
# off-line phase
# ---------------------------------------------------------------------------
def offline_phase(
    suite: Sequence[Tuple[str, CSR]],
    formats: Sequence[str] = DEFAULT_FORMATS,
    c: float = 1.0,
    machine: str = "cpu",
    spmv_impls: Optional[Dict[str, Callable]] = None,
    iters: int = 5,
    make_x: Optional[Callable[[CSR], torch.Tensor]] = None,
    batch: int = 1,
    spmm_impls: Optional[Dict[str, Callable]] = None,
    tuner: Optional[Any] = None,
    device: DeviceLike = None,
    trans_iters: int = 3,
) -> TuningDB:
    """Measure the suite, build the D_mat–R graph, learn D* per format.

    ``spmv_impls`` maps format name -> callable(fmt_obj, x); defaults to the
    pure-torch references (the CUDA kernels are plugged in by the caller —
    e.g. ``repro_torch.kernels.ops.KERNEL_SPMV_IMPLS``).

    ``device``: where SpMV is timed (``None`` = the CUDA device).  Each
    matrix is transformed on the host — ``t_trans`` is the host recipe's
    time, as in the reference, plus, for a format whose impl is overridden
    (the kernel tier), the time of ``kernels.ops.prepare`` on ``device``
    (ELL extents) — and moved to ``device`` before it is timed.  With the
    kernel tier's CSR impl the source itself is prepared (the choice of its
    SpMM kernel) before ``t_crs`` is timed.

    ``batch``: number of right-hand sides per timed call.  ``batch > 1``
    times the SpMM path with an ``(n_cols, batch)`` panel instead of SpMV,
    so the resulting D_mat–R graph (and the D* thresholds learned from it)
    reflect that one transformation is amortized over ``k * batch``
    products.  Records carry the batch they were measured at.  With
    ``batch > 1`` overrides come from ``spmm_impls`` (callables taking the
    panel); ``spmv_impls`` is SpMV-only and is ignored then.

    ``tuner``: any object with ``.tune(fmt_obj, op=, batch=, impl=, x=,
    stats=)`` returning a record with ``.geometry``, and ``.records``.  When
    given (with kernel impls), every format whose impl was overridden is
    launch-geometry-tuned on each matrix *before* it is timed, and the
    tuner's winners ship in the returned db's ``geometries``.

    ``trans_iters``: host transforms ``t_trans`` is the best of (the
    reference's 3; a caller that has measured the same transforms already
    may take fewer).
    """
    dev = resolve_device(device)
    batch = max(int(batch), 1)
    if batch > 1 and spmv_impls and not spmm_impls:
        raise ValueError(
            "offline_phase(batch > 1) times the SpMM path; pass the panel "
            "callables via spmm_impls (spmv_impls is SpMV-only)")
    default_op = spmv if batch == 1 else spmm
    op_name = "spmv" if batch == 1 else "spmm"
    impls = (spmv_impls if batch == 1 else spmm_impls) or {}

    def tuned(fn, fmt_obj, stats, x):
        """Bind the per-matrix tuned launch geometry onto an overridden
        kernel impl (reference impls take no geometry and pass through)."""
        if tuner is None:
            return fn
        try:
            rec = tuner.tune(fmt_obj, op=op_name, batch=batch, impl=fn,
                             x=x, stats=stats)
        except (KeyError, TypeError):
            return fn
        return functools.partial(fn, tuning=rec.geometry)

    tel = _obs.get()
    records: List[OfflineRecord] = []
    for name, csr in suite:
        stats = MatrixStats.of(csr)
        if make_x is not None:
            x = make_x(csr).to(dev)
        elif batch == 1:
            x = torch.ones(csr.n_cols, dtype=torch.float32, device=dev)
        else:
            x = torch.ones((csr.n_cols, batch), dtype=torch.float32,
                           device=dev)
        with tel.span("offline.matrix", matrix=name, n=stats.n,
                      nnz=stats.nnz, d_mat=stats.d_mat, batch=batch):
            csr_dev = csr.to(dev)
            csr_fn = impls.get("csr", default_op)
            if "csr" in impls:
                # the source's own set-up (no transformation): what picks
                # its SpMM kernel, as a bound CSR plan has it
                _prepare(csr_dev)
                csr_fn = tuned(csr_fn, csr_dev, stats, x)
            t_crs = time_fn(csr_fn, csr_dev, x, iters=iters)
            if tel.enabled:
                tel.histogram("offline.t_crs_s").observe(t_crs)
            rec = OfflineRecord(name=name, n=stats.n, nnz=stats.nnz,
                                mu=stats.mu, sigma=stats.sigma,
                                d_mat=stats.d_mat, t_crs=t_crs, batch=batch)
            base_mem = memory_bytes(csr)
            for f in formats:
                trans = TRANSFORMS_HOST[f]
                t_trans = time_host(trans, csr, iters=trans_iters)
                fmt_obj = trans(csr).to(dev)
                f_fn = impls.get(f, default_op)
                if f in impls:
                    # what the kernels read beside the container (ELL
                    # extents) is part of the transformation's time
                    t_trans += time_prepare(fmt_obj)
                    f_fn = tuned(f_fn, fmt_obj, stats, x)
                t_f = time_fn(f_fn, fmt_obj, x, iters=iters)
                sp = t_crs / t_f
                tt = t_trans / t_crs
                rec.formats[f] = FormatMeasurement(
                    t_spmv=t_f, t_trans=t_trans, sp=sp, tt=tt,
                    r=sp / tt if tt > 0 else float("inf"),
                    mem_ratio=memory_bytes(fmt_obj) / base_mem,
                )
                if tel.enabled:
                    tel.histogram("offline.t_trans_s", fmt=f).observe(t_trans)
                    tel.histogram("offline.t_spmv_s", fmt=f).observe(t_f)
                    tel.event("offline.measure", matrix=name, fmt=f,
                              batch=batch, d_mat=stats.d_mat, t_crs=t_crs,
                              t_f=t_f, t_trans=t_trans, sp=sp, tt=tt,
                              r=rec.formats[f].r)
        records.append(rec)

    d_star = {}
    for f in formats:
        qual = [r.d_mat for r in records
                if f in r.formats and r.formats[f].r >= c]
        d_star[f] = max(qual) if qual else 0.0
    return TuningDB(machine=machine, c=c, records=records, d_star=d_star,
                    geometries=list(tuner.records) if tuner is not None
                    else [])


# ---------------------------------------------------------------------------
# on-line phase
# ---------------------------------------------------------------------------
@dataclass
class Decision:
    fmt: str                  # chosen format ("csr" = stay)
    d_mat: float
    d_star: float
    rule: str                 # "paper" | "generalized" | "cost_model"
    expected_gain: float = 0.0  # predicted fraction of time saved


def _emit_decision(dec: Decision, **extra: Any) -> Decision:
    """Record an on-line decision as a ``plan.decision`` event + counter —
    every rule firing becomes a replayable point on the D_mat–R graph."""
    tel = _obs.get()
    if tel.enabled:
        tel.counter("plan.decisions", rule=dec.rule, fmt=dec.fmt).inc()
        tel.event("plan.decision", rule=dec.rule, fmt=dec.fmt,
                  d_mat=dec.d_mat, d_star=dec.d_star,
                  expected_gain=dec.expected_gain, **extra)
    return dec


def decide_paper(db: TuningDB, stats: MatrixStats, fmt: str = "ell_row") -> Decision:
    """The paper's on-line rule: transform iff D_mat < D*."""
    ds = db.d_star.get(fmt, 0.0)
    chosen = fmt if stats.d_mat < ds else "csr"
    return _emit_decision(Decision(fmt=chosen, d_mat=stats.d_mat, d_star=ds,
                                   rule="paper"))


def decide_generalized(db: TuningDB, stats: MatrixStats,
                       expected_iterations: int = 100,
                       formats: Optional[Sequence[str]] = None,
                       memory_budget_ratio: float = float("inf"),
                       batch: int = 1) -> Decision:
    """Beyond-paper: pick argmin over formats of predicted total time for k
    iterations, k*t_f + t_trans_f, subject to a memory budget (paper §2.2's
    'auto-tuning policy' drawback).

    ``batch``: right-hand sides per call.  Each call carries B products, so
    a transformation paid once is amortized over ``k * B`` of them — the
    rule becomes ``k * B * (t_crs - t_f) > t_trans``.  ``predict`` hands
    back tt already rescaled to per-B-call units (preferring records
    measured at this batch, else rescaling by each record's own batch)."""
    k = max(expected_iterations, 1)
    b = max(batch, 1)
    best_fmt, best_cost, best_ds = "csr", float(k), 0.0  # unit: t_crs/call
    for f in formats or db.d_star.keys():
        pred = db.predict(f, stats.d_mat, batch=b)
        recs = [r.formats[f].mem_ratio for r in db.records if f in r.formats]
        if recs and float(np.median(recs)) > memory_budget_ratio:
            continue
        cost = k / max(pred["sp"], 1e-9) + pred["tt"]
        if cost < best_cost:
            best_fmt, best_cost, best_ds = f, cost, db.d_star.get(f, 0.0)
    return _emit_decision(
        Decision(fmt=best_fmt, d_mat=stats.d_mat, d_star=best_ds,
                 rule="generalized",
                 expected_gain=1.0 - best_cost / float(k)),
        expected_iterations=k, batch=b)


# ---------------------------------------------------------------------------
# measurement-free roofline cost model (beyond paper)
# ---------------------------------------------------------------------------
#: H100 SXM data-sheet device-memory rate, bytes/s.  A model assumption, not
#: a measurement of this package.
H100_STREAM_BW = 3.35e12


@dataclass
class MachineModel:
    """Bandwidth model used to pre-seed decisions on a new machine.

    The defaults are *assumptions*, not measurements: ``stream_bw`` is the
    H100 SXM data-sheet rate and ``gather_bw`` an eighth of it (a random
    4-byte gather uses a fraction of every 32-byte sector it touches).
    ``segment_penalty`` models the segmented-reduction inefficiency of
    CSR/COO on wide-SIMD hardware: the effective vector length is the row
    length (~mu, tiny), while ELL reduces dense (rows, width) panels at full
    width — the mechanism behind the paper's 151x ES2 result."""
    stream_bw: float = H100_STREAM_BW      # bytes/s contiguous (assumed)
    gather_bw: float = H100_STREAM_BW / 8  # bytes/s random-gather (assumed)
    val_bytes: int = 4
    idx_bytes: int = 4
    segment_penalty: float = 3.0  # CSR/COO segmented-reduce inefficiency

    def t_spmv(self, fmt: str, stats: MatrixStats,
               width: Optional[int] = None, batch: int = 1) -> float:
        """Seconds per call.  ``batch`` B > 1 models an SpMM call carrying an
        (n_cols, B) panel: the matrix stream is paid once per call while the
        x gathers (and output writes, folded into the same term) scale with
        B — which is exactly why SpMM amortizes better than B SpMVs."""
        b = max(batch, 1)
        n, nnz = stats.n, stats.nnz
        if fmt == "csr" or fmt.startswith("coo"):
            stream = nnz * (self.val_bytes + self.idx_bytes) + n * self.idx_bytes
            gather = nnz * self.val_bytes            # x[] gathers
            return self.segment_penalty * (
                stream / self.stream_bw + b * gather / self.gather_bw)
        if fmt.startswith("ell") or fmt == "sell":
            w = width if width is not None else int(round(stats.mu + 3 * stats.sigma)) or 1
            if fmt == "sell":
                w = int(round(stats.mu)) or 1        # sigma-sort removes most pad
            padded = n * w
            stream = padded * (self.val_bytes + self.idx_bytes)
            gather = padded * self.val_bytes
            return stream / self.stream_bw + b * gather / self.gather_bw
        if fmt == "hybrid":
            # per-block tuning keeps regular blocks at SELL-like width ~mu
            # and drops the heavy tail into CSR/COO; model as SELL plus a
            # small per-block dispatch/reassembly overhead
            return 1.05 * self.t_spmv("sell", stats, batch=b)
        raise KeyError(fmt)

    def t_trans(self, fmt: str, stats: MatrixStats) -> float:
        # transformation streams CSR once and writes the new format once
        # (independent of how many RHS later ride on the result)
        return 2.0 * self.t_spmv(fmt, stats, batch=1)


def decide_cost_model(model: MachineModel, stats: MatrixStats,
                      expected_iterations: int = 100,
                      formats: Sequence[str] = ("ell_row", "sell"),
                      batch: int = 1) -> Decision:
    k = max(expected_iterations, 1)
    b = max(batch, 1)
    t_crs = model.t_spmv("csr", stats, batch=b)
    best_fmt, best_cost = "csr", k * t_crs
    for f in formats:
        cost = k * model.t_spmv(f, stats, batch=b) + model.t_trans(f, stats)
        if cost < best_cost:
            best_fmt, best_cost = f, cost
    return _emit_decision(
        Decision(fmt=best_fmt, d_mat=stats.d_mat, d_star=float("nan"),
                 rule="cost_model",
                 expected_gain=1.0 - best_cost / (k * t_crs)),
        expected_iterations=k, batch=b)


# ---------------------------------------------------------------------------
# the user-facing auto-tuned operator — deprecated shim over the Planner
# ---------------------------------------------------------------------------
class AutoTunedSpMV:
    """Deprecated: use :class:`repro_torch.Planner` /
    :class:`repro_torch.ExecutionPlan`.

    This wrapper predates the unified plan API.  It routes through
    :class:`~repro_torch.core.plan.Planner`, so it picks up the tuned
    ``TileGeometry`` (when the TuningDB carries recorded geometries, or a
    ``tuner`` is passed) and serves SpMM panels through the same
    ``__call__`` — but new code should hold the :class:`ExecutionPlan`
    directly::

        plan = Planner(db=db).plan(csr)     # portable, serializable
        P = plan.bind(csr)
        y = P @ x                           # SpMV; P @ X serves SpMM

    ``device``: where the matrix is bound (``None`` = the CUDA device)."""

    def __init__(self, csr: CSR, db: Optional[TuningDB] = None,
                 expected_iterations: int = 100,
                 rule: str = "paper",
                 machine_model: Optional[MachineModel] = None,
                 spmv_impls: Optional[Dict[str, Callable]] = None,
                 tuner: Optional[Any] = None,
                 device: DeviceLike = None):
        import warnings
        warnings.warn(
            "AutoTunedSpMV is deprecated; use repro_torch.Planner — "
            "plan = Planner(db=db).plan(csr); y = plan.bind(csr) @ x",
            DeprecationWarning, stacklevel=2)
        from .plan import Planner
        if db is None:
            rule_eff = "cost_model"
        elif rule == "paper":
            rule_eff = "paper"
        else:
            rule_eff = "generalized"
        planner = Planner(db=db, model=machine_model, tuner=tuner,
                          rule=rule_eff, device=device)
        self.plan = planner.plan(csr, expected_iterations=expected_iterations)
        self.bound = self.plan.bind(csr, db=db, impls=spmv_impls,
                                    device=device)
        self.csr = csr
        self.stats = MatrixStats.of(csr)
        self.decision = Decision(fmt=self.plan.fmt, d_mat=self.plan.d_mat,
                                 d_star=self.plan.d_star,
                                 rule=self.plan.rule,
                                 expected_gain=self.plan.expected_gain)
        self.matrix = self.bound.matrix

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        # rank dispatch: 1-D x serves SpMV, (n_cols, B) panels serve SpMM
        return self.bound @ x


__all__ = [
    "DEFAULT_FORMATS", "time_fn", "time_host", "time_prepare",
    "FormatMeasurement", "OfflineRecord", "TuningDB",
    "offline_phase", "Decision", "decide_paper", "decide_generalized",
    "MachineModel", "decide_cost_model", "AutoTunedSpMV",
]
