"""Drift detection + amortized re-planning for mutating matrices.

A bound :class:`~repro_torch.core.plan.ExecutionPlan` froze a format
decision at one ``D_mat = sigma/mu``.  As deltas land, the row-length
distribution — and with it the paper's decision variable — drifts.  This
module keeps an O(Δ)-updatable :class:`DriftSketch` of (mu, sigma, D_mat,
row-length histogram), and a :class:`ReplanPolicy` that re-mints the plan
only when **both** hold:

1. **Boundary crossing** — the paper rule's from-scratch pick at the
   current D_mat differs from the bound plan's format, and D_mat sits
   outside a relative hysteresis band around ``D*`` (so a matrix
   oscillating near the boundary never churns);
2. **Streaming amortization** — the paper's rule
   ``k·B·(t_crs−t_f) > t_trans`` extended with the expected cost of
   *future* re-transforms: ``k̂·(1 − 1/sp) > tt·(1 + E[re-transform])``
   in t_crs-per-call units, with ``k̂`` estimated from the observed
   query/update interarrival ratio and (sp, tt) from
   :meth:`TuningDB.predict`.

:class:`StreamingPlannedMatrix` packages the loop: it wraps a
``PlannedMatrix`` with ``apply(delta)`` / ``@``, updating CSR and SELL
containers incrementally (:mod:`repro_torch.stream.delta`) and re-planning
through the :class:`~repro_torch.core.plan.Planner` when the policy fires.

On the H100 the off-line phase learns ``D* = 0`` for every format (the
host transform dominates ``TT``), so a policy priced by a measured
:class:`TuningDB` answers ``no_boundary``; a re-plan is driven there by
an explicit ``ReplanPolicy(d_star=...)``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import obs as _obs
from ..core.formats import CSR
from ..device import resolve_device
from .delta import (INCREMENTAL_FORMATS, DeltaApplyResult, DeltaBatch,
                    apply_delta)

#: log2 row-length histogram resolution of the sketch
HIST_BUCKETS = 32

STREAM_PLAN_SCHEMA_VERSION = 1


def _hist_index(lens: np.ndarray) -> np.ndarray:
    """Bucket i holds rows with length in [2^(i-1), 2^i); bucket 0 = empty
    rows."""
    lens = np.asarray(lens, dtype=np.int64)
    idx = np.zeros(lens.shape[0], dtype=np.int64)
    pos = lens > 0
    idx[pos] = np.floor(np.log2(lens[pos])).astype(np.int64) + 1
    return np.clip(idx, 0, HIST_BUCKETS - 1)


@dataclass
class DriftSketch:
    """Running (n, Σlen, Σlen², histogram) over row lengths — enough to
    recover mu/sigma/D_mat exactly (population stddev, as the paper uses)
    while each delta costs O(rows touched) to fold in."""

    n: int = 0
    nnz: int = 0
    sum_sq: float = 0.0
    hist: np.ndarray = field(
        default_factory=lambda: np.zeros(HIST_BUCKETS, dtype=np.int64))
    updates: int = 0

    @classmethod
    def of(cls, csr: CSR) -> "DriftSketch":
        lens = csr.row_lengths().astype(np.int64)
        sk = cls(n=int(csr.n_rows), nnz=int(lens.sum()),
                 sum_sq=float((lens.astype(np.float64) ** 2).sum()))
        np.add.at(sk.hist, _hist_index(lens), 1)
        return sk

    # -- derived --------------------------------------------------------------
    @property
    def mu(self) -> float:
        return self.nnz / self.n if self.n else 0.0

    @property
    def sigma(self) -> float:
        if not self.n:
            return 0.0
        var = self.sum_sq / self.n - self.mu ** 2
        return math.sqrt(max(var, 0.0))

    @property
    def d_mat(self) -> float:
        mu = self.mu
        return self.sigma / mu if mu > 0 else float("inf")

    # -- folding a delta in ---------------------------------------------------
    def update(self, res: DeltaApplyResult) -> "DriftSketch":
        app = np.asarray(res.appended_lens, dtype=np.int64)
        old = np.asarray(res.old_lens, dtype=np.float64)
        new = np.asarray(res.new_lens, dtype=np.float64)
        self.n += int(app.shape[0])
        self.nnz += int(app.sum()) + int(new.sum() - old.sum())
        self.sum_sq += float((app.astype(np.float64) ** 2).sum()) \
            + float((new ** 2).sum() - (old ** 2).sum())
        if app.size:
            np.add.at(self.hist, _hist_index(app), 1)
        if old.size:
            np.add.at(self.hist, _hist_index(old), -1)
            np.add.at(self.hist, _hist_index(new), 1)
        self.updates += 1
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {"n": int(self.n), "nnz": int(self.nnz),
                "sum_sq": float(self.sum_sq),
                "hist": self.hist.tolist(), "updates": int(self.updates)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DriftSketch":
        return cls(n=int(d["n"]), nnz=int(d["nnz"]),
                   sum_sq=float(d["sum_sq"]),
                   hist=np.asarray(d.get("hist",
                                         np.zeros(HIST_BUCKETS)),
                                   dtype=np.int64),
                   updates=int(d.get("updates", 0)))


@dataclass
class DriftDecision:
    replan: bool
    target_fmt: str
    reason: str          #: stable | no_boundary | hysteresis | cooldown |
    #: unamortized | replan
    d_mat: float
    d_star: float
    k_hat: float


@dataclass
class ReplanPolicy:
    """When is re-minting the plan worth it?  See the module docstring for
    the two-condition trigger; every evaluation emits a ``stream.drift``
    event so trigger precision is auditable from traces."""

    db: Any = None                      #: TuningDB for D* + (sp, tt)
    fmt: str = "ell_row"                #: the paper rule's candidate format
    d_star: Optional[float] = None      #: override; else ``db.d_star[fmt]``
    hysteresis: float = 0.15            #: relative dead band around D*
    retransform_factor: float = 1.0     #: E[future re-transforms] per plan
    batch: int = 1
    default_k: float = 100.0            #: k̂ before any queries are seen
    ema_alpha: float = 0.3
    min_deltas_between: int = 1         #: replan cooldown, in deltas
    # -- state --
    k_hat: float = 0.0
    queries_since_update: int = 0
    deltas_since_replan: int = 0

    def note_query(self, n: int = 1) -> None:
        self.queries_since_update += n

    def note_update(self) -> None:
        q = float(self.queries_since_update)
        self.k_hat = q if self.k_hat == 0.0 else (
            self.ema_alpha * q + (1.0 - self.ema_alpha) * self.k_hat)
        self.queries_since_update = 0
        self.deltas_since_replan += 1

    def boundary(self) -> float:
        if self.d_star is not None:
            return float(self.d_star)
        if self.db is not None:
            return float(self.db.d_star.get(self.fmt, 0.0))
        return 0.0

    def decide(self, d_mat: float, current_fmt: str,
               key: str = "") -> DriftDecision:
        ds = self.boundary()
        k = self.k_hat if self.k_hat > 0 else self.default_k
        target = self.fmt if d_mat < ds else "csr"

        if ds <= 0:
            reason = "no_boundary"
        elif target == current_fmt:
            reason = "stable"
        elif math.isfinite(d_mat) and abs(d_mat - ds) <= self.hysteresis * ds:
            reason = "hysteresis"
        elif self.deltas_since_replan < self.min_deltas_between:
            reason = "cooldown"
        elif target != "csr" and self.db is not None:
            # moving *into* a transformed format pays a transform now and
            # (retransform_factor ×) again later — charge both up front
            pred = self.db.predict(target, d_mat, batch=self.batch)
            lhs = k * (1.0 - 1.0 / max(pred["sp"], 1e-9))
            rhs = pred["tt"] * (1.0 + self.retransform_factor)
            reason = "replan" if (math.isfinite(rhs) and lhs > rhs) \
                else "unamortized"
        else:
            # moving back to CSR is transform-free: crossing alone decides
            reason = "replan"

        dec = DriftDecision(replan=(reason == "replan"), target_fmt=target,
                            reason=reason, d_mat=float(d_mat),
                            d_star=float(ds), k_hat=float(k))
        tel = _obs.get()
        if tel.enabled:
            tel.event("stream.drift", key=key, current_fmt=current_fmt,
                      target_fmt=target, reason=reason, d_mat=dec.d_mat,
                      d_star=dec.d_star, k_hat=dec.k_hat)
        return dec

    def to_dict(self) -> Dict[str, Any]:
        return {"fmt": self.fmt, "d_star": self.boundary(),
                "hysteresis": float(self.hysteresis),
                "retransform_factor": float(self.retransform_factor),
                "batch": int(self.batch), "k_hat": float(self.k_hat),
                "min_deltas_between": int(self.min_deltas_between)}


class StreamingPlannedMatrix:
    """A :class:`~repro_torch.core.plan.PlannedMatrix` that absorbs deltas.

    ``apply(delta)`` updates the source CSR and — when the bound plan is a
    single-block ``csr``/``sell`` leaf — the serving container in place;
    any other shape falls back to re-minting the plan on the updated
    matrix (a full re-transform, with its cost recorded).  ``@`` delegates
    to the bound matrix while counting queries for the k̂ estimate.

    The matrix serves on ``bind_kw["device"]``, else the planner's device
    (``None`` = the CUDA card); the source CSR is moved there once, and
    every delta edits it there.
    """

    def __init__(self, csr: CSR, planner: Any, *,
                 plan: Any = None, policy: Optional[ReplanPolicy] = None,
                 capture: Any = None, key: str = "stream",
                 plan_kw: Optional[dict] = None,
                 bind_kw: Optional[dict] = None):
        csr.validate()
        self.planner = planner
        self.key = key
        self.plan_kw = dict(plan_kw or {})
        self.bind_kw = dict(bind_kw or {})
        dev = resolve_device(self.bind_kw.get(
            "device", getattr(planner, "device", None)))
        self.bind_kw["device"] = dev
        csr = csr.to(dev)
        self.csr = csr
        self.plan = plan if plan is not None \
            else planner.plan(csr, **self.plan_kw)
        self.bound = self.plan.bind(csr, db=planner.db, **self.bind_kw)
        self.policy = policy if policy is not None else ReplanPolicy(
            db=planner.db, batch=int(getattr(self.plan, "batch", 1) or 1))
        self.sketch = DriftSketch.of(csr)
        self.capture = capture
        self.applies = 0
        self.queries = 0
        self.replans = 0
        self.fallbacks = 0
        self.last_decision: Optional[DriftDecision] = None
        if capture is not None:
            capture.base(self.key, csr)

    # -- delta path -----------------------------------------------------------
    def apply(self, delta: DeltaBatch) -> DeltaApplyResult:
        self.applies += 1
        if self.capture is not None:
            self.capture.delta(self.key, delta)
        hyb = self.bound.matrix
        n_blocks = getattr(hyb, "n_blocks", None)
        if n_blocks is None:
            # non-hybrid bind: the plan's container *is* the single leaf
            leaf = self.plan.fmt in INCREMENTAL_FORMATS
            fmt, container = self.plan.fmt, hyb
        else:
            leaf = (n_blocks == 1 and hyb.identity_perm
                    and hyb.formats[0] in INCREMENTAL_FORMATS)
            fmt = hyb.formats[0] if leaf else ""
            container = hyb.blocks[0] if leaf else None
        if leaf:
            res = apply_delta(self.csr, delta, container=container,
                              fmt=fmt, key=self.key,
                              transform_params=dict(
                                  self.plan.transform.params or {}))
            self.csr = res.csr
            self._swap_container(res.container, fmt,
                                 hybrid=n_blocks is not None)
        else:
            # multi-block / non-incremental formats: update the CSR, then
            # pay a full re-materialize (recorded as a fallback rebuild)
            res = apply_delta(self.csr, delta, fmt="csr", key=self.key)
            self.csr = res.csr
            self.plan = self.planner.plan(self.csr, **self.plan_kw)
            self.bound = self.plan.bind(self.csr, db=self.planner.db,
                                        **self.bind_kw)
            res.fallback, res.fallback_reason = True, "nonleaf"
            res.mode = "rebuild"
        if res.fallback:
            self.fallbacks += 1

        self.sketch.update(res)
        self.policy.note_update()
        dec = self.policy.decide(self.sketch.d_mat,
                                 current_fmt=self.plan.fmt, key=self.key)
        self.last_decision = dec
        if dec.replan:
            self._replan()
        return res

    def _swap_container(self, container: Any, fmt: str,
                        hybrid: bool = True) -> None:
        from ..kernels.ops import prepare
        if hybrid:
            from ..partition.hybrid import HybridMatrix
            container = HybridMatrix(
                perm=torch.arange(self.csr.n_rows, dtype=torch.int32,
                                  device=self.csr.device),
                blocks=(container,), row_offsets=(0,), formats=(fmt,),
                shape=self.csr.shape, nnz=self.csr.nnz, identity_perm=True)
        # what the kernels read beside it (apply_delta prepared the
        # block; a container prepared already passes through)
        self.bound.matrix = prepare(container)
        self.bound.source = self.csr

    def _replan(self) -> None:
        old_fmt = self.plan.fmt
        self.plan = self.planner.plan(self.csr, **self.plan_kw)
        self.bound = self.plan.bind(self.csr, db=self.planner.db,
                                    **self.bind_kw)
        self.policy.deltas_since_replan = 0
        self.replans += 1
        tel = _obs.get()
        if tel.enabled:
            tel.counter("stream.replans", key=self.key).inc()
            tel.event("stream.replan", key=self.key, old_fmt=old_fmt,
                      new_fmt=self.plan.fmt, d_mat=self.sketch.d_mat,
                      replans=self.replans)

    # -- query path -----------------------------------------------------------
    def __matmul__(self, x):
        self.queries += 1
        self.policy.note_query()
        if self.capture is not None:
            # the batch from the shape alone: x may be a panel on the card
            shape = tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
            self.capture.query(self.key,
                               batch=int(shape[1]) if len(shape) == 2 else 1)
        return self.bound @ x

    def __call__(self, x):
        return self @ x

    # -- introspection --------------------------------------------------------
    @property
    def fmt(self) -> str:
        return self.plan.fmt

    @property
    def shape(self):
        return self.csr.shape

    @property
    def d_mat(self) -> float:
        return self.sketch.d_mat

    def to_dict(self) -> Dict[str, Any]:
        """The ``stream_plan`` JSON artifact (linted by RPL010)."""
        return {"kind": "stream_plan",
                "schema_version": STREAM_PLAN_SCHEMA_VERSION,
                "key": self.key,
                "plan": self.plan.to_dict(),
                "sketch": self.sketch.to_dict(),
                "policy": self.policy.to_dict(),
                "counters": {"applies": self.applies,
                             "queries": self.queries,
                             "replans": self.replans,
                             "fallbacks": self.fallbacks}}

    def __repr__(self) -> str:
        return (f"StreamingPlannedMatrix(key={self.key!r}, "
                f"fmt={self.fmt!r}, shape={self.shape}, "
                f"d_mat={self.d_mat:.3f}, applies={self.applies}, "
                f"replans={self.replans})")


__all__ = ["HIST_BUCKETS", "STREAM_PLAN_SCHEMA_VERSION", "DriftSketch",
           "DriftDecision", "ReplanPolicy", "StreamingPlannedMatrix"]
