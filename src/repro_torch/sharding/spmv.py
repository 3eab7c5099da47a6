"""Sharded SpMV/SpMM: per-shard ExecutionPlans, served shard by shard.

The sharded tier of the JAX package, on one CUDA card (or the CPU).  A CSR
is cut into contiguous slabs along one axis by the partition strategies
lifted to shard-count granularity (``partition_for_devices``), the
:class:`~repro_torch.core.plan.Planner` runs independently per slab so
every shard gets its own format + launch geometry, and the resulting
:class:`ShardedPlannedMatrix` serves ``P @ x`` / ``P @ X``.

Reassembly:

  * ``axis="row"`` — every shard multiplies its row slab by the whole x,
    and the outputs reassemble by concatenation alone (the partitioner
    never sorts rows, so slabs stay contiguous in the original row order).
  * ``axis="col"`` — every shard multiplies its column slab by its window
    of x (the gather) into a full-length partial y, and the partials are
    summed in shard order.

Execution modes:

  * ``"dispatch"`` — the format-faithful path.  Each shard binds its own
    :class:`~repro_torch.core.plan.PlannedMatrix` (own format, tier,
    geometry, so its own kernel), placed round robin over ``devices``
    (default: every CUDA card for a CUDA device, else the one device).
    Partials move to the first device before they are joined.  Each shard
    is served through its own guard ladder (tuned → reference CSR on the
    shard's slab).  Launches stay on the current stream.
  * ``"single"`` — a 1-shard plan: that shard's ``PlannedMatrix``.  Asked
    for with more shards it raises :class:`~repro_torch.core.plan.PlanError`
    (the reference serves shard 0's slab alone then: a product of the
    wrong shape).
  * ``"auto"`` — ``"single"`` for one shard, else ``"dispatch"``.  The
    JAX package's rule picks ``"shard_map"`` when there is a device a
    shard; on one card (or the CPU) that rule gives ``"dispatch"`` too,
    and on several the port serves by ``"dispatch"`` until the
    multi-device executor exists (ROADMAP.md item A15b).
  * ``"shard_map"`` — one program across devices (the reference's SPMD
    envelope and ``psum``).  Not ported: asked for explicitly it raises the
    reference's :class:`~repro_torch.core.plan.PlanError` when there are
    fewer devices than shards, and :class:`NotImplementedError` naming
    A15b otherwise (or when a ``mesh`` is given).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..core.formats import CSR, memory_bytes
from ..core.plan import (PlanError, Planner, ShardedPlan, shard_boundaries,
                         slice_shard)
from ..device import DeviceLike, resolve_device

MODES = ("auto", "shard_map", "dispatch", "single")


# ---------------------------------------------------------------------------
# partitioning the matrix
# ---------------------------------------------------------------------------
def _slice_for(csr: CSR, boundaries: np.ndarray, axis: str) -> List[CSR]:
    """The slabs of ``csr`` between ``boundaries``, cut from one host copy
    (host CSRs)."""
    from ..partition.hybrid import _on_host
    host = _on_host(csr)
    return [slice_shard(host, int(s), int(e), axis=axis)
            for s, e in zip(boundaries[:-1], boundaries[1:])]


def shard_csr(csr: CSR, n_shards: int, axis: str = "row",
              strategy: str = "balanced_nnz",
              **strategy_kw) -> Tuple[np.ndarray, List[CSR]]:
    """Cut ``csr`` into ``n_shards`` slabs along ``axis``; returns
    ``(boundaries, [slab CSRs])`` (host CSRs).  Row slabs keep the full
    column space; column slabs keep the full row space with columns
    rebased to 0."""
    b = shard_boundaries(csr, n_shards, axis=axis, strategy=strategy,
                         **strategy_kw)
    return b, _slice_for(csr, b, axis)


def _imbalance(subs: Sequence[CSR]) -> float:
    nnzs = np.array([m.nnz for m in subs], dtype=np.float64)
    return float(nnzs.max() / max(nnzs.mean(), 1.0))


def _devices(device: DeviceLike,
             devices: Optional[Sequence[Any]]) -> List[torch.device]:
    """The devices shards are placed on: ``devices`` as given, else every
    CUDA card when ``device`` resolves to one, else that device alone."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise PlanError("devices must name at least one device")
        return devs
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


# ---------------------------------------------------------------------------
# the bound sharded operator
# ---------------------------------------------------------------------------
class ShardedPlannedMatrix:
    """A :class:`~repro_torch.core.plan.ShardedPlan` applied to a concrete
    matrix.  ``y = P @ x`` dispatches on x's rank exactly like
    :class:`~repro_torch.core.plan.PlannedMatrix` — 1-D serves SpMV,
    ``(n_cols, B)`` serves SpMM — shard by shard per the resolved mode
    (see the module docstring).  The result lies on the first device."""

    def __init__(self, plan: ShardedPlan, source: CSR, mode: str,
                 boundaries: np.ndarray, fingerprint_matched: bool,
                 planned: List[Any], devices: Sequence[torch.device],
                 shard_nnz: Optional[List[int]] = None):
        self.plan = plan
        self.source = source
        self.mode = mode
        self.boundaries = np.asarray(boundaries, dtype=np.int64)
        self.fingerprint_matched = fingerprint_matched
        self.planned = planned          # per-shard bound PlannedMatrix
        self.shard_nnz = list(shard_nnz or [])
        self._devices = list(devices)
        self.shard_guards: List[Dict[str, Any]] = []
        if mode == "dispatch":
            self.shard_guards = self._build_shard_guards()

    def _build_shard_guards(self) -> List[Dict[str, Any]]:
        """Dispatch mode serves shards one by one on the host, so each
        shard gets its own degradation ladder: the bound per-shard impl
        backed by reference-CSR on that shard's slab (on the shard's
        device).  Exception faults demote a single shard instead of failing
        the whole product; finiteness is *not* probed per shard (that would
        add one device sync per shard per call) — the service-level guard
        already probes the assembled output end-to-end."""
        # lazy: sharding must stay importable without the serve package
        from ..core import dispatch as _dispatch
        from ..serve.guard import guard_ladder
        ref_mv = _dispatch.get_impl("csr", "spmv", "reference")
        ref_mm = _dispatch.get_impl("csr", "spmm", "reference")
        guards = []
        for i, pm in enumerate(self.planned):
            src = pm.source
            guards.append({
                "spmv": guard_ladder(
                    f"shard{i}", "spmv",
                    [("tuned", lambda xi, _pm=pm: _pm.spmv(xi)),
                     ("csr", lambda xi, _s=src: ref_mv(_s, xi))],
                    fmt=pm.fmt, probe_finite=False),
                "spmm": guard_ladder(
                    f"shard{i}", "spmm",
                    [("tuned", lambda xi, _pm=pm: _pm.spmm(xi)),
                     ("csr", lambda xi, _s=src: ref_mm(_s, xi))],
                    fmt=pm.fmt, probe_finite=False),
            })
        return guards

    def guard_report(self) -> List[Dict[str, Any]]:
        """Per-shard ladder snapshots (dispatch mode; empty otherwise)."""
        return [{op: g.snapshot() for op, g in shard.items()}
                for shard in self.shard_guards]

    # -- views ---------------------------------------------------------------
    fmt = "sharded"

    @property
    def shape(self) -> Tuple[int, int]:
        return self.source.shape

    @property
    def n_rows(self) -> int:
        return self.source.shape[0]

    @property
    def n_cols(self) -> int:
        return self.source.shape[1]

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    @property
    def n_blocks(self) -> int:
        # the serving layer's block-count view: one block per shard
        return self.plan.n_shards

    @property
    def axis(self) -> str:
        return self.plan.axis

    @property
    def device(self) -> torch.device:
        return self._devices[0]

    @property
    def devices(self) -> List[torch.device]:
        """The device each shard serves on."""
        return [pm.device for pm in self.planned]

    def nbytes(self) -> int:
        return sum(memory_bytes(pm.matrix) for pm in self.planned)

    def report(self) -> List[Dict[str, Any]]:
        """Per-shard decision summary: slab extent, format, tier, nnz."""
        out = []
        b = self.boundaries
        for i, bp in enumerate(self.plan.shards):
            out.append({"shard": i, "rows": (int(b[i]), int(b[i + 1])),
                        "fmt": bp.plan.fmt, "tier": bp.plan.tier,
                        "nnz": (self.shard_nnz[i]
                                if i < len(self.shard_nnz)
                                else bp.plan.fingerprint.nnz
                                if bp.plan.fingerprint else -1)})
        return out

    # -- execution -----------------------------------------------------------
    def _check(self, x: Any, op: str) -> torch.Tensor:
        x = torch.as_tensor(x)
        want = 1 if op == "spmv" else 2
        if x.ndim != want or x.shape[0] != self.n_cols:
            shape = (f"({self.n_cols},)" if op == "spmv"
                     else f"({self.n_cols}, B)")
            raise ValueError(f"{op} expects x of shape {shape}; "
                             f"got {tuple(x.shape)}")
        return x

    def _run_dispatch(self, op: str, x: torch.Tensor,
                      tel) -> torch.Tensor:
        b = self.boundaries
        parts = []
        for i, pm in enumerate(self.planned):
            with tel.span("shard.spmv", shard=i, fmt=pm.fmt,
                          mode="dispatch"):
                if self.axis == "row":
                    xi = x
                else:
                    with tel.span("shard.gather", shard=i):
                        xi = x[int(b[i]): int(b[i + 1])]
                xi = xi.to(pm.device).contiguous()
                parts.append(self.shard_guards[i][op](xi))
        # partials live where their shards ran; the join needs them on one
        # device
        home = self.device
        parts = [p.to(home) for p in parts]
        if self.axis == "row":
            return torch.cat(parts)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def _apply(self, op: str, x: Any) -> torch.Tensor:
        x = self._check(x, op)
        tel = _obs.get()
        with tel.span("sharded.spmv", op=op, mode=self.mode,
                      axis=self.axis, n_shards=self.n_shards):
            if self.mode == "single":
                return getattr(self.planned[0], op)(x)
            return self._run_dispatch(op, x, tel)

    def spmv(self, x) -> torch.Tensor:
        return self._apply("spmv", x)

    def spmm(self, x) -> torch.Tensor:
        return self._apply("spmm", x)

    def __matmul__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        return self.spmv(x) if x.ndim == 1 else self.spmm(x)

    def __call__(self, x) -> torch.Tensor:
        return self @ x

    def __repr__(self) -> str:
        return (f"ShardedPlannedMatrix(n_shards={self.n_shards}, "
                f"axis={self.axis!r}, mode={self.mode!r}, "
                f"shape={self.shape}, formats={self.plan.shard_formats()}, "
                f"fingerprint_matched={self.fingerprint_matched})")


# ---------------------------------------------------------------------------
# binding
# ---------------------------------------------------------------------------
def _resolve_mode(mode: str, n_shards: int, devices: Sequence[Any],
                  mesh: Optional[Any]) -> str:
    """The mode a bind serves in; an explicit ``shard_map`` raises (see the
    module docstring)."""
    if mode not in MODES:
        raise PlanError(f"unknown mode {mode!r}; one of {MODES}")
    if n_shards == 1:
        return "single"
    if mode == "single":
        raise PlanError(f"mode='single' serves a 1-shard plan; this one "
                        f"has {n_shards} shards (use mode='dispatch')")
    if mode == "auto":
        return "dispatch"
    if mode == "shard_map":
        if mesh is None and len(devices) < n_shards:
            raise PlanError(
                f"shard_map mode needs >= {n_shards} devices for "
                f"{n_shards} shards; have {len(devices)} (use "
                f"mode='dispatch')")
        raise NotImplementedError(
            "shard_map mode (one program across devices) and mesh= are "
            "not ported yet (ROADMAP.md item A15b); use mode='dispatch'")
    return mode


def build_sharded(csr: CSR, *, plan: Optional[ShardedPlan] = None,
                  planner: Optional[Planner] = None, db: Optional[Any] = None,
                  n_shards: Optional[int] = None, axis: str = "row",
                  strategy: str = "balanced_nnz", mode: str = "auto",
                  devices: Optional[Sequence[Any]] = None,
                  device: DeviceLike = None, mesh: Optional[Any] = None,
                  batch: int = 1,
                  strategy_kw: Optional[Dict[str, Any]] = None,
                  **plan_kw) -> ShardedPlannedMatrix:
    """Partition + per-shard plan + bind in one call.

    Without ``plan``, a :class:`Planner` (the given one, or a fresh one
    over ``db`` on ``device``) mints a :class:`ShardedPlan` for ``csr``
    first (``n_shards`` defaults to the number of devices).  With
    ``plan``, the recorded decisions replay with zero re-tuning; a
    fingerprint mismatch keeps the recipe — axis, strategy, shard count,
    per-shard formats — but re-partitions on the new matrix (per-shard
    geometry re-resolves exactly like single plans).  ``device`` (``None``
    = the CUDA card) picks the default ``devices``."""
    tel = _obs.get()
    devs = _devices(device, devices)
    if plan is None:
        planner = planner or Planner(db=db, device=devs[0])
        if n_shards is None:
            n_shards = len(devs)
        plan = planner.plan_sharded(csr, n_shards=n_shards, axis=axis,
                                    strategy=strategy, batch=batch,
                                    strategy_kw=strategy_kw, **plan_kw)
        if db is None:
            db = planner.db
    matched = plan.matches(csr)

    with tel.span("sharded.bind", n_shards=plan.n_shards, axis=plan.axis,
                  matched=matched) as sp:
        resolved = _resolve_mode(mode, plan.n_shards, devs, mesh)
        if matched:
            boundaries = plan.boundaries()
        else:
            boundaries = shard_boundaries(csr, plan.n_shards,
                                          axis=plan.axis,
                                          strategy=plan.strategy,
                                          **plan.params)
        subs = _slice_for(csr, boundaries, plan.axis)
        imb = _imbalance(subs)
        tel.gauge("sharded.load_imbalance").set(imb)
        sp.set(mode=resolved, imbalance=imb)
        # each slab moves to its device before the bind, so a CSR shard's
        # bound matrix and the source its guard falls back to are one copy
        placed = [devs[i % len(devs)] for i in range(plan.n_shards)]
        planned = [bp.plan.bind(sub.to(dev), db=db, device=dev)
                   for bp, sub, dev in zip(plan.shards, subs, placed)]
        return ShardedPlannedMatrix(
            plan, csr, resolved, boundaries, matched, planned=planned,
            devices=placed, shard_nnz=[m.nnz for m in subs])


__all__ = ["ShardedPlannedMatrix", "build_sharded", "shard_csr"]
