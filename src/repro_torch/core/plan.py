"""One plan to rule them all: the serializable :class:`ExecutionPlan` API.

The paper's method is a single pipeline — profile the machine (off-line),
read the matrix's D_mat, decide the format, transform at run time, launch.
The decision artifact itself is first class and portable: tune once, save
the plan, replay it on any matrix with the same structure.

  * :class:`ExecutionPlan` — one versioned, JSON-serializable object
    capturing everything between a CSR source and a launched kernel:
    decision rule + chosen format, transform recipe (name + params, e.g.
    SELL slice rows), per-op :class:`~repro_torch.core.kernel_tune.TileGeometry`
    (including per-bucket SELL tables), batch axis, execution tier
    (reference/kernel), and the fingerprint of the matrix it was tuned on.
    The JSON schema is the JAX package's (``SCHEMA_VERSION = 1``): a plan
    written by either package loads in the other.
  * :class:`Planner` — the single entry point that subsumes
    ``decide_paper`` / ``decide_generalized`` / ``decide_cost_model``
    behind a ``rule=`` strategy.
  * :class:`PlannedMatrix` — ``plan.bind(csr)``: the plan applied to a
    concrete matrix, resident on the device; ``y = P @ x`` serves SpMV
    (1-D x) and SpMM ((n_cols, B) panels) through one ``__matmul__``.

Binding a plan to a matrix whose fingerprint differs from the one it was
tuned on keeps the format decision but re-resolves launch geometry — the
D_mat-keyed ``nearest_geometry`` lookup when a TuningDB is at hand, else the
plan's own geometry stripped of its matrix-specific slab bound.

Plans come as leaves, as hybrid (partitioned) plans, whose ``blocks`` each
carry a leaf plan for one row block and bind to a ``partition.HybridMatrix``,
and as a :class:`ShardedPlan` (``Planner.plan_sharded(csr, n_shards=N)``):
the matrix cut into N row or column slabs with a plan each, one JSON
artifact (``SHARDED_SCHEMA_VERSION = 1``, the JAX package's) that binds to
a ``sharding.spmv.ShardedPlannedMatrix``.  Every plan the :class:`Planner`
mints passes the static plan lint (``repro_torch.analyze.planlint``) first,
and :meth:`Planner.plan_or_load` shares plans through a
:class:`~repro_torch.core.plan_store.PlanStore`.
"""
from __future__ import annotations

import functools
import json
import time
from dataclasses import asdict, dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..device import DeviceLike, from_host, resolve_device
from . import dispatch as _dispatch
from .autotune import (MachineModel, TuningDB, decide_cost_model,
                       decide_generalized, decide_paper)
from .formats import CSR, MatrixStats, memory_bytes, validate_container
from .kernel_tune import TileGeometry, _structure_sig

SCHEMA_VERSION = 1

#: recipe params recorded explicitly so a saved plan replays the same
#: transformation even if the library's defaults later change
DEFAULT_RECIPE_PARAMS: Dict[str, Dict[str, Any]] = {
    "sell": {"slice_rows": 128, "width_quantum": 8},
    "bcsr": {"block": 8},
}

#: formats whose plan geometry carries the reference's data-dependent
#: slab-coverage bound, (re)derived per concrete matrix for schema parity
_SLAB_FORMATS = ("csr", "ccs", "bcsr")

def _finite_or_none(v: float) -> Optional[float]:
    """Non-finite floats (NaN d_star on cost-model/hybrid plans, inf d_mat
    on degenerate matrices) serialize as null so the artifact stays strict
    RFC-compliant JSON for non-Python consumers."""
    return float(v) if np.isfinite(v) else None


def _nan_if_none(v: Any) -> float:
    return float("nan") if v is None else float(v)


class PlanError(ValueError):
    """Malformed or unusable ExecutionPlan payload."""


class PlanSchemaError(PlanError):
    """Schema-version mismatch: written by a different plan schema."""


# ---------------------------------------------------------------------------
# fingerprint + transform recipe
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PlanFingerprint:
    """Structural identity of the matrix a plan was tuned on.

    ``sig`` is the CRC of the index-pointer array (same fingerprint the
    kernel tuner memoizes on): two matrices share a fingerprint iff their
    CSR index structure is byte-identical, which is exactly the condition
    under which a matrix-specific slab-coverage bound remains valid."""
    n: int
    nnz: int
    mu: float
    sigma: float
    d_mat: float
    sig: int = 0

    @staticmethod
    def from_stats(stats: MatrixStats, sig: int) -> "PlanFingerprint":
        return PlanFingerprint(n=stats.n, nnz=stats.nnz, mu=stats.mu,
                               sigma=stats.sigma, d_mat=stats.d_mat,
                               sig=sig)

    @staticmethod
    def of(csr: CSR) -> "PlanFingerprint":
        return PlanFingerprint.from_stats(MatrixStats.of(csr),
                                          _structure_sig(csr))

    def matches(self, other: Any) -> bool:
        """Exact structural match (same rows, nnz, and index structure).
        Dimensions are compared before paying for the CRC pass."""
        if self.sig == 0:
            return False
        if isinstance(other, PlanFingerprint):
            return (self.n == other.n and self.nnz == other.nnz
                    and self.sig == other.sig)
        if (self.n != int(getattr(other, "n_rows", -1))
                or self.nnz != int(getattr(other, "nnz", -1))):
            return False
        return self.sig == _structure_sig(other)


@dataclass
class TransformRecipe:
    """Name + params of the run-time transformation (host path)."""
    name: str
    params: Dict[str, Any] = field(default_factory=dict)

    def apply(self, csr: CSR) -> Any:
        return apply_transform(self.name, csr, **self.params)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "params": dict(self.params)}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TransformRecipe":
        return TransformRecipe(name=d["name"],
                               params=dict(d.get("params", {})))


def apply_transform(name: str, csr: CSR, **params) -> Any:
    """Materialize ``name`` from a CSR source with explicit recipe params
    (the parameter-aware face of ``TRANSFORMS_HOST``).  Host recipes: the
    result holds CPU tensors."""
    from . import transform as T
    if name == "csr":
        return csr
    if name == "ell_row":
        return T.host_csr_to_ell(csr, order="row", **params)
    if name == "ell_col":
        return T.host_csr_to_ell(csr, order="col", **params)
    if name == "sell":
        return T.host_csr_to_sell(csr, **params)
    if name == "bcsr":
        return T.host_csr_to_bcsr(csr, **params)
    if name == "coo_row":
        return T.host_csr_to_coo_row(csr)
    if name == "coo_col":
        return T.host_csr_to_coo_col(csr)
    if name == "ccs":
        return T.host_csr_to_ccs(csr)
    if name in T.TRANSFORMS_HOST:  # future registrations
        return T.TRANSFORMS_HOST[name](csr, **params) if params \
            else T.TRANSFORMS_HOST[name](csr)
    raise PlanError(f"unknown transform {name!r}")


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@dataclass
class BlockPlan:
    """One hybrid row block: the permuted row range it covers and the leaf
    plan (format + recipe + geometry) that serves it."""
    rows: Tuple[int, int]
    plan: "ExecutionPlan"

    def to_dict(self) -> Dict[str, Any]:
        return {"rows": list(self.rows), "plan": self.plan.to_dict()}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "BlockPlan":
        return BlockPlan(rows=(int(d["rows"][0]), int(d["rows"][1])),
                         plan=ExecutionPlan.from_dict(d["plan"]))


@dataclass
class ExecutionPlan:
    """Everything between a CSR source and a launched kernel, in one
    versioned, JSON-serializable artifact.

    ``geometry`` maps op name (``"spmv"``/``"spmm"``) to the tuned
    :class:`TileGeometry` (absent op = default launch).  ``blocks`` is the
    per-row-block sub-plan list of a hybrid plan (``None`` for leaves)."""
    fmt: str
    rule: str = "cost_model"
    tier: str = "reference"            # "reference" | "kernel"
    batch: int = 1
    expected_iterations: int = 100
    transform: TransformRecipe = None  # defaults to fmt with no params
    geometry: Dict[str, TileGeometry] = field(default_factory=dict)
    fingerprint: Optional[PlanFingerprint] = None
    machine: str = ""
    d_mat: float = 0.0
    d_star: float = 0.0
    expected_gain: float = 0.0
    blocks: Optional[List[BlockPlan]] = None
    schema_version: int = SCHEMA_VERSION

    def __post_init__(self):
        if self.transform is None:
            self.transform = TransformRecipe(
                self.fmt, dict(DEFAULT_RECIPE_PARAMS.get(self.fmt, {})))

    # -- views ---------------------------------------------------------------
    @property
    def is_hybrid(self) -> bool:
        return self.fmt == "hybrid" or bool(self.blocks)

    def block_formats(self) -> Tuple[str, ...]:
        return tuple(bp.plan.fmt for bp in self.blocks or ())

    def tunings_by_format(self) -> Dict[str, Dict[str, TileGeometry]]:
        """``{op: {format: TileGeometry}}`` — the shape the serving layer
        binds into per-block impl tables.  For a hybrid plan the per-block
        sub-plans are collapsed per format (first block of each format
        wins, matching how one jitted per-format impl serves all sibling
        blocks); leaf plans contribute their own geometry."""
        out: Dict[str, Dict[str, TileGeometry]] = {}
        for bp in self.blocks or ():
            for op, g in bp.plan.geometry.items():
                out.setdefault(op, {}).setdefault(bp.plan.fmt, g)
        for op, g in self.geometry.items():
            out.setdefault(op, {})[self.fmt] = g
        return out

    # -- persistence ---------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "schema_version": self.schema_version,
            "fmt": self.fmt, "rule": self.rule, "tier": self.tier,
            "batch": self.batch,
            "expected_iterations": self.expected_iterations,
            "transform": self.transform.to_dict(),
            "geometry": {op: g.to_dict()
                         for op, g in self.geometry.items()},
            "machine": self.machine,
            "d_mat": _finite_or_none(self.d_mat),
            "d_star": _finite_or_none(self.d_star),
            "expected_gain": _finite_or_none(self.expected_gain),
        }
        if self.fingerprint is not None:
            d["fingerprint"] = {k: (_finite_or_none(v)
                                    if isinstance(v, float) else v)
                                for k, v in asdict(self.fingerprint).items()}
        if self.blocks is not None:
            d["blocks"] = [bp.to_dict() for bp in self.blocks]
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ExecutionPlan":
        if not isinstance(d, dict):
            raise PlanError(f"ExecutionPlan payload must be an object; "
                            f"got {type(d).__name__}")
        ver = d.get("schema_version")
        if ver != SCHEMA_VERSION:
            raise PlanSchemaError(
                f"unsupported ExecutionPlan schema_version={ver!r}; this "
                f"build reads version {SCHEMA_VERSION}.  Re-plan with "
                f"repro_torch.Planner (old plans are cheap to regenerate — the "
                f"expensive TuningDB is versioned separately).")
        try:
            fp = d.get("fingerprint")
            blocks = d.get("blocks")
            if fp is not None:
                fp = {k: (_nan_if_none(v) if k in ("mu", "sigma", "d_mat")
                          else v) for k, v in fp.items()}
            return ExecutionPlan(
                fmt=d["fmt"], rule=d["rule"], tier=d["tier"],
                batch=int(d["batch"]),
                expected_iterations=int(d["expected_iterations"]),
                transform=TransformRecipe.from_dict(d["transform"]),
                geometry={op: TileGeometry.from_dict(g)
                          for op, g in d.get("geometry", {}).items()},
                fingerprint=PlanFingerprint(**fp) if fp else None,
                machine=d.get("machine", ""),
                d_mat=_nan_if_none(d.get("d_mat", 0.0)),
                d_star=_nan_if_none(d.get("d_star")),
                expected_gain=_nan_if_none(d.get("expected_gain", 0.0)),
                blocks=[BlockPlan.from_dict(b) for b in blocks]
                if blocks is not None else None,
                schema_version=int(ver),
            )
        except PlanError:
            raise
        except (KeyError, TypeError, ValueError) as e:
            raise PlanError(f"malformed ExecutionPlan payload: {e!r}") from e

    def to_json(self) -> str:
        # allow_nan=False: non-finite values were mapped to null in
        # to_dict; anything that slips through should fail loudly here
        # rather than emit a Python-only artifact
        return json.dumps(self.to_dict(), indent=1, allow_nan=False)

    @staticmethod
    def from_json(s: str) -> "ExecutionPlan":
        try:
            obj = json.loads(s)
        except json.JSONDecodeError as e:
            raise PlanError(f"ExecutionPlan payload is not valid JSON: {e}") \
                from e
        return ExecutionPlan.from_dict(obj)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "ExecutionPlan":
        with open(path) as f:
            return ExecutionPlan.from_json(f.read())

    # -- materialization -----------------------------------------------------
    def materialize(self, csr: CSR):
        """Replay the recorded per-block decisions on ``csr`` and return
        ``(HybridMatrix, HybridReport)`` — no decision machinery re-runs.
        Leaf plans wrap into a single-block hybrid container so one code
        path serves both shapes.  The container holds CPU tensors (host
        recipes)."""
        from ..partition.hybrid import (BlockDecision, HybridMatrix,
                                        HybridReport, slice_csr,
                                        take_rows_csr)
        from .transform import copy_out
        if not self.blocks:
            t0 = time.perf_counter()
            obj = self.transform.apply(csr)
            dt = time.perf_counter() - t0
            hyb = HybridMatrix(
                perm=from_host(np.arange(csr.n_rows, dtype=np.int32)),
                blocks=(obj,), row_offsets=(0,), formats=(self.fmt,),
                shape=csr.shape, nnz=csr.nnz, identity_perm=True)
            report = HybridReport(
                strategy="plan", n_blocks=1, t_partition=0.0,
                t_transform=dt,
                decisions=[BlockDecision(
                    fmt=self.fmt, rows=(0, csr.n_rows), d_mat=self.d_mat,
                    nnz=csr.nnz, bytes=memory_bytes(obj), t_transform=dt,
                    plan=self)])
            return hyb, report

        if self.blocks[-1].rows[1] != csr.n_rows:
            raise PlanError(
                f"plan's blocks cover {self.blocks[-1].rows[1]} rows but "
                f"the matrix has {csr.n_rows}; re-plan for this matrix")
        sort_rows = bool(self.transform.params.get(
            "sort_rows", self.transform.params.get("strategy") == "variance"))
        host = copy_out(csr)
        t0 = time.perf_counter()
        if sort_rows:
            lens = host.row_lengths().astype(np.int64)
            perm = np.argsort(-lens, kind="stable").astype(np.int32)
        else:
            perm = np.arange(csr.n_rows, dtype=np.int32)
        t_partition = time.perf_counter() - t0

        blocks, fmts, offsets, decisions = [], [], [], []
        t_transform = 0.0
        for bp in self.blocks:
            s, e = bp.rows
            sub = (take_rows_csr(host, perm[s:e]) if sort_rows
                   else slice_csr(host, s, e))
            t1 = time.perf_counter()
            obj = bp.plan.transform.apply(sub)
            dt = time.perf_counter() - t1
            t_transform += dt
            blocks.append(obj)
            fmts.append(bp.plan.fmt)
            offsets.append(s)
            decisions.append(BlockDecision(
                fmt=bp.plan.fmt, rows=bp.rows, d_mat=bp.plan.d_mat,
                nnz=sub.nnz, bytes=memory_bytes(obj), t_transform=dt,
                plan=bp.plan))
        hyb = HybridMatrix(perm=from_host(perm), blocks=tuple(blocks),
                           row_offsets=tuple(offsets), formats=tuple(fmts),
                           shape=csr.shape, nnz=csr.nnz,
                           identity_perm=not sort_rows)
        report = HybridReport(
            strategy=str(self.transform.params.get("strategy", "plan")),
            n_blocks=len(blocks), t_partition=t_partition,
            t_transform=t_transform, decisions=decisions)
        return hyb, report

    # -- binding -------------------------------------------------------------
    def bind(self, csr: CSR, *, db: Optional[TuningDB] = None,
             tier: Optional[str] = None, device: DeviceLike = None,
             impls: Optional[Dict[str, Callable]] = None,
             spmm_impls: Optional[Dict[str, Callable]] = None,
             jit: bool = True) -> "PlannedMatrix":
        """Apply the plan to a concrete matrix: transform (host recipe),
        move the result to ``device`` (``None`` = the CUDA device), resolve
        impls at the plan's tier, attach launch geometry (and, at the kernel
        tier, what the kernels read beside the container:
        ``kernels.ops.prepare``), and return a
        :class:`PlannedMatrix` serving ``P @ x``.

        If ``csr``'s fingerprint differs from the one the plan was tuned
        on, the format decision is kept but geometry is re-resolved: via
        ``db.best_geometry`` (the D_mat-keyed ``nearest_geometry`` lookup)
        when a TuningDB is supplied, else the plan's own geometry stripped
        of its matrix-specific slab-coverage bound.
        ``impls``/``spmm_impls`` are opaque per-format overrides (used
        as-is, no geometry attached).  ``jit`` is accepted for signature
        parity and ignored: PyTorch runs eagerly."""
        tier = tier or self.tier
        dev = resolve_device(device)
        with _obs.get().span("plan.bind", fmt=self.fmt, tier=tier):
            csr.validate()   # fail loudly here, not as garbage in a kernel
            matched = (self.fingerprint is not None
                       and self.fingerprint.matches(csr))
            bind = self._bind_hybrid if self.is_hybrid else self._bind_leaf
            return bind(csr, matched, tier=tier, db=db, device=dev, jit=jit,
                        impls=impls, spmm_impls=spmm_impls)

    def _bind_leaf(self, csr: CSR, matched: bool, *,
                   tier: str, db: Optional[TuningDB],
                   device: torch.device, jit: bool,
                   impls: Optional[Dict[str, Callable]] = None,
                   spmm_impls: Optional[Dict[str, Callable]] = None
                   ) -> "PlannedMatrix":
        tel = _obs.get()
        # reuse the object the tuner already materialized for this exact
        # source (identity-keyed: a same-structure matrix with different
        # values must still re-transform); consumed once so the plan never
        # pins matrix-sized arrays past its first bind
        cache = self.__dict__.pop("_mat_cache", None)
        matrix = (cache[1] if cache is not None and cache[0] is csr
                  else self.transform.apply(csr))
        # check the *transformed* container too: a buggy or bit-rotted
        # transform fails here, not as an out-of-bounds read inside a kernel
        validate_container(matrix)
        with tel.span("bind.upload"):
            matrix = matrix.to(device)
        d_mat_new: Optional[float] = None  # computed once, only if needed
        overrides = {"spmv": impls or {}, "spmm": spmm_impls or {}}
        fns: Dict[str, Callable] = {}
        used: Dict[str, Any] = {}
        tiers: Dict[str, str] = {}
        for op in ("spmv", "spmm"):
            g = self.geometry.get(op)
            if not matched and g is not None:
                alt = None
                if db is not None:
                    if d_mat_new is None:
                        d_mat_new = MatrixStats.of(csr).d_mat
                    alt = db.best_geometry(self.fmt, d_mat_new, op=op,
                                           batch=self.batch)
                g = alt if alt is not None else g.without_slab_bound()
            if self.fmt in overrides[op]:
                fn, found = overrides[op][self.fmt], "override"
            else:
                fn, found = _dispatch.resolve_impl(self.fmt, op, tier=tier)
            if found == "kernel":
                if self.fmt in _SLAB_FORMATS:
                    # recorded exactly as the reference records it — on
                    # the bound matrix (CCS: the column pointer, BCSR: the
                    # block IRP) — so the bound tunings compare key for
                    # key; the CUDA kernels read their bounds from the
                    # pointer and do not depend on it
                    from ..kernels.ops import exact_slab_bound
                    base = g if g is not None else TileGeometry()
                    spb = exact_slab_bound(matrix, base)
                    g = replace(base.without_slab_bound(),
                                slabs_per_block=spb)
                if g is not None:
                    fn = functools.partial(fn, tuning=g)
            fns[op] = fn
            used[op] = g
            tiers[op] = found
        if "kernel" in tiers.values():
            # what the kernels read beside the container (ELL extents, the
            # CSR SpMM kernel's choice) is part of the transformation:
            # computed here, never in a product
            from ..kernels.ops import prepare
            with tel.span("bind.prepare"):
                prepare(matrix)
        return PlannedMatrix(self, csr, matrix, fns, used, tiers,
                             fingerprint_matched=matched, jit=jit)

    def _bind_hybrid(self, csr: CSR, matched: bool, *,
                     tier: str, db: Optional[TuningDB],
                     device: torch.device, jit: bool,
                     impls: Optional[Dict[str, Callable]] = None,
                     spmm_impls: Optional[Dict[str, Callable]] = None
                     ) -> "PlannedMatrix":
        tel = _obs.get()
        # the container the planner built for this exact source, consumed
        # once (as a leaf plan's tuned matrix is)
        cache = self.__dict__.pop("_mat_cache", None)
        if cache is not None and cache[0] is csr and matched:
            hyb, report = cache[1]
        elif matched and self.blocks:
            hyb, report = self.materialize(csr)
        else:
            # different structure: keep the recipe (strategy, sorting) but
            # re-partition and re-decide per block on the new matrix
            from ..partition.hybrid import build_hybrid
            hyb, report = build_hybrid(
                csr, db=db, batch=self.batch,
                expected_iterations=self.expected_iterations,
                **self.transform.params)
        # the container's structure, then each block's
        validate_container(hyb)
        tunings = self.tunings_by_format()
        if not matched:
            tunings = {op: {f: g.without_slab_bound()
                            for f, g in per.items()}
                       for op, per in tunings.items()}
        by_fmt = blocks_by_format(hyb)       # host blocks: bounds in numpy
        overrides = {"spmv": impls or {}, "spmm": spmm_impls or {}}
        fns: Dict[str, Callable] = {}
        used: Dict[str, Any] = {}
        tiers: Dict[str, str] = {}
        for op in ("spmv", "spmm"):
            per = dict(tunings.get(op, {}))
            if "hybrid" in overrides[op]:
                fn, found = overrides[op]["hybrid"], "override"
            else:
                fn, found = _dispatch.resolve_impl("hybrid", op, tier=tier)
            if found == "kernel":
                # each block format's kernel and geometry, resolved once
                # here rather than in every product
                from ..kernels.ops import hybrid_block_impls
                from ..partition import hybrid as _hybrid
                per = rederive_slab_bounds(per, by_fmt)
                fn = functools.partial(
                    getattr(_hybrid, f"{op}_hybrid"),
                    impls=hybrid_block_impls(hyb.formats, op, per))
            fns[op] = fn
            used[op] = per or None
            tiers[op] = found
        with tel.span("bind.upload"):
            hyb = hyb.to(device)
        if "kernel" in tiers.values():
            # each block's kernel inputs (ELL extents, the CSR SpMM
            # kernel's choice): part of the transformation, never a product
            from ..kernels.ops import prepare
            with tel.span("bind.prepare"):
                prepare(hyb)
        return PlannedMatrix(self, csr, hyb, fns, used, tiers,
                             fingerprint_matched=matched, report=report,
                             jit=jit)


def blocks_by_format(hyb: Any) -> Dict[str, List[Any]]:
    """Group a hybrid container's blocks by their format name."""
    by_fmt: Dict[str, List[Any]] = {}
    for blk, f in zip(hyb.blocks, hyb.formats):
        by_fmt.setdefault(f, []).append(blk)
    return by_fmt


def _accepts_tuning(fn: Callable) -> bool:
    """Whether ``fn`` takes a ``tuning=`` kwarg (kernel-tier wrappers do;
    user-supplied reference impls typically don't)."""
    import inspect
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return True
    return ("tuning" in sig.parameters
            or any(p.kind == p.VAR_KEYWORD
                   for p in sig.parameters.values()))


def bind_tunings(impls: Dict[str, Callable],
                 tunings: Dict[str, TileGeometry]) -> Dict[str, Callable]:
    """``{fmt: impl}`` with each format's tuned geometry partially applied.
    Impls that don't accept ``tuning=`` (custom overrides) pass through
    untouched."""
    return {f: (functools.partial(fn, tuning=tunings[f])
                if f in tunings and _accepts_tuning(fn) else fn)
            for f, fn in impls.items()}


def rederive_slab_bounds(per_fmt: Dict[str, TileGeometry],
                         blocks_by_fmt: Dict[str, List[Any]]
                         ) -> Dict[str, TileGeometry]:
    """Re-derive the CSR/CCS/BCSR slab-coverage bound of each per-format
    geometry over *all* concrete blocks of that format, as the reference
    records it (sibling blocks share one per-format geometry, so the bound
    covers the worst of them).  The CUDA kernels read their bounds from the
    pointer at run time; the field is kept so plan JSON and the bound
    tunings match the reference's key for key."""
    out = dict(per_fmt)
    for f, g in per_fmt.items():
        blks = blocks_by_fmt.get(f)
        if blks and f in _SLAB_FORMATS:
            from ..kernels.ops import exact_slab_bound
            spb = max(exact_slab_bound(b, g) for b in blks)
            out[f] = replace(g.without_slab_bound(), slabs_per_block=spb)
    return out


# ---------------------------------------------------------------------------
# the bound operator
# ---------------------------------------------------------------------------
class PlannedMatrix:
    """A plan applied to a concrete matrix.  ``y = P @ x`` dispatches on
    x's rank: 1-D serves SpMV, ``(n_cols, B)`` serves SpMM.  ``x`` is moved
    to the matrix's device if it lies elsewhere, and made contiguous (the
    kernels read it row-major).  ``jit`` is accepted and ignored (eager
    execution)."""

    def __init__(self, plan: ExecutionPlan, source: CSR, matrix: Any,
                 fns: Dict[str, Callable], tunings: Dict[str, Any],
                 tiers: Dict[str, str], fingerprint_matched: bool,
                 report: Any = None, jit: bool = True):
        self.plan = plan
        self.source = source
        self.matrix = matrix
        self.report = report              # HybridReport of a hybrid plan
        self.tunings = tunings            # geometry actually bound, per op
        self.tiers = tiers                # tier each op resolved to
        self.fingerprint_matched = fingerprint_matched
        self._fns = dict(fns)

    @property
    def fmt(self) -> str:
        return self.plan.fmt

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
    def device(self) -> torch.device:
        return self.matrix.device

    def _x(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).contiguous()

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ x``; its ``matrix.spmv`` span times the launch path on the
        host (what is enqueued, not the card's work)."""
        with _obs.get().span("matrix.spmv"):
            x = self._x(x)
            if x.ndim != 1:
                raise ValueError(f"spmv expects x of shape ({self.n_cols},)"
                                 f"; got {tuple(x.shape)}")
            return self._fns["spmv"](self.matrix, x)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """``A @ X``, timed on the host as ``matrix.spmm`` (as ``spmv``)."""
        with _obs.get().span("matrix.spmm"):
            x = self._x(x)
            if x.ndim != 2:
                raise ValueError(f"spmm expects x of shape ({self.n_cols}, "
                                 f"B); got {tuple(x.shape)}")
            return self._fns["spmm"](self.matrix, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        x = self._x(x)
        return self.spmv(x) if x.ndim == 1 else self.spmm(x)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self @ x

    def __repr__(self) -> str:
        return (f"PlannedMatrix(fmt={self.fmt!r}, shape={self.shape}, "
                f"tier={self.plan.tier!r}, device={str(self.device)!r}, "
                f"fingerprint_matched={self.fingerprint_matched})")


# ---------------------------------------------------------------------------
# helper shared with the partition layer
# ---------------------------------------------------------------------------
def leaf_plan(csr: CSR, stats: MatrixStats, fmt: str, rule: str,
              batch: int = 1, expected_iterations: int = 100,
              machine: str = "", tier: str = "reference",
              d_star: float = float("nan"),
              expected_gain: float = 0.0) -> ExecutionPlan:
    """A leaf plan for one (sub-)matrix — what ``build_hybrid`` emits per
    row block (geometry is attached later by the Planner / service).
    Reuses the caller's already-computed ``stats`` so per-block minting
    never doubles the stats pass."""
    fp = PlanFingerprint.from_stats(stats, _structure_sig(csr))
    return ExecutionPlan(
        fmt=fmt, rule=rule, tier=tier, batch=max(int(batch), 1),
        expected_iterations=max(int(expected_iterations), 1),
        transform=TransformRecipe(fmt,
                                  dict(DEFAULT_RECIPE_PARAMS.get(fmt, {}))),
        fingerprint=fp, machine=machine,
        d_mat=stats.d_mat, d_star=d_star, expected_gain=expected_gain)


# ---------------------------------------------------------------------------
# the sharded plan — per-device slabs, one ExecutionPlan per shard
# ---------------------------------------------------------------------------
SHARDED_SCHEMA_VERSION = 1


def _shard_lens(csr: CSR, axis: str) -> np.ndarray:
    """Work vector the partitioners cut: nnz per row (row sharding) or
    nnz per column (column sharding, counted on the matrix's device; only
    the counts cross to the host)."""
    if axis == "row":
        return csr.row_lengths().astype(np.int64)
    if axis == "col":
        cols = csr.cols[: csr.nnz].long()
        return torch.bincount(cols, minlength=csr.n_cols).cpu().numpy() \
            .astype(np.int64)
    raise PlanError(f"unknown sharding axis {axis!r}; one of ('row', 'col')")


def shard_boundaries(csr: CSR, n_shards: int, axis: str = "row",
                     strategy: str = "balanced_nnz",
                     **strategy_kw) -> np.ndarray:
    """Exactly ``n_shards + 1`` slab boundaries along ``axis`` via the
    partition strategies lifted to device-count granularity."""
    from ..partition.strategies import partition_for_devices
    return partition_for_devices(_shard_lens(csr, axis), n_shards,
                                 strategy=strategy, **strategy_kw)


def slice_shard(csr: CSR, s: int, e: int, axis: str = "row") -> CSR:
    """The [s, e) slab of ``csr`` along the sharding axis: a row slab with
    the full column space, or a column slab with the full row space (a
    host CSR, as the hybrid tier's slices are)."""
    from ..partition.hybrid import slice_csr, slice_csr_cols
    return (slice_csr(csr, s, e) if axis == "row"
            else slice_csr_cols(csr, s, e))


@dataclass
class ShardedPlan:
    """The distributed decision artifact: one :class:`ExecutionPlan` per
    device slab plus the partition recipe and mesh shape that produced
    them — everything needed to replay a sharded SpMV/SpMM with zero
    re-tuning.

    ``shards[i].rows`` is the [start, end) slab of shard ``i`` along
    ``axis`` ("row": row slab, full column space, outputs concatenate;
    "col": column slab, full row space, partial outputs sum), and
    ``shards[i].plan`` is the per-shard plan the :class:`Planner` minted
    on that slab — each shard gets its own format + launch geometry.
    Serialization mirrors :class:`ExecutionPlan` and is the JAX package's
    (``SHARDED_SCHEMA_VERSION = 1``, ``mesh_axis`` kept): a plan written
    by either package loads in the other; a future schema raises
    :class:`PlanSchemaError`."""
    shards: List[BlockPlan]
    axis: str = "row"                   # "row" | "col"
    strategy: str = "balanced_nnz"
    params: Dict[str, Any] = field(default_factory=dict)
    mesh_shape: Tuple[int, ...] = ()    # defaults to (n_shards,)
    mesh_axis: str = "shards"
    batch: int = 1
    fingerprint: Optional[PlanFingerprint] = None  # whole-matrix identity
    schema_version: int = SHARDED_SCHEMA_VERSION

    def __post_init__(self):
        if not self.shards:
            raise PlanError("ShardedPlan needs at least one shard")
        if self.axis not in ("row", "col"):
            raise PlanError(f"unknown sharding axis {self.axis!r}")
        if not self.mesh_shape:
            self.mesh_shape = (len(self.shards),)

    # -- views ---------------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def boundaries(self) -> np.ndarray:
        b = [bp.rows[0] for bp in self.shards] + [self.shards[-1].rows[1]]
        return np.asarray(b, dtype=np.int64)

    def shard_formats(self) -> Tuple[str, ...]:
        return tuple(bp.plan.fmt for bp in self.shards)

    def matches(self, csr: CSR) -> bool:
        return (self.fingerprint is not None
                and self.fingerprint.matches(csr))

    # -- persistence ---------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "kind": "sharded_plan",
            "schema_version": self.schema_version,
            "axis": self.axis, "strategy": self.strategy,
            "params": dict(self.params),
            "mesh_shape": list(self.mesh_shape),
            "mesh_axis": self.mesh_axis,
            "batch": self.batch,
            "shards": [bp.to_dict() for bp in self.shards],
        }
        if self.fingerprint is not None:
            d["fingerprint"] = {k: (_finite_or_none(v)
                                    if isinstance(v, float) else v)
                                for k, v in asdict(self.fingerprint).items()}
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ShardedPlan":
        if not isinstance(d, dict):
            raise PlanError(f"ShardedPlan payload must be an object; "
                            f"got {type(d).__name__}")
        ver = d.get("schema_version")
        if ver != SHARDED_SCHEMA_VERSION:
            raise PlanSchemaError(
                f"unsupported ShardedPlan schema_version={ver!r}; this "
                f"build reads version {SHARDED_SCHEMA_VERSION}")
        try:
            fp = d.get("fingerprint")
            if fp is not None:
                fp = {k: (_nan_if_none(v) if k in ("mu", "sigma", "d_mat")
                          else v) for k, v in fp.items()}
            return ShardedPlan(
                shards=[BlockPlan.from_dict(b) for b in d["shards"]],
                axis=d["axis"], strategy=d["strategy"],
                params=dict(d.get("params", {})),
                mesh_shape=tuple(int(s) for s in d.get("mesh_shape", ())),
                mesh_axis=d.get("mesh_axis", "shards"),
                batch=int(d.get("batch", 1)),
                fingerprint=PlanFingerprint(**fp) if fp else None,
                schema_version=int(ver))
        except PlanError:
            raise
        except (KeyError, TypeError, ValueError) as e:
            raise PlanError(f"malformed ShardedPlan payload: {e!r}") from e

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, allow_nan=False)

    @staticmethod
    def from_json(s: str) -> "ShardedPlan":
        try:
            obj = json.loads(s)
        except json.JSONDecodeError as e:
            raise PlanError(f"ShardedPlan payload is not valid JSON: {e}") \
                from e
        return ShardedPlan.from_dict(obj)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @staticmethod
    def load(path: str) -> "ShardedPlan":
        with open(path) as f:
            return ShardedPlan.from_json(f.read())

    # -- binding -------------------------------------------------------------
    def bind(self, csr: CSR, **kw) -> Any:
        """Apply the sharded plan to a concrete matrix and return a
        :class:`~repro_torch.sharding.spmv.ShardedPlannedMatrix` serving
        ``P @ x`` / ``P @ X`` shard by shard.  A fingerprint mismatch
        keeps the recipe (axis, strategy, shard count, per-shard formats)
        but re-partitions on the new matrix; see
        :func:`repro_torch.sharding.spmv.build_sharded` (``mode``,
        ``devices``, ``device``, ``mesh``)."""
        from ..sharding.spmv import build_sharded
        csr.validate()
        return build_sharded(csr, plan=self, **kw)


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------
class Planner:
    """One call from CSR to a portable plan.

    ``rule``: ``"paper"`` (the D_mat < D* threshold rule — needs a
    TuningDB), ``"generalized"`` (argmin predicted total time over the
    db's formats), ``"cost_model"`` (measurement-free roofline model), or
    ``"auto"`` (generalized when a db is present, else cost model).

    ``tier``: ``"reference"`` | ``"kernel"`` | ``"auto"`` (kernel when a
    launch-geometry source — a tuner or a TuningDB with recorded
    geometries — is at hand, else reference).

    ``tuner``: a :class:`~repro_torch.core.kernel_tune.KernelTuner`, or
    any object with ``.tune(obj, op=, batch=, stats=)`` returning a record
    with ``.geometry``, and ``.records``.  It is handed the transformed
    matrix on the planner's device.

    ``device``: where the tuner times launches and :meth:`build` binds
    (``None`` = the CUDA device).

    ``strategy``: the partition strategy of a hybrid plan the rule picks
    by itself (``plan(partition=...)`` names one explicitly).

    ``lint``: run the static plan lint (``repro_torch.analyze.planlint``)
    on every plan minted; an error raises :class:`PlanError`.
    ``lint_smem_budget`` is its RPL004 budget, in bytes of shared memory a
    CUDA block (default: an H100's).

    >>> plan = Planner(db=db).plan(csr, expected_iterations=1000)
    >>> plan.save("plan.json")                 # portable artifact
    >>> P = ExecutionPlan.load("plan.json").bind(csr)
    >>> y = P @ x; Y = P @ X                   # SpMV and SpMM
    """

    def __init__(self, db: Optional[TuningDB] = None,
                 model: Optional[MachineModel] = None,
                 tuner: Optional[Any] = None,
                 policy: Optional[Any] = None,
                 rule: str = "auto", tier: str = "auto",
                 strategy: str = "variance", lint: bool = True,
                 lint_smem_budget: Optional[int] = None,
                 device: DeviceLike = None):
        self.db = db
        self.model = model
        self.tuner = tuner
        self.policy = policy
        self.rule = rule
        self.tier = tier
        self.strategy = strategy
        self.lint = lint
        self.lint_smem_budget = lint_smem_budget
        self.device = device

    def _self_check(self, plan):
        """Run the static plan lint (``repro_torch.analyze.planlint``) on
        every plan this planner mints — the artifact contract is enforced
        at the mint, not only on replay.  Lint errors are a planner bug, so
        they raise :class:`PlanError`; warnings only count/emit telemetry.
        Disable with ``Planner(lint=False)``."""
        if not self.lint:
            return plan
        from ..analyze.planlint import lint_plan as _lint_plan
        findings = _lint_plan(plan.to_dict(),
                              smem_budget=self.lint_smem_budget)
        if findings:
            errs = [f for f in findings if f.severity == "error"]
            tel = _obs.get()
            if tel.enabled:
                for f in findings:
                    tel.counter("plan.lint", rule=f.rule,
                                severity=f.severity).inc()
                tel.event("plan.lint", errors=len(errs),
                          warnings=len(findings) - len(errs),
                          first=findings[0].render())
            if errs:
                raise PlanError(
                    "planner self-check failed — the minted plan does "
                    "not satisfy the artifact contract:\n"
                    + "\n".join(f.render() for f in errs))
        return plan

    # -- decision ------------------------------------------------------------
    def _resolve_rule(self, rule: Optional[str]) -> str:
        rule = rule or self.rule
        if rule == "auto":
            return "generalized" if self.db is not None else "cost_model"
        return rule

    def _decide(self, stats: MatrixStats, rule: str,
                formats: Optional[Sequence[str]], k: int, batch: int):
        if rule == "paper":
            if self.db is None:
                raise PlanError("rule='paper' needs a TuningDB (the "
                                "off-line phase's D* thresholds)")
            return decide_paper(self.db, stats,
                                fmt=(formats or ("ell_row",))[0])
        if rule == "generalized":
            if self.db is None:
                raise PlanError("rule='generalized' needs a TuningDB")
            budget = (self.policy.budget_ratio if self.policy is not None
                      else float("inf"))
            return decide_generalized(self.db, stats, k, formats=formats,
                                      memory_budget_ratio=budget,
                                      batch=batch)
        if rule == "cost_model":
            return decide_cost_model(self.model or MachineModel(), stats, k,
                                     formats=formats or ("ell_row", "sell"),
                                     batch=batch)
        raise PlanError(f"unknown rule {rule!r}; one of "
                        "('paper', 'generalized', 'cost_model', 'auto')")

    def _resolve_tier(self, tier: Optional[str]) -> str:
        tier = tier or self.tier
        if tier == "auto":
            has_geo = (self.tuner is not None
                       or bool(getattr(self.db, "geometries", None)))
            return "kernel" if has_geo else "reference"
        if tier not in ("reference", "kernel"):
            raise PlanError(f"unknown tier {tier!r}")
        return tier

    # -- planning ------------------------------------------------------------
    def plan(self, csr: CSR, *, batch: int = 1,
             expected_iterations: int = 100, rule: Optional[str] = None,
             formats: Optional[Sequence[str]] = None,
             tier: Optional[str] = None, fmt: Optional[str] = None,
             partition: Optional[str] = None,
             **partition_kw) -> ExecutionPlan:
        """Decide, tune, and package: one call from a CSR matrix to a
        portable :class:`ExecutionPlan`.

        ``fmt`` forces the format (rule recorded as ``"fixed"``);
        ``partition`` forces a hybrid plan under the named partition
        strategy (extra ``partition_kw`` reach ``build_hybrid``)."""
        batch = max(int(batch), 1)
        k = max(int(expected_iterations), 1)
        stats = MatrixStats.of(csr)
        tier_used = self._resolve_tier(tier)
        rule_used = self._resolve_rule(rule)
        tel = _obs.get()

        with tel.span("plan.plan", rule=rule_used, tier=tier_used,
                      batch=batch, expected_iterations=k, n=stats.n,
                      nnz=stats.nnz, d_mat=stats.d_mat) as plan_span:
            if partition is not None:
                plan_span.set(fmt="hybrid")
                return self._self_check(
                    self._plan_hybrid(csr, stats, rule_used, batch, k,
                                      tier_used, strategy=partition,
                                      formats=formats, **partition_kw))
            if fmt is not None:
                chosen, rule_used = fmt, "fixed"
                d_star, gain = float("nan"), 0.0
                if tel.enabled:
                    # the rule paths emit inside decide_*; the forced-format
                    # path must still land on the decision table
                    tel.counter("plan.decisions", rule="fixed",
                                fmt=chosen).inc()
                    tel.event("plan.decision", rule="fixed", fmt=chosen,
                              d_mat=stats.d_mat, d_star=d_star,
                              expected_gain=gain)
            else:
                decision = self._decide(stats, rule_used, formats, k, batch)
                chosen = decision.fmt
                d_star, gain = decision.d_star, decision.expected_gain
            plan_span.set(fmt=chosen)
            if chosen == "hybrid":
                return self._self_check(
                    self._plan_hybrid(csr, stats, rule_used, batch, k,
                                      tier_used, strategy=self.strategy,
                                      formats=formats, **partition_kw))
            if partition_kw:
                # build_hybrid would raise on unknown kwargs; the leaf path
                # must not silently swallow them instead
                raise PlanError(
                    f"unexpected arguments {sorted(partition_kw)}: partition "
                    f"options apply only to hybrid plans (pass "
                    f"partition=...)")

            plan = ExecutionPlan(
                fmt=chosen, rule=rule_used, tier=tier_used, batch=batch,
                expected_iterations=k,
                transform=TransformRecipe(
                    chosen, dict(DEFAULT_RECIPE_PARAMS.get(chosen, {}))),
                fingerprint=PlanFingerprint.from_stats(stats,
                                                       _structure_sig(csr)),
                machine=self._machine(),
                d_mat=stats.d_mat, d_star=d_star, expected_gain=gain)
            if tier_used == "kernel":
                plan.geometry = self._tune_leaf(csr, stats, plan)
            return self._self_check(plan)

    def build(self, csr: CSR, **plan_kw) -> PlannedMatrix:
        """``plan(csr) .bind(csr)`` in one call."""
        return self.plan(csr, **plan_kw).bind(csr, db=self.db,
                                              device=self.device)

    def plan_or_load(self, csr: CSR, store: Any, **plan_kw
                     ) -> ExecutionPlan:
        """Check a :class:`~repro_torch.core.plan_store.PlanStore` before
        planning: a stored plan whose fingerprint matches ``csr`` (under
        the same planning knobs) replays with zero tuner invocations; a
        miss — or a corrupted/stale entry, which the store quarantines
        rather than raises — plans fresh and writes the result back, so
        the whole fleet tunes a structure once."""
        fp = PlanFingerprint.of(csr)
        key = store.key_for(fp, **plan_kw)
        cached = store.get(key, fingerprint=fp)
        if cached is not None:
            return cached
        plan = self.plan(csr, **plan_kw)
        store.put(key, plan)
        return plan

    def plan_sharded(self, csr: CSR, *, n_shards: int, axis: str = "row",
                     strategy: str = "balanced_nnz", batch: int = 1,
                     strategy_kw: Optional[Dict[str, Any]] = None,
                     **plan_kw) -> ShardedPlan:
        """Partition ``csr`` into ``n_shards`` slabs along ``axis`` and run
        :meth:`plan` independently on each — every shard gets its own
        format + launch geometry decision on *its* slab's statistics.  The
        slabs are cut from one host copy of the matrix.

        The result is a portable :class:`ShardedPlan`; bind it with
        :meth:`ShardedPlan.bind` (or hand it to ``SpMVService.register``)
        to serve it shard by shard."""
        from .transform import copy_out
        n_shards = int(n_shards)
        strategy_kw = dict(strategy_kw or {})
        tel = _obs.get()
        with tel.span("plan.plan_sharded", n_shards=n_shards, axis=axis,
                      strategy=strategy, nnz=csr.nnz) as sp:
            b = shard_boundaries(csr, n_shards, axis=axis,
                                 strategy=strategy, **strategy_kw)
            host = copy_out(csr)
            shards: List[BlockPlan] = []
            for s, e in zip(b[:-1], b[1:]):
                sub = slice_shard(host, int(s), int(e), axis=axis)
                shards.append(BlockPlan(
                    rows=(int(s), int(e)),
                    plan=self.plan(sub, batch=batch, **plan_kw)))
            if tel.enabled:
                nnzs = np.array([bp.plan.fingerprint.nnz for bp in shards],
                                dtype=np.float64)
                imbalance = float(nnzs.max() / max(nnzs.mean(), 1.0))
                tel.gauge("sharded.load_imbalance").set(imbalance)
                sp.set(imbalance=imbalance)
            stats = MatrixStats.of(csr)
            return self._self_check(ShardedPlan(
                shards=shards, axis=axis, strategy=strategy,
                params=strategy_kw, mesh_shape=(n_shards,), batch=batch,
                fingerprint=PlanFingerprint.from_stats(
                    stats, _structure_sig(csr))))

    def build_sharded(self, csr: CSR, **kw) -> Any:
        """``plan_sharded(csr) .bind(csr)`` in one call, on the planner's
        device."""
        bind_kw = {k: kw.pop(k) for k in ("mode", "devices", "mesh")
                   if k in kw}
        bind_kw.setdefault("device", self.device)
        return self.plan_sharded(csr, **kw).bind(csr, db=self.db, **bind_kw)

    def _machine(self) -> str:
        return self.db.machine if self.db is not None else "cost_model"

    def _ops_for(self, batch: int) -> Tuple[str, ...]:
        return ("spmv",) if batch <= 1 else ("spmv", "spmm")

    def _tune_leaf(self, csr: CSR, stats: MatrixStats,
                   plan: ExecutionPlan) -> Dict[str, TileGeometry]:
        """Launch geometry for a leaf plan: the tuner's real search when
        one is at hand, else the db's D_mat-keyed nearest recorded
        winner."""
        geometry: Dict[str, TileGeometry] = {}
        if self.tuner is not None:
            # the host recipe builds CPU tensors: tune where the plan will
            # serve, or the tuner times launches that never happen
            obj = plan.transform.apply(csr).to(resolve_device(self.device))
            # bind(csr) on the same source object reuses this instead of
            # paying the host transform a second time
            plan._mat_cache = (csr, obj)
            for op in self._ops_for(plan.batch):
                b = 1 if op == "spmv" else plan.batch
                try:
                    rec = self.tuner.tune(obj, op=op, batch=b, stats=stats)
                except (KeyError, TypeError):
                    continue
                geometry[op] = rec.geometry
        elif self.db is not None:
            for op in self._ops_for(plan.batch):
                b = 1 if op == "spmv" else plan.batch
                g = self.db.best_geometry(plan.fmt, stats.d_mat, op=op,
                                          batch=b)
                if g is not None:
                    geometry[op] = g
        return geometry

    def _plan_hybrid(self, csr: CSR, stats: MatrixStats, rule_used: str,
                     batch: int, k: int, tier: str, strategy: str,
                     sort_rows: Optional[bool] = None,
                     formats: Optional[Sequence[str]] = None,
                     **kw) -> ExecutionPlan:
        from ..partition.hybrid import build_hybrid
        if sort_rows is None:
            sort_rows = strategy == "variance"
        if formats is not None:
            # the caller's restriction applies per block; a block can't
            # nest another hybrid container
            kw["formats"] = tuple(f for f in formats if f != "hybrid")
        hyb, report = build_hybrid(
            csr, strategy=strategy, db=self.db,
            rule=("paper" if rule_used == "paper" else "auto"),
            model=self.model, policy=self.policy, expected_iterations=k,
            sort_rows=sort_rows, batch=batch, **kw)

        sub_plans = [d.plan for d in report.decisions]
        for sub in sub_plans:
            sub.tier = tier
            sub.machine = self._machine()
        if tier == "kernel":
            self._tune_blocks(hyb, sub_plans, batch)
        blocks = [BlockPlan(rows=d.rows, plan=sub)
                  for d, sub in zip(report.decisions, sub_plans)]
        params = {"strategy": strategy, "sort_rows": sort_rows, **kw}
        plan = ExecutionPlan(
            fmt="hybrid", rule=rule_used, tier=tier, batch=batch,
            expected_iterations=k,
            transform=TransformRecipe("hybrid", params),
            fingerprint=PlanFingerprint.from_stats(stats,
                                                   _structure_sig(csr)),
            machine=self._machine(),
            d_mat=stats.d_mat, d_star=float("nan"), blocks=blocks)
        # bind(csr) on the same source object reuses the container instead
        # of partitioning and transforming a second time
        plan._mat_cache = (csr, (hyb, report))
        return plan

    def _tune_blocks(self, hyb: Any, sub_plans: List[ExecutionPlan],
                     batch: int) -> None:
        """Per-block-format launch geometry, as the reference chooses it:
        one search per (op, format) on the biggest block of that format
        (moved to the planner's device, where the plan will serve), slab
        bounds re-derived over all sibling blocks, winner attached to every
        sub-plan of that format."""
        by_fmt = blocks_by_format(hyb)
        biggest = ({f: max(blks, key=lambda x: getattr(x, "nnz", 0)).to(
                        resolve_device(self.device))
                    for f, blks in by_fmt.items()}
                   if self.tuner is not None else {})
        for op in self._ops_for(batch):
            b = 1 if op == "spmv" else batch
            per_fmt: Dict[str, TileGeometry] = {}
            for f, blks in by_fmt.items():
                if self.tuner is not None:
                    try:
                        rec = self.tuner.tune(biggest[f], op=op, batch=b)
                    except (KeyError, TypeError):
                        continue
                    per_fmt[f] = rec.geometry
                elif self.db is not None:
                    d_mat = next((s.d_mat for s in sub_plans
                                  if s.fmt == f), 0.0)
                    g = self.db.best_geometry(f, d_mat, op=op, batch=b)
                    if g is not None:
                        per_fmt[f] = g
            per_fmt = rederive_slab_bounds(per_fmt, by_fmt)
            for sub in sub_plans:
                if sub.fmt in per_fmt:
                    sub.geometry[op] = per_fmt[sub.fmt]


__all__ = [
    "SCHEMA_VERSION", "DEFAULT_RECIPE_PARAMS",
    "PlanError", "PlanSchemaError", "PlanFingerprint", "TransformRecipe",
    "apply_transform", "BlockPlan", "ExecutionPlan", "PlannedMatrix",
    "Planner", "leaf_plan", "blocks_by_format", "bind_tunings",
    "rederive_slab_bounds", "SHARDED_SCHEMA_VERSION", "ShardedPlan",
    "shard_boundaries", "slice_shard",
]
