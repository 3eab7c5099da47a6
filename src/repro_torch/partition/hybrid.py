"""Partitioned hybrid-format SpMV: per-row-block auto-tuning.

The whole-matrix auto-tuner (core/autotune.py) answers "which single format
for this matrix"; one heavy row forces the answer to CRS.  This module
answers the finer question per row block: partition the (optionally
length-sorted) row space, compute per-block ``MatrixStats``, run the same
D_mat–R decision machinery *per block* under the same ``MemoryPolicy``
budget, and materialize a ``HybridMatrix`` — a container of per-block
format objects plus the row permutation.  SpMV dispatches each block to the
per-format implementations (at the kernel tier: each format's CUDA kernel)
and reassembles the output with plain torch ops.

Transformation time is accounted per block (``HybridReport``) and, because
``host_csr_to_hybrid`` is registered in ``core.transform.TRANSFORMS_HOST``,
the whole-pipeline cost is measured by ``offline_phase`` exactly like any
other format — R_hybrid feeds back into the D_mat–R graph.

The partition and the per-block transforms run on the host (numpy), as the
JAX package's do, and give the same arrays field by field; ``.to(device)``
moves the finished container.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..core import dispatch as _dispatch
from ..core.autotune import (MachineModel, TuningDB, decide_cost_model,
                             decide_generalized, decide_paper)
from ..core.formats import (CSR, MatrixStats, MatrixValidationError,
                            _TensorContainer, _np, memory_bytes)
from ..core.policy import MemoryPolicy
from ..core.transform import (TRANSFORMS_HOST, _t, copy_out,
                              pad_to_multiple)

from .strategies import PARTITIONERS

# formats a block may land in (csr = stay; no nested hybrid)
BLOCK_FORMATS = ("ell_row", "ell_col", "coo_row", "coo_col", "sell")


# ---------------------------------------------------------------------------
# the hybrid container
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class HybridMatrix(_TensorContainer):
    """Per-row-block storage: ``blocks[i]`` covers permuted rows
    ``row_offsets[i] : row_offsets[i] + blocks[i].n_rows`` and holds the
    format named by ``formats[i]``.  ``perm[i]`` = original row of permuted
    row i (identity when the partitioner did not sort).

    ``perm`` stays int32, the interchange type; its int64 index form
    (``perm_index``, what ``index_copy_`` takes) is made once, when the
    container is made or moved, never per product."""
    perm: torch.Tensor              # (n_rows,) permuted -> original row
    blocks: Tuple[Any, ...]         # CSR | COO | ELL | BucketedELL per block
    row_offsets: Tuple[int, ...]    # start (permuted) row per block
    formats: Tuple[str, ...]        # format name per block
    shape: Tuple[int, int]
    nnz: int
    identity_perm: bool = False     # True -> outputs just concatenate

    def __post_init__(self):
        object.__setattr__(self, "perm_index", self.perm.long())

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def block_rows(self, i: int) -> int:
        return int(self.blocks[i].n_rows)

    def format_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.formats:
            out[f] = out.get(f, 0) + 1
        return out

    def todense(self) -> np.ndarray:
        dense_blocks = [b.todense() for b in self.blocks]
        out = np.zeros(self.shape, dtype=dense_blocks[0].dtype)
        perm = _np(self.perm)
        for off, dense_b in zip(self.row_offsets, dense_blocks):
            out[perm[off:off + dense_b.shape[0]]] += dense_b
        return out

    def validate(self) -> "HybridMatrix":
        """Hybrid invariants: ``perm`` is a permutation (the identity where
        ``identity_perm``), one format name and offset per block, blocks
        tile the permuted row space contiguously over the full column
        space, each block passes its own ``validate``, and the block nnz
        sums to the whole.  Returns ``self``."""
        perm = _np(self.perm)
        if perm.ndim != 1 or perm.shape[0] != self.n_rows:
            raise MatrixValidationError(
                f"perm must have shape ({self.n_rows},); got {perm.shape}")
        if not np.issubdtype(perm.dtype, np.integer):
            raise MatrixValidationError(
                f"perm must be an integer array; got dtype {perm.dtype}")
        ident = np.arange(self.n_rows, dtype=perm.dtype)
        if not np.array_equal(np.sort(perm), ident):
            raise MatrixValidationError(
                "perm is not a permutation of the row indices")
        if self.identity_perm and not np.array_equal(perm, ident):
            raise MatrixValidationError(
                "identity_perm is set but perm is not the identity")
        if not self.blocks:
            raise MatrixValidationError("hybrid container has no blocks")
        if not (len(self.blocks) == len(self.formats)
                == len(self.row_offsets)):
            raise MatrixValidationError(
                f"{len(self.blocks)} blocks, {len(self.formats)} formats "
                f"and {len(self.row_offsets)} row offsets")
        end = 0
        for i, (off, b, f) in enumerate(zip(self.row_offsets, self.blocks,
                                            self.formats)):
            if off != end:
                raise MatrixValidationError(
                    f"block {i} starts at permuted row {off}, expected "
                    f"{end} (blocks must tile contiguously)")
            if f == "hybrid" or _dispatch.format_of(b) != f:
                raise MatrixValidationError(
                    f"block {i} is a {type(b).__name__}, recorded as {f!r}")
            if b.shape[1] != self.n_cols:
                raise MatrixValidationError(
                    f"block {i} spans {b.shape[1]} columns, expected "
                    f"{self.n_cols}")
            b.validate()
            end = off + b.n_rows
        if end != self.n_rows:
            raise MatrixValidationError(
                f"blocks cover {end} permuted rows, expected {self.n_rows}")
        if sum(b.nnz for b in self.blocks) != self.nnz:
            raise MatrixValidationError(
                f"block nnz sums to {sum(b.nnz for b in self.blocks)}, "
                f"expected {self.nnz}")
        return self


# ---------------------------------------------------------------------------
# CSR row-slicing (host)
# ---------------------------------------------------------------------------
def take_rows_csr(m: CSR, rows: np.ndarray, pad: int = 8) -> CSR:
    """Sub-CSR over an arbitrary (ordered) row subset; full column space."""
    ip = _np(m.indptr)
    rows = np.asarray(rows)
    lens = (ip[1:] - ip[:-1])[rows]
    nnz = int(lens.sum())
    indptr = np.zeros(len(rows) + 1, dtype=np.int32)
    np.cumsum(lens, out=indptr[1:])
    src_d, src_c = _np(m.data), _np(m.cols)
    data = np.zeros(max(pad_to_multiple(nnz, pad), pad), dtype=src_d.dtype)
    cols = np.zeros_like(data, dtype=np.int32)
    if nnz:
        # each row's [start, start+len) span, packed in row order: output
        # slot k of row i reads source slot start_i + (k - indptr_i)
        shift = ip[rows].astype(np.int64) - indptr[:-1]
        idx = np.arange(nnz, dtype=np.int64) + np.repeat(shift, lens)
        data[:nnz] = src_d[idx]
        cols[:nnz] = src_c[idx]
    return CSR(data=_t(data, m.data), cols=_t(cols), indptr=_t(indptr),
               shape=(len(rows), m.n_cols), nnz=nnz)


def slice_csr_cols(m: CSR, c0: int, c1: int, pad: int = 8) -> CSR:
    """Column slab [c0, c1): keep entries whose column falls in the slab,
    rebased to column 0 — the column-sharding analogue of ``slice_csr``.
    Full row space (every shard of a column-sharded matrix owns all rows
    and contributes a partial y that is sum-reduced)."""
    ip = _np(m.indptr)
    data = _np(m.data)[:m.nnz]
    cols = _np(m.cols)[:m.nnz]
    lens = (ip[1:] - ip[:-1]).astype(np.int64)
    rows = np.repeat(np.arange(m.n_rows, dtype=np.int64), lens)
    sel = (cols >= c0) & (cols < c1)
    d, c, r = data[sel], cols[sel] - c0, rows[sel]  # stays row-major sorted
    nnz = int(d.size)
    new_lens = np.bincount(r, minlength=m.n_rows)
    indptr = np.zeros(m.n_rows + 1, dtype=np.int32)
    np.cumsum(new_lens, out=indptr[1:])
    nnz_pad = max(pad_to_multiple(nnz, pad), pad)
    dd = np.zeros(nnz_pad, dtype=data.dtype)
    cc = np.zeros(nnz_pad, dtype=np.int32)
    dd[:nnz], cc[:nnz] = d, c
    return CSR(data=_t(dd, m.data), cols=_t(cc), indptr=_t(indptr),
               shape=(m.n_rows, c1 - c0), nnz=nnz)


def slice_csr(m: CSR, r0: int, r1: int, pad: int = 8) -> CSR:
    """Contiguous row slice [r0, r1) — O(block nnz) views + one copy."""
    ip = _np(m.indptr)
    s, e = int(ip[r0]), int(ip[r1])
    nnz = e - s
    data = _np(m.data)[s:e]
    cols = _np(m.cols)[s:e]
    nnz_pad = max(pad_to_multiple(nnz, pad), pad)
    d = np.zeros(nnz_pad, dtype=data.dtype)
    c = np.zeros(nnz_pad, dtype=np.int32)
    d[:nnz], c[:nnz] = data, cols
    return CSR(data=_t(d, m.data), cols=_t(c),
               indptr=_t((ip[r0:r1 + 1] - s).astype(np.int32)),
               shape=(r1 - r0, m.n_cols), nnz=nnz)


# ---------------------------------------------------------------------------
# per-block decision (reuses core/autotune + core/policy)
# ---------------------------------------------------------------------------
def choose_block_format(stats: MatrixStats,
                        db: Optional[TuningDB] = None,
                        rule: str = "auto",
                        model: Optional[MachineModel] = None,
                        policy: Optional[MemoryPolicy] = None,
                        expected_iterations: int = 100,
                        formats: Sequence[str] = BLOCK_FORMATS,
                        batch: int = 1) -> str:
    """One block's format via the same machinery as the whole-matrix tuner.

    Candidates are first filtered by the memory policy (estimate vs the
    block's own CSR estimate), then ranked by the paper rule, the
    generalized DB prediction, or the roofline cost model.  ``batch`` is
    the expected RHS count per call — amortization runs over
    ``expected_iterations * batch`` products."""
    policy = policy or MemoryPolicy()
    csr_bytes = max(policy.estimate_bytes("csr", stats), 1)

    def fits(f: str) -> bool:
        b = policy.estimate_bytes(f, stats)
        ok = b <= policy.budget_ratio * csr_bytes
        if policy.hard_bytes:
            ok = ok and b <= policy.hard_bytes
        return ok

    cand = [f for f in formats if fits(f)]
    if not cand:
        return "csr"
    if db is not None and rule == "paper":
        return decide_paper(db, stats).fmt if "ell_row" in cand else "csr"
    if db is not None:
        return decide_generalized(db, stats, expected_iterations,
                                  formats=cand,
                                  memory_budget_ratio=policy.budget_ratio,
                                  batch=batch).fmt
    return decide_cost_model(model or MachineModel(), stats,
                             expected_iterations, formats=cand,
                             batch=batch).fmt


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------
@dataclass
class BlockDecision:
    """One row block's outcome.  ``plan`` is the leaf
    :class:`~repro_torch.core.plan.ExecutionPlan` for the block — the
    portable decision artifact (format + transform recipe + fingerprint)
    that the Planner composes into whole-matrix hybrid plans; ``fmt`` is
    kept as the flat view of ``plan.fmt``."""
    fmt: str
    rows: Tuple[int, int]       # [start, end) in the permuted row space
    d_mat: float
    nnz: int
    bytes: int
    t_transform: float
    plan: Optional[Any] = None  # core.plan.ExecutionPlan (leaf)


@dataclass
class HybridReport:
    strategy: str
    n_blocks: int
    t_partition: float
    t_transform: float          # total per-block materialization seconds
    decisions: List[BlockDecision] = field(default_factory=list)

    def format_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.decisions:
            out[d.fmt] = out.get(d.fmt, 0) + 1
        return out


def build_hybrid(m: CSR,
                 strategy: str = "variance",
                 db: Optional[TuningDB] = None,
                 rule: str = "auto",
                 model: Optional[MachineModel] = None,
                 policy: Optional[MemoryPolicy] = None,
                 expected_iterations: int = 100,
                 sort_rows: Optional[bool] = None,
                 formats: Sequence[str] = BLOCK_FORMATS,
                 batch: int = 1,
                 **strategy_kw) -> Tuple[HybridMatrix, HybridReport]:
    """Partition -> per-block stats -> per-block decision -> materialize.

    ``sort_rows`` (default: True for the variance strategy) length-sorts the
    row space first so contiguous blocks are homogeneous — the sigma-sort of
    SELL-C-sigma lifted to the whole decision problem.  The container holds
    CPU tensors whatever ``m``'s device (``.to(device)`` moves it)."""
    if strategy not in PARTITIONERS:
        raise KeyError(f"unknown strategy {strategy!r}; "
                       f"one of {sorted(PARTITIONERS)}")
    if sort_rows is None:
        sort_rows = strategy == "variance"
    m = copy_out(m)      # one copy, not one a block
    lens = m.row_lengths().astype(np.int64)

    t0 = time.perf_counter()
    if sort_rows:
        perm = np.argsort(-lens, kind="stable").astype(np.int32)
    else:
        perm = np.arange(m.n_rows, dtype=np.int32)
    boundaries = PARTITIONERS[strategy](lens[perm], **strategy_kw)
    t_partition = time.perf_counter() - t0

    # per-block decisions ship as leaf ExecutionPlans (portable artifacts
    # the Planner composes into whole-matrix hybrid plans)
    from ..core.plan import leaf_plan
    rule_used = ("paper" if db is not None and rule == "paper"
                 else "generalized" if db is not None else "cost_model")

    blocks: List[Any] = []
    fmts: List[str] = []
    offsets: List[int] = []
    decisions: List[BlockDecision] = []
    t_transform = 0.0
    for s, e in zip(boundaries[:-1], boundaries[1:]):
        s, e = int(s), int(e)
        sub = (slice_csr(m, s, e) if not sort_rows
               else take_rows_csr(m, perm[s:e]))
        stats = MatrixStats.of(sub)
        fmt = choose_block_format(stats, db=db, rule=rule, model=model,
                                  policy=policy,
                                  expected_iterations=expected_iterations,
                                  formats=formats, batch=batch)
        t1 = time.perf_counter()
        obj = TRANSFORMS_HOST[fmt](sub)
        dt = time.perf_counter() - t1
        t_transform += dt
        blocks.append(obj)
        fmts.append(fmt)
        offsets.append(s)
        decisions.append(BlockDecision(
            fmt=fmt, rows=(s, e), d_mat=stats.d_mat, nnz=stats.nnz,
            bytes=memory_bytes(obj), t_transform=dt,
            plan=leaf_plan(sub, stats, fmt, rule_used, batch=batch,
                           expected_iterations=expected_iterations,
                           machine=db.machine if db is not None else "")))

    hyb = HybridMatrix(perm=_t(perm), blocks=tuple(blocks),
                       row_offsets=tuple(offsets), formats=tuple(fmts),
                       shape=m.shape, nnz=m.nnz,
                       identity_perm=not sort_rows)
    report = HybridReport(strategy=strategy, n_blocks=len(blocks),
                          t_partition=t_partition, t_transform=t_transform,
                          decisions=decisions)
    return hyb, report


def host_csr_to_hybrid(m: CSR, strategy: str = "variance",
                       **kw) -> HybridMatrix:
    """``TRANSFORMS_HOST``-compatible entry point (cost-model decisions when
    no TuningDB is supplied).  ``offline_phase`` times this call as a whole,
    so R_hybrid lands on the D_mat–R graph like any other transformation."""
    hyb, _ = build_hybrid(m, strategy=strategy, **kw)
    return hyb


# ---------------------------------------------------------------------------
# execution — per-block implementations resolved through core/dispatch
# ---------------------------------------------------------------------------
def _block_impl(fmt: str, op: str,
                impls: Optional[Dict[str, Callable]]) -> Callable:
    fn = (impls or {}).get(fmt)
    return fn if fn is not None else _dispatch.get_impl(fmt, op)


def _block_products(m: HybridMatrix, op: str,
                    impls: Optional[Dict[str, Callable]],
                    x: torch.Tensor) -> List[torch.Tensor]:
    """Each block's product, in block order; with telemetry on, each in a
    ``hybrid.block`` span timed on the card."""
    tel = _obs.get()
    outs = []
    for fmt, b in zip(m.formats, m.blocks):
        fn = _block_impl(fmt, op, impls)
        if tel.enabled:
            with tel.span("hybrid.block", on=x, fmt=fmt,
                          rows=int(b.shape[0]), nnz=int(b.nnz)):
                outs.append(fn(b, x))
        else:
            outs.append(fn(b, x))
    return outs


def _reassemble(m: HybridMatrix, outs: List[torch.Tensor]) -> torch.Tensor:
    """The blocks' outputs in permuted row order -> ``A @ x`` rows: one
    concatenation in the promoted dtype of the blocks' outputs (SELL blocks
    give ``x``'s dtype, the others the promoted one, as in the reference),
    then, unless the permutation is the identity, one scatter into zeros."""
    dt = functools.reduce(torch.promote_types, [o.dtype for o in outs])
    y = (torch.cat([o.to(dt) for o in outs], dim=0) if len(outs) > 1
         else outs[0])
    if m.identity_perm:
        return y
    return torch.zeros_like(y).index_copy_(0, m.perm_index, y)


def spmv_hybrid(m: HybridMatrix, x: torch.Tensor,
                impls: Optional[Dict[str, Callable]] = None) -> torch.Tensor:
    """y = A @ x: each block through its format's SpMV, then reassemble.

    ``impls`` maps format name -> callable(block, x) (e.g. the kernel-tier
    wrappers in ``kernels/ops.py``); formats not overridden resolve to the
    reference tier of the ``core/dispatch`` registry."""
    return _reassemble(m, _block_products(m, "spmv", impls, x))


def spmm_hybrid(m: HybridMatrix, x: torch.Tensor,
                impls: Optional[Dict[str, Callable]] = None) -> torch.Tensor:
    """Multi-vector RHS: x (n_cols, B) -> (n_rows, B) — each block's own
    SpMM, reassembling the (rows, B) panels through the row permutation."""
    return _reassemble(m, _block_products(m, "spmm", impls, x))


# the hybrid container is a first-class format: one registration here is
# the only place it is wired into the reference tier of the dispatch stack
_dispatch.register_format("hybrid", HybridMatrix)
_dispatch.register_impl("hybrid", "spmv", spmv_hybrid)
_dispatch.register_impl("hybrid", "spmm", spmm_hybrid)


__all__ = ["BLOCK_FORMATS", "HybridMatrix", "BlockDecision", "HybridReport",
           "take_rows_csr", "slice_csr", "slice_csr_cols",
           "choose_block_format", "build_hybrid", "host_csr_to_hybrid",
           "spmv_hybrid", "spmm_hybrid"]
