"""Kernel launch-geometry auto-tuning: the paper's auto-tuner stops at format
selection; this module extends it down to the launch of each CUDA kernel.

  * :class:`TileGeometry` — the knobs every kernel wrapper in
    ``kernels/ops.py`` accepts per call (``tuning=``).  The fields are
    exactly the JAX package's, because plan and TuningDB JSON interchange
    both ways and that package's loader rejects unknown fields.  The CUDA
    wrappers read ``block_rows`` (rows, CCS columns or BCSR block rows per
    CUDA block), ``block_nnz`` (entries per CUDA block) and ``block_k``
    (right-hand-side columns per CUDA block, SpMM); ``block_w`` and
    ``slabs_per_block`` ride along for the schema.
  * :func:`candidate_geometries` — the bounded per-(format, op) search grid
    over those three knobs, de-duplicated on the launch each candidate
    actually makes (threads per block, rows or entries per block, column
    tile), so the tuner never times the same launch twice.
  * :class:`KernelTuner` — times real launches per candidate (CUDA events
    on the card), memoizes the winner per ``(format, op, batch, matrix
    profile)``, records into a :class:`~repro_torch.core.autotune.TuningDB`
    and answers unseen matrices with the D_mat-keyed
    :func:`nearest_geometry`.

The timing loop is injectable (``timer=``) so tests tune deterministically
without a clock or a card.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import asdict, dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs as _obs
from . import dispatch as _dispatch
from .formats import CCS, CSR, MatrixStats, _np

__all__ = ["TileGeometry", "GeometryRecord", "GRID_FORMATS",
           "candidate_geometries", "nearest_geometry", "KernelTuner"]


# ---------------------------------------------------------------------------
# the geometry record-of-knobs
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TileGeometry:
    """Per-call launch geometry; ``None`` fields fall back to the wrapper's
    built-in default.  Hashable.

    ``block_rows`` is the *segmented-axis* tile: rows per block for
    ELL/CSR, columns for CCS, block rows for BCSR.

    ``buckets`` is the SELL per-bucket table: ``((width, TileGeometry),
    ...)`` pairs keyed by bucket *width*, so one persisted geometry carries
    a different launch for every bucket of the container.  Bucket widths
    absent from the table fall back to the top-level knobs."""
    block_rows: Optional[int] = None   # rows (CCS: columns, BCSR: block rows) per block
    block_w: Optional[int] = None      # ELL band tile (schema only)
    block_k: Optional[int] = None      # SpMM right-hand-side columns per block
    block_nnz: Optional[int] = None    # COO entries per block
    slabs_per_block: Optional[int] = None  # CSR/CCS/BCSR coverage bound (schema only)
    buckets: Optional[Tuple[Tuple[int, "TileGeometry"], ...]] = None  # SELL

    _KNOBS = ("block_rows", "block_w", "block_k", "block_nnz",
              "slabs_per_block")

    def to_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in self._KNOBS
             if getattr(self, k) is not None}
        if self.buckets is not None:
            d["buckets"] = [[w, g.to_dict()] for w, g in self.buckets]
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TileGeometry":
        d = dict(d)
        buckets = d.pop("buckets", None)
        g = TileGeometry(**d)
        if buckets is not None:
            g = replace(g, buckets=tuple(
                (int(w), TileGeometry.from_dict(gd)) for w, gd in buckets))
        return g

    def broadcast(self) -> "TileGeometry":
        """The top-level knobs alone (per-bucket table stripped) — what a
        bucket whose width is missing from the table launches with."""
        return replace(self, buckets=None)

    def without_slab_bound(self) -> "TileGeometry":
        """Strip the matrix-specific coverage bound (through the per-bucket
        table too) — done whenever a geometry learned on one matrix is
        applied to another."""
        buckets = self.buckets
        if buckets is not None:
            buckets = tuple((w, g.without_slab_bound()) for w, g in buckets)
        return replace(self, slabs_per_block=None, buckets=buckets)


@dataclass
class GeometryRecord:
    """One tuning outcome: the winning geometry for (format, op, batch) on
    a matrix profile, plus the measured win over the default launch.

    ``sig`` fingerprints the index structure (CRC of the pointer array).
    ``bucket_w`` marks a SELL per-bucket component record; ``None`` is a
    whole-matrix record, and only those feed the nearest-neighbour lookup."""
    fmt: str
    op: str
    batch: int
    n: int
    nnz: int
    d_mat: float
    geometry: TileGeometry
    t_best: float
    t_default: float
    sig: int = 0
    bucket_w: Optional[int] = None

    @property
    def speedup(self) -> float:
        return self.t_default / self.t_best if self.t_best > 0 else 1.0

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["geometry"] = self.geometry.to_dict()
        if self.bucket_w is None:
            d.pop("bucket_w")
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "GeometryRecord":
        d = dict(d)
        d["geometry"] = TileGeometry.from_dict(d["geometry"])
        return GeometryRecord(**d)


def _align8(n: int) -> int:
    return max(8, 8 * ((int(n) + 7) // 8))


# ---------------------------------------------------------------------------
# nearest-neighbour lookup over recorded geometries
# ---------------------------------------------------------------------------
def nearest_geometry(records: Sequence[GeometryRecord], fmt: str,
                     op: str = "spmv", d_mat: float = 0.0,
                     batch: Optional[int] = None) -> Optional[TileGeometry]:
    """D_mat-keyed (log-space) nearest neighbour among recorded winners.

    The returned geometry is stripped of its slab-coverage bound — that
    bound is only valid for the matrix it was measured on.  SELL
    per-bucket component records (``bucket_w`` set) are skipped: the
    whole-matrix aggregate already carries the composed bucket table."""
    recs = [r for r in records if r.fmt == fmt and r.op == op
            and getattr(r, "bucket_w", None) is None]
    if batch is not None:
        exact = [r for r in recs if r.batch == batch]
        recs = exact or recs
    if not recs:
        return None
    q = np.log(max(d_mat, 1e-9))
    best = min(recs, key=lambda r: abs(np.log(max(r.d_mat, 1e-9)) - q))
    return best.geometry.without_slab_bound()


def _structure_sig(obj: Any) -> int:
    """CRC fingerprint of the index-pointer structure (0 when the object has
    none).  Computed over the int32 pointer bytes on the host, so it equals
    the JAX package's fingerprint of the same matrix."""
    ip = getattr(obj, "indptr", None)
    if ip is None:
        return 0
    return zlib.crc32(np.ascontiguousarray(_np(ip)).tobytes()) or 1


# ---------------------------------------------------------------------------
# the bounded search grid (CUDA launches)
# ---------------------------------------------------------------------------
#: rows per CUDA block (ELL, SELL buckets, CSR; CCS columns, BCSR block
#: rows); the block holds that many rows times the lanes the wrapper gives
#: a row (BCSR SpMV: times b), clamped to 1024 threads (CCS SpMV: up to 8
#: warps, each a run of the columns)
GPU_ROW_TILES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
#: entries per CUDA block (COO; the slice of a CSR SpMV block)
GPU_NNZ_TILES = (256, 1024, 4096, 16384)
#: right-hand-side columns per CUDA block (SpMM), clamped to the batch
GPU_K_TILES = (8, 32, 128)

#: every format with a CUDA kernel and a candidate grid below — the kernel
#: tier's tunable surface
GRID_FORMATS = ("ell_row", "ell_col", "sell", "coo_row", "coo_col", "csr",
                "ccs", "bcsr")


def _lanes_per_row(fmt: str, op: str, width: int, batch: int,
                   block_k: Optional[int]) -> int:
    """Threads the wrapper gives one row (ELL, SELL bucket, CSR SpMM; a CCS
    column and a BCSR block row in SpMM), from the same helpers the wrappers
    call.  CSR SpMV cuts its work by entries, CCS SpMV by runs of columns a
    warp: no lane group."""
    from ..kernels import _common as C
    if op == "spmm":
        return C.rhs_tile(batch, block_k)[1]
    # ELL-Row and SELL buckets are row-major (a one-slot band has strides
    # (1, 1) and is not); ELL-Col is column-major
    return C.ell_spmv_lanes(width, row_major=fmt != "ell_col" and width > 1)


def candidate_geometries(fmt: str, op: str = "spmv", *, n_rows: int = 0,
                         width: int = 0, nnz_pad: int = 0,
                         batch: int = 1) -> List[TileGeometry]:
    """The bounded launch-geometry grid for one (format, op).

    Only knobs a CUDA wrapper reads are searched: ``block_rows`` (ELL, SELL,
    CSR SpMM, CCS, BCSR), ``block_nnz`` (COO, CSR SpMV) and, for SpMM,
    ``block_k``.  Each
    candidate holds the values its launch actually takes — rows per block as
    the whole warps the wrapper rounds to at its lane count (at most 1024
    threads, at most the matrix's rows; CCS SpMV: columns per block rounded
    to whole runs a warp of two columns or more, at most 1024 and about the
    column count),
    entries per block at most
    ``nnz_pad``, columns per block at most the batch — so de-duplicating
    the candidates de-duplicates the launches and the tuner never times the
    same launch twice.  ``n_rows`` is the segmented axis: the column count
    for CCS, the block-row count for BCSR; ``width`` is BCSR's block size
    b."""
    from ..kernels._common import (CCS_SPMV_WARPS, bcsr_spmv_launch,
                                   ccs_spmv_launch, rhs_tile, rows_per_block)
    if fmt not in GRID_FORMATS:
        return []
    batch = max(int(batch), 1)
    ks = ([rhs_tile(batch, k)[0] for k in GPU_K_TILES] if op == "spmm"
          else [None])
    geoms: List[TileGeometry] = []
    for k in ks:
        if fmt.startswith("coo") or (fmt == "csr" and op == "spmv"):
            geoms.extend(TileGeometry(block_nnz=min(bn, nnz_pad or bn),
                                      block_k=k) for bn in GPU_NNZ_TILES)
            continue
        if fmt == "ccs" and op == "spmv":
            # columns per block, shared out to warps in equal runs of two
            # columns or more: shorter runs were 3-6x slower on the card
            # (PERF.md §6)
            cap = min(1024, n_rows) if n_rows else 1024
            geoms.extend(TileGeometry(block_rows=ccs_spmv_launch(
                n_rows, n_rows, nnz_pad, min(r, cap))[1])
                for r in GPU_ROW_TILES if r >= 2 * CCS_SPMV_WARPS)
            continue
        if fmt == "bcsr" and op == "spmv":
            # a thread per scalar row: block_rows * b threads per block
            b = width or 8
            cap = max(1, 1024 // b)
            if n_rows:
                cap = min(cap, n_rows)
            geoms.extend(
                TileGeometry(block_rows=bcsr_spmv_launch(b, min(r, cap))[1])
                for r in GPU_ROW_TILES)
            continue
        lanes = _lanes_per_row(fmt, op, width, batch, k)
        cap = 1024 // lanes
        if n_rows:
            cap = min(cap, n_rows)
        geoms.extend(
            TileGeometry(block_rows=rows_per_block(lanes, min(r, cap)),
                         block_k=k) for r in GPU_ROW_TILES)
    return list(dict.fromkeys(geoms))


# ---------------------------------------------------------------------------
# matrix profiling (best effort per format)
# ---------------------------------------------------------------------------
def _profile_of(obj: Any, stats: Optional[MatrixStats] = None
                ) -> Tuple[int, int, float, int]:
    sig = _structure_sig(obj)
    if stats is not None:
        return int(stats.n), int(stats.nnz), float(stats.d_mat), sig
    n = int(getattr(obj, "n_rows", 0))
    nnz = int(getattr(obj, "nnz", 0))
    d_mat = 0.0
    if isinstance(obj, CSR):
        d_mat = float(MatrixStats.of(obj).d_mat)
    elif isinstance(obj, CCS):
        # the column-space analogue: nnz-per-column variation is what
        # shapes the column-grouped launch
        lens = np.diff(_np(obj.indptr)).astype(np.float64)
        mu = float(lens.mean()) if lens.size else 0.0
        d_mat = float(lens.std() / mu) if mu > 0 else 0.0
    return n, nnz, d_mat, sig


def _width_of(obj: Any) -> int:
    """ELL's band width, SELL's widest bucket, BCSR's block size."""
    w = getattr(obj, "width", getattr(obj, "block", None))
    if w is not None:
        return int(w)
    widths = getattr(obj, "widths", None)   # BucketedELL
    if widths:
        return int(max(widths))
    return 0


def _slab_bound_for(obj: Any, g: TileGeometry) -> Optional[int]:
    """The reference's slab-coverage bound for a CSR/CCS/BCSR candidate
    (for CCS over the column pointer, for BCSR over the block IRP, with
    BCSR's own 32/512 defaults), recorded in the winner for plan-JSON
    parity (no CUDA kernel reads it)."""
    ip = getattr(obj, "indptr", None)
    if ip is None:
        return None
    from ..kernels.csr_spmv import slabs_needed
    segmented = isinstance(obj, (CSR, CCS))
    br = g.block_rows or (256 if segmented else 32)
    bn = g.block_nnz or (2048 if segmented else 512)
    return slabs_needed(_np(ip), br, bn)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------
def _real_timer(iters: int, warmup: int) -> Callable:
    """Best of ``iters`` of one launch: CUDA events behind a head start
    that outlasts the host's enqueue (:func:`~.autotune.time_device`) when
    the launch ran on a card, ``perf_counter`` on the host otherwise."""
    from .autotune import time_device

    def timer(thunk: Callable[[], Any], geometry: Optional[TileGeometry]
              ) -> float:
        out = thunk()            # first warm-up call; says where it ran
        for _ in range(warmup - 1):
            thunk()
        dev = getattr(out, "device", torch.device("cpu"))
        if dev.type != "cuda":
            best = float("inf")
            for _ in range(max(iters, 1)):
                t0 = time.perf_counter()
                thunk()
                best = min(best, time.perf_counter() - t0)
            return best
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            return min(time_device(thunk) for _ in range(max(iters, 1)))
    return timer


class KernelTuner:
    """Searches :func:`candidate_geometries` by timing real launches.

    ``db``: an :class:`~repro_torch.core.autotune.TuningDB` to read and
    record geometry winners in (its ``geometries`` list is shared, so
    saving the db persists the tuner's work).  ``timer(thunk, geometry) ->
    seconds`` is injectable for deterministic tests.  ``interpret`` is
    accepted for signature parity with the JAX package and ignored: a CUDA
    kernel has no interpret mode.
    """

    def __init__(self, db: Optional[Any] = None,
                 interpret: Optional[bool] = None,
                 iters: int = 3, warmup: int = 1,
                 timer: Optional[Callable] = None,
                 max_candidates: Optional[int] = None):
        self.db = db
        self.interpret = interpret
        self.records: List[GeometryRecord] = (
            db.geometries if db is not None
            and getattr(db, "geometries", None) is not None else [])
        if db is not None and getattr(db, "geometries", None) is None:
            db.geometries = self.records
        self._timer = timer or _real_timer(iters, warmup)
        self.max_candidates = max_candidates
        # memo maps key -> *index* into self.records, so a forced re-tune
        # replaces the superseded record in place instead of accumulating
        # duplicates in the shared (persisted) list
        self._memo: Dict[Tuple, int] = self._build_memo()

    def _build_memo(self) -> Dict[Tuple, int]:
        memo = {
            self._key(r.fmt, r.op, r.batch, (r.n, r.nnz, r.d_mat, r.sig),
                      getattr(r, "bucket_w", None)): i
            for i, r in enumerate(self.records)}
        if len(memo) != len(self.records):
            # a db persisted before re-tunes replaced in place can carry
            # stale duplicates; keep the last record per key (the freshest
            # winner) — compact through the slice so the db's list alias
            # heals too
            self.records[:] = [self.records[i] for i in sorted(memo.values())]
            return self._build_memo()
        return memo

    @staticmethod
    def _key(fmt: str, op: str, batch: int,
             profile: Tuple[int, int, float, int],
             bucket_w: Optional[int] = None):
        return (fmt, op, batch, profile[0], profile[1],
                round(profile[2], 6), profile[3], bucket_w)

    def _record(self, key: Tuple, rec: GeometryRecord) -> GeometryRecord:
        """Memoize ``rec`` under ``key``, replacing any superseded record
        in place (one record per key across forced re-tunes; ``records``
        stays aliased with the db's list)."""
        idx = self._memo.get(key)
        if idx is None:
            self._memo[key] = len(self.records)
            self.records.append(rec)
        else:
            self.records[idx] = rec
        tel = _obs.get()
        if tel.enabled:
            attrs = dict(fmt=rec.fmt, op=rec.op, batch=rec.batch,
                         t_best=rec.t_best, t_default=rec.t_default,
                         speedup=rec.speedup,
                         geometry=rec.geometry.to_dict())
            if rec.bucket_w is not None:
                attrs["bucket_w"] = rec.bucket_w
            tel.event("tune.winner", **attrs)
        return rec

    # -- search --------------------------------------------------------------
    def tune(self, obj: Any, op: str = "spmv", batch: int = 1,
             impl: Optional[Callable] = None, x: Optional[torch.Tensor] = None,
             stats: Optional[MatrixStats] = None,
             force: bool = False) -> GeometryRecord:
        """Time every candidate launch of ``obj``'s kernel and return (and
        memoize) the winner.  The default launch is always a candidate, so
        ``t_best <= t_default`` by construction.  ``x`` defaults to ones on
        ``obj``'s device.

        SELL containers are tuned *per bucket*: each bucket width gets its
        own candidate sweep (timed on that bucket's ELL launch alone), the
        per-width winners are memoized as component records, and the
        returned aggregate's geometry composes them into a
        ``TileGeometry.buckets`` table."""
        fmt = _dispatch.format_of(obj)
        profile = _profile_of(obj, stats)
        batch = max(batch, 1)
        key = self._key(fmt, op, batch, profile)
        idx = self._memo.get(key)
        if not force and idx is not None:
            tel = _obs.get()
            if tel.enabled:
                tel.counter("tune.memo_hit", fmt=fmt, op=op).inc()
            return self.records[idx]

        if impl is None:
            impl = _dispatch.get_impl(fmt, op, tier="kernel", fallback=False)
        if x is None:
            shape = (obj.n_cols,) if op == "spmv" else (obj.n_cols, batch)
            x = torch.ones(shape, dtype=torch.float32, device=obj.device)

        if fmt == "sell":
            with _obs.span("tune.sweep", fmt=fmt, op=op, batch=batch,
                           d_mat=profile[2]):
                return self._tune_sell(obj, op, batch, impl, x, profile,
                                       key, force)

        cands: List[Optional[TileGeometry]] = [None]
        if fmt == "ccs":
            # the segmented axis is the *column* axis
            grid_rows = int(getattr(obj, "n_cols", 0) or 0)
        else:
            # BCSR row tiles count *block* rows; everything else scalar rows
            grid_rows = int(getattr(obj, "n_block_rows", profile[0]) or 0)
        grid = candidate_geometries(
            fmt, op, n_rows=grid_rows, width=_width_of(obj),
            nnz_pad=int(getattr(obj, "nnz_pad",
                                getattr(obj, "nblocks_pad", 0)) or 0),
            batch=batch)
        if self.max_candidates is not None:
            grid = grid[: self.max_candidates]
        cands.extend(grid)

        with _obs.span("tune.sweep", fmt=fmt, op=op, batch=batch,
                       d_mat=profile[2]) as sweep:
            times: List[Tuple[float, Optional[TileGeometry]]] = []
            for g in cands:
                gg = g
                if g is not None and fmt in ("csr", "ccs", "bcsr"):
                    spb = _slab_bound_for(obj, g)
                    if spb is not None:
                        gg = replace(g, slabs_per_block=spb)
                times.append((self._time_launch(impl, obj, x, gg,
                                                fmt=fmt, op=op), gg))

            t_default = times[0][0]
            t_best, best_g = min(times, key=lambda tg: tg[0])
            sweep.set(candidates=len(cands), t_best=t_best,
                      t_default=t_default)
        rec = GeometryRecord(
            fmt=fmt, op=op, batch=batch, n=profile[0],
            nnz=profile[1], d_mat=profile[2], sig=profile[3],
            geometry=best_g if best_g is not None else TileGeometry(),
            t_best=t_best, t_default=t_default)
        return self._record(key, rec)

    def _time_launch(self, impl: Callable, obj: Any, x: torch.Tensor,
                     g: Optional[TileGeometry], **span_attrs: Any) -> float:
        thunk = lambda: impl(obj, x, tuning=g)
        with _obs.span("tune.candidate",
                       geometry=g.to_dict() if g is not None else {},
                       **span_attrs) as sp:
            t = float(self._timer(thunk, g))
            sp.set(t=t)
        return t

    def _tune_sell(self, obj: Any, op: str, batch: int, impl: Callable,
                   x: torch.Tensor, profile: Tuple[int, int, float, int],
                   key: Tuple, force: bool) -> GeometryRecord:
        """Per-bucket SELL search (SELL-C-sigma's per-chunk geometry).

        Bucket widths are distinct by construction, so each width is
        searched once on its own bucket — an ELL launch over (bucket_rows,
        width) — and memoized as a component record keyed by ``bucket_w``.
        The aggregate then times the composed per-bucket table against the
        all-defaults launch, so its ``t_best <= t_default`` stays true by
        construction."""
        ell_impl = _dispatch.get_impl("ell_row", op, tier="kernel",
                                      fallback=False)
        table: List[Tuple[int, TileGeometry]] = []
        for b in obj.buckets:
            bkey = self._key("sell", op, batch, profile,
                             bucket_w=int(b.width))
            bidx = self._memo.get(bkey)
            if not force and bidx is not None:
                table.append((int(b.width), self.records[bidx].geometry))
                continue
            grid = candidate_geometries("sell", op, n_rows=b.n_rows,
                                        width=b.width, batch=batch)
            if self.max_candidates is not None:
                grid = grid[: self.max_candidates]
            times = [(self._time_launch(ell_impl, b, x, g, fmt="sell",
                                        op=op, bucket_w=int(b.width)), g)
                     for g in [None] + grid]
            t_default = times[0][0]
            t_best, best_g = min(times, key=lambda tg: tg[0])
            brec = GeometryRecord(
                fmt="sell", op=op, batch=batch, n=profile[0],
                nnz=profile[1], d_mat=profile[2], sig=profile[3],
                bucket_w=int(b.width),
                geometry=best_g if best_g is not None else TileGeometry(),
                t_best=t_best, t_default=t_default)
            self._record(bkey, brec)
            table.append((int(b.width), brec.geometry))

        cands: List[Optional[TileGeometry]] = [None]
        if table:
            cands.append(TileGeometry(buckets=tuple(table)))
        times = [(self._time_launch(impl, obj, x, g, fmt="sell", op=op), g)
                 for g in cands]
        t_default = times[0][0]
        t_best, best_g = min(times, key=lambda tg: tg[0])
        rec = GeometryRecord(
            fmt="sell", op=op, batch=batch, n=profile[0], nnz=profile[1],
            d_mat=profile[2], sig=profile[3],
            geometry=best_g if best_g is not None else TileGeometry(),
            t_best=t_best, t_default=t_default)
        return self._record(key, rec)

    # -- lookup --------------------------------------------------------------
    def best(self, obj: Any = None, op: str = "spmv", batch: int = 1,
             fmt: Optional[str] = None, d_mat: Optional[float] = None,
             stats: Optional[MatrixStats] = None
             ) -> Optional[TileGeometry]:
        """Memoized winner for this exact profile, else the D_mat-keyed
        nearest-neighbour among recorded winners (slab bound stripped),
        else ``None`` (caller uses the default launch)."""
        if obj is not None:
            fmt = fmt or _dispatch.format_of(obj)
            profile = _profile_of(obj, stats)
            idx = self._memo.get(self._key(fmt, op, max(batch, 1), profile))
            if idx is not None:
                return self.records[idx].geometry
            if d_mat is None:
                d_mat = profile[2]
        if fmt is None:
            raise ValueError("best() needs a matrix object or a format name")
        return nearest_geometry(self.records, fmt, op,
                                d_mat=d_mat or 0.0, batch=max(batch, 1))

    # -- binding helpers -----------------------------------------------------
    def bind(self, impls: Dict[str, Callable],
             tunings: Dict[str, TileGeometry]) -> Dict[str, Callable]:
        """``{fmt: impl}`` with each format's tuned geometry partially
        applied (formats without a tuned geometry — or whose impl doesn't
        accept ``tuning=`` — pass through).  Delegates to
        :func:`repro_torch.core.plan.bind_tunings`."""
        from .plan import bind_tunings
        return bind_tunings(impls, tunings)
