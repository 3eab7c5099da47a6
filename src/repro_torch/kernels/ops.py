"""Format-level entry points over the CUDA kernels.

Responsibilities:
  * accept the ``repro_torch.core.formats`` containers and hand the kernels
    plain tensors (ELL panels as strided views: no transpose copy, no
    padding to a tile multiple);
  * cast the kernels' float32 result to ``promote_types(data, x)``;
  * accept a per-call launch geometry (``tuning=`` — a
    ``core.kernel_tune.TileGeometry``): ``block_rows`` is the number of rows
    (ELL, CSR SpMM), columns (CCS) or block rows (BCSR) a CUDA block owns,
    ``block_nnz`` the number of entries a CUDA block owns (COO, CSR SpMV) and
    ``block_k`` the number of right-hand-side columns a CUDA block owns
    (SpMM); ``block_w`` and ``slabs_per_block`` are ignored by these
    kernels;
  * keep beside each bound container what its kernels read
    (:func:`prepare`, cached by container identity, never a field of the
    container): an ELL panel's live extents, so the ELL SpMV kernel reads
    each row up to its last stored slot, and a CSR matrix's structure, which
    picks its SpMM kernel;
  * provide a differentiable ELL SpMV (``ell_spmv_ad``: y = A@x  =>
    dx = A^T dy via a COO scatter; dA = dy_r * x_c at the stored positions);
  * register every format-level wrapper in the ``repro_torch.core.dispatch``
    registry under the ``"kernel"`` tier.

Every wrapper here reaches a kernel wrapper of this package, which launches
its CUDA kernel for CUDA tensors (or raises) and runs the kernel's plain
PyTorch version for CPU tensors.  CSR is served by its native kernels; the CSR-via-COO detour survives only as ``spmv_csr_via_coo`` so a
benchmark can measure what the native kernel buys (``spmm_csr_via_coo`` is
its SpMM twin).  SELL launches the ELL kernel once per bucket and accepts a
*per-bucket* launch geometry; a hybrid container launches each row block's
own format's kernel and accepts a *per-format* launch geometry.
"""
from __future__ import annotations

import functools
import weakref
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import dispatch as _dispatch
from ..core.formats import BCSR, CCS, COO, CSR, ELL, BucketedELL, _np
from ..core.kernel_tune import TileGeometry, _align8
from ..device import result_dtype
from ..partition import hybrid as _hybrid
from ..partition.hybrid import HybridMatrix
from . import bcsr_spmv as _bcsr
from . import ccs_spmv as _ccs
from . import coo_spmv as _coo
from . import csr_spmv as _csr
from . import ell_spmv as _ell
from ._common import csr_spmm_window


def _knob(tuning: Optional[TileGeometry], name: str) -> Optional[int]:
    v = getattr(tuning, name, None) if tuning is not None else None
    return None if v is None else int(v)


def _geom(tuning: Optional[TileGeometry], name: str, default: int,
          cap: Optional[int] = None) -> int:
    """The reference's effective (8-aligned, clamped) tile for a knob — used
    only by :func:`exact_slab_bound`."""
    v = getattr(tuning, name, None) if tuning is not None else None
    v = default if v is None else _align8(v)
    return min(v, cap) if cap is not None else v


# ---------------------------------------------------------------------------
# raw-array entry points
# ---------------------------------------------------------------------------
def ell_spmv_raw(data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                 tuning: Optional[TileGeometry] = None,
                 extent: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ELL SpMV on a ``(n_rows, width)`` panel (any strides), reading each
    row up to its ``extent`` (``None``: the whole band)."""
    y = _ell.ell_spmv(data, cols, x, extent=extent,
                      block_rows=_knob(tuning, "block_rows"))
    return y.to(result_dtype(data.dtype, x.dtype))


def ell_spmm_raw(data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                 tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    """ELL SpMM on a ``(n_rows, width)`` panel (any strides) and an
    ``(n_cols, B)`` right-hand side."""
    y = _ell.ell_spmm(data, cols, x, block_rows=_knob(tuning, "block_rows"),
                      block_k=_knob(tuning, "block_k"))
    return y.to(result_dtype(data.dtype, x.dtype))


def coo_spmv_raw(data: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                 x: torch.Tensor, n_rows: int,
                 tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    y = _coo.coo_spmv(data, rows, cols, x, n_rows,
                      block_nnz=_knob(tuning, "block_nnz"))
    return y.to(result_dtype(data.dtype, x.dtype))


def coo_spmm_raw(data: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                 x: torch.Tensor, n_rows: int,
                 tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    y = _coo.coo_spmm(data, rows, cols, x, n_rows,
                      block_nnz=_knob(tuning, "block_nnz"),
                      block_k=_knob(tuning, "block_k"))
    return y.to(result_dtype(data.dtype, x.dtype))


# ---------------------------------------------------------------------------
# differentiable ELL SpMV
# ---------------------------------------------------------------------------
class _EllSpmvAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, cols, x):
        ctx.save_for_backward(data, cols, x)
        return ell_spmv_raw(data, cols, x)

    @staticmethod
    def backward(ctx, dy):
        data, cols, x = ctx.saved_tensors
        # dx[c] = sum_{r,k: cols[r,k]=c} data[r,k] * dy[r]  (A^T dy, scatter)
        dx = torch.zeros_like(x).index_add_(
            0, cols.reshape(-1),
            (data * dy[:, None]).reshape(-1).to(x.dtype))
        # dA[r,k] = dy[r] * x[cols[r,k]]
        ddata = (dy[:, None] * x[cols]).to(data.dtype)
        return ddata, None, dx


def ell_spmv_ad(data: torch.Tensor, cols: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV with gradients for ``data`` and ``x``: forward is the ELL
    kernel, backward is plain torch (as in the reference, whose backward is
    plain array code too)."""
    return _EllSpmvAD.apply(data, cols, x)


# ---------------------------------------------------------------------------
# format-level entry points (what the auto-tuner plugs in)
# ---------------------------------------------------------------------------
def _ell_arrays(m: ELL):
    """``(n_rows, width)`` views of the panel; column-major storage is
    viewed transposed, never copied."""
    if m.order == "col":
        return m.data.t(), m.cols.t()
    return m.data, m.cols


#: ``(extent, read, versions)`` of each ELL panel :func:`prepare` was given,
#: by container (an ``ELL`` is a frozen dataclass compared by identity): its
#: rows' live extents, whether the SpMV kernel reads up to them, and the
#: version counters of ``data`` and ``cols`` they were computed at; an entry
#: goes with its container
_EXTENTS: ("weakref.WeakKeyDictionary[ELL, Tuple[torch.Tensor, bool, "
           "Tuple[int, int]]]") = weakref.WeakKeyDictionary()


#: ``(heavy, served)`` of each CSR matrix :func:`prepare` was given, by
#: container (``csr_spmv.csr_spmm_structure``)
_CSR_STRUCTURE: "weakref.WeakKeyDictionary[CSR, Tuple[bool, float]]" = \
    weakref.WeakKeyDictionary()


def _version(t: torch.Tensor) -> int:
    """``t``'s version counter; -1 for an inference tensor, which keeps
    none (and which only inference mode may edit in place)."""
    return -1 if t.is_inference() else t._version


def _versions(m: ELL) -> Tuple[int, int]:
    """The version counters of a panel's tensors: an in-place edit of
    either (or of a view of it) raises its counter; reading them costs no
    device work.  A panel made under ``torch.inference_mode`` has none, and
    keeps the extents it was prepared with."""
    return _version(m.data), _version(m.cols)


def _attach_extent(m: ELL):
    ext = _ell.ell_extent(*_ell_arrays(m))
    got = (ext, _ell.extent_pays(ext, m.width), _versions(m))
    _EXTENTS[m] = got
    return got


def _current(m: ELL):
    """``m``'s entry in ``_EXTENTS``, recomputed first if the panel was
    edited in place since it was made; ``None`` if never prepared."""
    got = _EXTENTS.get(m)
    if got is not None and got[2] != _versions(m):
        got = _attach_extent(m)
    return got


def prepare(m):
    """Attach what the kernels read beside a bound container, once: the
    live extents (``kernels/ell_spmv.py:ell_extent``) of an ELL panel, or of
    each SELL bucket, computed on the container's device, and whether
    reading up to them pays (``ell_spmv.extent_pays``: the panel holds
    enough pads); for a CSR matrix, what picks its SpMM kernel
    (``csr_spmv.csr_spmm_structure``); for a hybrid container, each of its
    blocks.  Part of the transformation's cost: ``ExecutionPlan.bind`` and
    ``offline_phase`` call it and time it with the transform.  A panel
    edited in place since is recomputed here, or at its next launch.  Other
    containers pass through."""
    if isinstance(m, BucketedELL):
        for b in m.buckets:
            prepare(b)
    elif isinstance(m, HybridMatrix):
        for b in m.blocks:
            prepare(b)
    elif isinstance(m, ELL):
        if _current(m) is None:
            _attach_extent(m)
    elif isinstance(m, CSR) and m not in _CSR_STRUCTURE:
        _CSR_STRUCTURE[m] = _csr.csr_spmm_structure(m.cols, m.indptr,
                                                    m.n_cols)
    return m


def csr_window_of(m: CSR, batch: int,
                  block_k: Optional[int] = None) -> Optional[bool]:
    """Whether :func:`spmm_csr` runs ``m`` through the window kernel at
    ``batch`` right-hand sides: from its structure where :func:`prepare`
    was given it, else ``None`` (the tile decides)."""
    got = _CSR_STRUCTURE.get(m)
    if got is None:
        return None
    return csr_spmm_window(batch, block_k, *got)


def ell_extent_of(m: ELL) -> Optional[torch.Tensor]:
    """The live extents :func:`prepare` attached to ``m`` (recomputed if
    the panel was edited in place since), else ``None``."""
    got = _current(m)
    return None if got is None else got[0]


def _extent_read(m: ELL) -> Optional[torch.Tensor]:
    """The extents the SpMV kernel reads ``m`` up to (``None``: the whole
    band — not prepared, or too few pads for the extent to pay).  A panel
    whose tensors changed since its extents were taken gets them anew
    before the kernel runs, so an edit in place is never read short."""
    got = _current(m)
    return got[0] if got is not None and got[1] else None


def spmv_ell(m: ELL, x: torch.Tensor,
             tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    """ELL through the SpMV kernel; a prepared panel with enough pads is
    read up to each row's extent, another one whole."""
    data, cols = _ell_arrays(m)
    return ell_spmv_raw(data, cols, x, tuning, _extent_read(m))


def spmm_ell(m: ELL, x: torch.Tensor,
             tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    data, cols = _ell_arrays(m)
    return ell_spmm_raw(data, cols, x, tuning)


def spmv_coo(m: COO, x: torch.Tensor,
             tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    return coo_spmv_raw(m.data, m.rows, m.cols, x, m.n_rows, tuning)


def spmm_coo(m: COO, x: torch.Tensor,
             tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    return coo_spmm_raw(m.data, m.rows, m.cols, x, m.n_rows, tuning)


def spmv_csr(m: CSR, x: torch.Tensor,
             tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    """CSR through the native entry-sliced kernel (no COO detour)."""
    y = _csr.csr_spmv(m.data, m.cols, m.indptr, x,
                      block_nnz=_knob(tuning, "block_nnz"))
    return y.to(result_dtype(m.data.dtype, x.dtype))


def spmm_csr(m: CSR, x: torch.Tensor,
             tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    """CSR SpMM through the native kernels: for a prepared matrix the
    window kernel where its structure says it pays
    (``_common.csr_spmm_window``), else by the tile alone."""
    block_k = _knob(tuning, "block_k")
    y = _csr.csr_spmm(m.data, m.cols, m.indptr, x,
                      block_rows=_knob(tuning, "block_rows"),
                      block_k=block_k,
                      window=csr_window_of(m, x.shape[1], block_k))
    return y.to(result_dtype(m.data.dtype, x.dtype))


def _csr_as_coo_arrays(m: CSR):
    """The IRP->IROW expansion (binary search per stored slot) — the CSR
    path that predates the native kernel, kept for benchmark comparison."""
    ip = m.indptr
    k = torch.arange(m.nnz_pad, dtype=ip.dtype, device=ip.device)
    rows = (torch.searchsorted(ip, k, right=True) - 1).clamp_(
        0, max(m.n_rows - 1, 0))
    live = k < m.nnz
    rows = torch.where(live, rows, 0).to(torch.int32)
    data = torch.where(live, m.data, torch.zeros((), dtype=m.data.dtype,
                                                 device=ip.device))
    return data, rows, m.cols


def spmv_csr_via_coo(m: CSR, x: torch.Tensor,
                     tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    """CSR by IRP->IROW expansion + the COO kernel (benchmark baseline only
    — the registry serves :func:`spmv_csr`)."""
    data, rows, cols = _csr_as_coo_arrays(m)
    return coo_spmv_raw(data, rows, cols, x, m.n_rows, tuning)


def spmm_csr_via_coo(m: CSR, x: torch.Tensor,
                     tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    data, rows, cols = _csr_as_coo_arrays(m)
    return coo_spmm_raw(data, rows, cols, x, m.n_rows, tuning)


# ---------------------------------------------------------------------------
# CCS — column-grouped kernel (kernels/ccs_spmv.py)
# ---------------------------------------------------------------------------
def spmv_ccs(m: CCS, x: torch.Tensor,
             tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    """CCS through the column-grouped kernel.  ``block_rows`` is the
    segmented-axis tile, so for CCS it counts *columns* per CUDA block."""
    y = _ccs.ccs_spmv(m.data, m.rows, m.indptr, x, m.n_rows,
                      block_rows=_knob(tuning, "block_rows"))
    return y.to(result_dtype(m.data.dtype, x.dtype))


def spmm_ccs(m: CCS, x: torch.Tensor,
             tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    y = _ccs.ccs_spmm(m.data, m.rows, m.indptr, x, m.n_rows,
                      block_rows=_knob(tuning, "block_rows"),
                      block_k=_knob(tuning, "block_k"))
    return y.to(result_dtype(m.data.dtype, x.dtype))


# ---------------------------------------------------------------------------
# BCSR — block-row kernel (kernels/bcsr_spmv.py)
# ---------------------------------------------------------------------------
def _bcsr_geometry(m: BCSR, tuning: Optional[TileGeometry]):
    """The reference's effective ``(rows_per_tile, block_nnz,
    slabs_per_block)`` of a BCSR launch — used only by
    :func:`exact_slab_bound`, so plan JSON carries the reference's bound."""
    rpt = max(1, min(_geom(tuning, "block_rows",
                           min(32, m.n_block_rows or 1)),
                     m.n_block_rows or 1))
    bnb = max(1, min(_geom(tuning, "block_nnz",
                           min(512, _align8(m.nblocks_pad))),
                     _align8(m.nblocks_pad)))
    return rpt, bnb, _csr.slabs_needed(np.asarray(_np(m.indptr)), rpt, bnb)


def spmv_bcsr(m: BCSR, x: torch.Tensor,
              tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    """BCSR through the block-row kernel; ``block_rows`` counts block rows
    per CUDA block."""
    y = _bcsr.bcsr_spmv(m.data, m.block_cols, m.indptr, x, m.n_rows,
                        block_rows=_knob(tuning, "block_rows"))
    return y.to(result_dtype(m.data.dtype, x.dtype))


def spmm_bcsr(m: BCSR, x: torch.Tensor,
              tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    y = _bcsr.bcsr_spmm(m.data, m.block_cols, m.indptr, x, m.n_rows,
                        block_rows=_knob(tuning, "block_rows"),
                        block_k=_knob(tuning, "block_k"))
    return y.to(result_dtype(m.data.dtype, x.dtype))


def exact_slab_bound(m, tuning: Optional[TileGeometry] = None) -> int:
    """The reference's slab-coverage bound for a CSR, CCS or BCSR instance
    at *its* effective launch geometry (pure numpy; for CCS over the column
    pointer, for BCSR over the block IRP).  Recorded so that
    ``PlannedMatrix.tunings`` and plan JSON match the reference key for key;
    the CUDA kernels read their bounds from the pointer at run time and do
    not use it."""
    t = tuning.without_slab_bound() if tuning is not None else None
    if isinstance(m, (CSR, CCS)):
        n_seg = m.n_rows if isinstance(m, CSR) else m.n_cols
        br = _geom(t, "block_rows", min(256, _align8(n_seg)),
                   cap=_align8(n_seg))
        bn = _geom(t, "block_nnz", min(2048, _align8(m.nnz_pad)),
                   cap=_align8(m.nnz_pad))
        return _csr.slabs_needed(np.asarray(_np(m.indptr)), br, bn)
    if isinstance(m, BCSR):
        return _bcsr_geometry(m, t)[2]
    raise TypeError(f"no slab-coverage bound for {type(m)}")


# ---------------------------------------------------------------------------
# SELL container
# ---------------------------------------------------------------------------
SellTuning = Union[TileGeometry, Sequence[Optional[TileGeometry]],
                   Mapping[int, TileGeometry]]


def _sell_tunings(m: BucketedELL, tuning: Optional[SellTuning]
                  ) -> Tuple[Optional[TileGeometry], ...]:
    """Resolve the per-bucket launch geometry for a SELL container.

    ``tuning`` may be: ``None`` (defaults everywhere); one
    :class:`TileGeometry` — broadcast, unless it carries a ``buckets``
    table, in which case each bucket looks up its *width* and falls back
    to the table-less top-level knobs; a ``{width: TileGeometry}`` mapping;
    or a positional sequence (one entry per bucket, ``None`` allowed)."""
    n = len(m.buckets)
    if tuning is None:
        return (None,) * n
    if isinstance(tuning, Mapping):
        return tuple(tuning.get(b.width) for b in m.buckets)
    if isinstance(tuning, (list, tuple)):
        if len(tuning) != n:
            raise ValueError(f"per-bucket tuning sequence has {len(tuning)} "
                             f"entries for {n} buckets")
        return tuple(tuning)
    if tuning.buckets:
        table = dict(tuning.buckets)
        base = tuning.broadcast()
        return tuple(table.get(b.width, base) for b in m.buckets)
    return (tuning,) * n


def spmv_sell(m: BucketedELL, x: torch.Tensor,
              tuning: Optional[SellTuning] = None) -> torch.Tensor:
    """The ELL kernel once per bucket, results stored through ``perm``."""
    # an all-zero matrix may carry an empty bucket list — the product is
    # exactly zeros of (n_rows,) in x's dtype, not None
    y = torch.zeros(m.n_rows, dtype=x.dtype, device=x.device)
    for off, b, g in zip(m.row_offsets, m.buckets, _sell_tunings(m, tuning)):
        yb = ell_spmv_raw(b.data, b.cols, x, g, _extent_read(b))
        y[m.perm[off:off + b.n_rows]] = yb.to(y.dtype)
    return y


def spmm_sell(m: BucketedELL, x: torch.Tensor,
              tuning: Optional[SellTuning] = None) -> torch.Tensor:
    """The ELL SpMM kernel once per bucket, rows stored through ``perm``.
    As in the reference, the result takes ``x``'s dtype (not the promoted
    type), and an all-zero matrix gives zeros of ``(n_rows, B)``."""
    y = torch.zeros((m.n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    for off, b, g in zip(m.row_offsets, m.buckets, _sell_tunings(m, tuning)):
        yb = ell_spmm_raw(b.data, b.cols, x, g)
        y[m.perm[off:off + b.n_rows]] = yb.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# hybrid container: each row block through its own format's kernel
# ---------------------------------------------------------------------------
def hybrid_block_impls(formats: Sequence[str], op: str,
                       tuning: Optional[Dict[str, TileGeometry]] = None
                       ) -> Dict[str, Callable]:
    """The kernel-tier impl of each block format in ``formats``, with that
    format's tuned geometry bound.  A block never drops to the reference
    tier here: a format without a kernel raises.  ``ExecutionPlan.bind``
    resolves them once per bound hybrid matrix."""
    table = _dispatch.impl_table(op, "kernel", exclude=("hybrid",))
    missing = set(formats) - set(table)
    if missing:
        raise KeyError(f"no kernel-tier {op} for hybrid blocks of "
                       f"{sorted(missing)}")
    out = {}
    for f in set(formats):
        g = (tuning or {}).get(f)
        out[f] = (functools.partial(table[f], tuning=g) if g is not None
                  else table[f])
    return out


def spmv_hybrid(m: HybridMatrix, x: torch.Tensor,
                tuning: Optional[Dict[str, TileGeometry]] = None
                ) -> torch.Tensor:
    """Partitioned hybrid matrix: each row block through its own format's
    kernel (one or more launches a block), reassembled by plain torch ops
    (``partition/hybrid.py``).  ``tuning`` maps format name ->
    TileGeometry for the per-block kernels."""
    return _hybrid.spmv_hybrid(m, x, impls=hybrid_block_impls(
        m.formats, "spmv", tuning))


def spmm_hybrid(m: HybridMatrix, x: torch.Tensor,
                tuning: Optional[Dict[str, TileGeometry]] = None
                ) -> torch.Tensor:
    return _hybrid.spmm_hybrid(m, x, impls=hybrid_block_impls(
        m.formats, "spmm", tuning))


# ---------------------------------------------------------------------------
# registry: the kernel tier of repro_torch.core.dispatch (always registered)
# ---------------------------------------------------------------------------
for _fmt, _spmv_fn, _spmm_fn in (
    ("csr", spmv_csr, spmm_csr),
    ("ccs", spmv_ccs, spmm_ccs),
    ("coo_row", spmv_coo, spmm_coo),
    ("coo_col", spmv_coo, spmm_coo),
    ("ell_row", spmv_ell, spmm_ell),
    ("ell_col", spmv_ell, spmm_ell),
    ("sell", spmv_sell, spmm_sell),
    ("bcsr", spmv_bcsr, spmm_bcsr),
    ("hybrid", spmv_hybrid, spmm_hybrid),
):
    _dispatch.register_impl(_fmt, "spmv", _spmv_fn, tier="kernel")
    _dispatch.register_impl(_fmt, "spmm", _spmm_fn, tier="kernel")


# read-only dict views of the registry, recomputed on access so later
# registrations are never missed — the single source of truth stays in
# core/dispatch.
def __getattr__(name: str):
    if name == "KERNEL_SPMV_IMPLS":
        return _dispatch.impl_table("spmv", "kernel")
    if name == "KERNEL_SPMM_IMPLS":
        return _dispatch.impl_table("spmm", "kernel")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["prepare", "ell_extent_of", "csr_window_of", "ell_spmv_raw", "ell_spmm_raw", "coo_spmv_raw", "coo_spmm_raw",
           "ell_spmv_ad", "spmv_ell", "spmm_ell", "spmv_coo", "spmm_coo",
           "spmv_csr", "spmm_csr", "spmv_csr_via_coo", "spmm_csr_via_coo",
           "spmv_ccs", "spmm_ccs", "spmv_bcsr", "spmm_bcsr",
           "exact_slab_bound", "spmv_sell", "spmm_sell", "spmv_hybrid",
           "spmm_hybrid", "KERNEL_SPMV_IMPLS", "KERNEL_SPMM_IMPLS"]
