"""Format-level entry points over the CUDA kernels.

Responsibilities:
  * accept the ``repro_torch.core.formats`` containers and hand the kernels
    plain tensors (ELL panels as strided views: no transpose copy, no
    padding to a tile multiple);
  * cast the kernels' float32 result to ``promote_types(data, x)``;
  * accept a per-call launch geometry (``tuning=`` — a
    ``core.kernel_tune.TileGeometry``): ``block_rows`` is the number of rows
    a CUDA block owns (ELL, CSR), ``block_nnz`` the number of entries a
    CUDA block owns (COO) and ``block_k`` the number of right-hand-side
    columns a CUDA block owns (SpMM); ``block_w`` and ``slabs_per_block``
    are ignored by these kernels;
  * provide a differentiable ELL SpMV (``ell_spmv_ad``: y = A@x  =>
    dx = A^T dy via a COO scatter; dA = dy_r * x_c at the stored positions);
  * register every format-level wrapper in the ``repro_torch.core.dispatch``
    registry under the ``"kernel"`` tier.

Every wrapper here reaches a kernel wrapper of this package, which launches
its CUDA kernel for CUDA tensors (or raises) and runs the kernel's plain
PyTorch version for CPU tensors.  CSR is served by the native row-segmented
kernel; the CSR-via-COO detour survives only as ``spmv_csr_via_coo`` so a
benchmark can measure what the native kernel buys (``spmm_csr_via_coo`` is
its SpMM twin).  SELL launches the ELL kernel once per bucket and accepts a
*per-bucket* launch geometry.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core import dispatch as _dispatch
from ..core.formats import COO, CSR, ELL, BucketedELL, _np
from ..core.kernel_tune import TileGeometry, _align8
from ..device import result_dtype
from . import coo_spmv as _coo
from . import csr_spmv as _csr
from . import ell_spmv as _ell


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
                 tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    """ELL SpMV on a ``(n_rows, width)`` panel (any strides)."""
    y = _ell.ell_spmv(data, cols, x, block_rows=_knob(tuning, "block_rows"))
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


def spmv_ell(m: ELL, x: torch.Tensor,
             tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    data, cols = _ell_arrays(m)
    return ell_spmv_raw(data, cols, x, tuning)


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
    """CSR through the native row-segmented kernel (no COO detour)."""
    y = _csr.csr_spmv(m.data, m.cols, m.indptr, x,
                      block_rows=_knob(tuning, "block_rows"))
    return y.to(result_dtype(m.data.dtype, x.dtype))


def spmm_csr(m: CSR, x: torch.Tensor,
             tuning: Optional[TileGeometry] = None) -> torch.Tensor:
    """CSR SpMM through the native row-segmented kernel."""
    y = _csr.csr_spmm(m.data, m.cols, m.indptr, x,
                      block_rows=_knob(tuning, "block_rows"),
                      block_k=_knob(tuning, "block_k"))
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


def exact_slab_bound(m, tuning: Optional[TileGeometry] = None) -> int:
    """The reference's slab-coverage bound for a CSR instance at *its*
    effective launch geometry (pure numpy).  Recorded so that
    ``PlannedMatrix.tunings`` and plan JSON match the reference key for key;
    the CUDA CSR kernel reads row bounds from IRP at run time and does not
    use it."""
    t = tuning.without_slab_bound() if tuning is not None else None
    if isinstance(m, CSR):
        br = _geom(t, "block_rows", min(256, _align8(m.n_rows)),
                   cap=_align8(m.n_rows))
        bn = _geom(t, "block_nnz", min(2048, _align8(m.nnz_pad)),
                   cap=_align8(m.nnz_pad))
        return _csr.slabs_needed(np.asarray(_np(m.indptr)), br, bn)
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
        yb = ell_spmv_raw(b.data, b.cols, x, g)
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
# registry: the kernel tier of repro_torch.core.dispatch (always registered)
# ---------------------------------------------------------------------------
for _fmt, _spmv_fn, _spmm_fn in (
    ("csr", spmv_csr, spmm_csr),
    ("coo_row", spmv_coo, spmm_coo),
    ("coo_col", spmv_coo, spmm_coo),
    ("ell_row", spmv_ell, spmm_ell),
    ("ell_col", spmv_ell, spmm_ell),
    ("sell", spmv_sell, spmm_sell),
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


__all__ = ["ell_spmv_raw", "ell_spmm_raw", "coo_spmv_raw", "coo_spmm_raw",
           "ell_spmv_ad", "spmv_ell", "spmm_ell", "spmv_coo", "spmm_coo",
           "spmv_csr", "spmm_csr", "spmv_csr_via_coo", "spmm_csr_via_coo",
           "exact_slab_bound", "spmv_sell", "spmm_sell", "KERNEL_SPMV_IMPLS",
           "KERNEL_SPMM_IMPLS"]
