"""Reference SpMV / SpMM per format — pure torch, on CPU and CUDA alike.

These are the *semantic oracles* for the CUDA kernels in
``repro_torch.kernels`` and measurable implementations the auto-tuner can
time.  Every (format, op) pair defined here is registered in
``repro_torch.core.dispatch`` — the single dispatch source of truth.

SpMM convention: ``x`` is a column panel ``(n_cols, B)`` and the result is
``(n_rows, B)`` — one transformed matrix amortized over ``k * B`` products
(the batch-parallel strengthening of the paper's ``k (t_crs - t_f) >
t_trans`` rule).

Sums follow the operand dtype (``promote_types(data, x)``), as the JAX
package's reference tier does; the kernel tier accumulates in float32.
"""
from __future__ import annotations

import torch

from . import dispatch as _dispatch
from .formats import BCSR, BucketedELL, CCS, COO, CSR, ELL


def _scatter_rows(contrib: torch.Tensor, rows: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """``y[rows[k]] += contrib[k]`` along dim 0 (a segment sum)."""
    y = torch.zeros((n_rows,) + tuple(contrib.shape[1:]),
                    dtype=contrib.dtype, device=contrib.device)
    return y.index_add_(0, rows, contrib)


# ---------------------------------------------------------------------------
# CSR (paper's CRS baseline)
# ---------------------------------------------------------------------------
def _csr_expanded_rows(m: CSR) -> torch.Tensor:
    ip = m.indptr
    k = torch.arange(m.nnz_pad, dtype=ip.dtype, device=ip.device)
    rows = torch.searchsorted(ip, k, right=True) - 1
    return rows.clamp_(0, max(m.n_rows - 1, 0))


def spmv_csr(m: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A in CSR.  Row ids via binary search over IRP; pad
    slots carry value 0 and an in-range column, so they add nothing."""
    contrib = m.data * x[m.cols]
    return _scatter_rows(contrib, _csr_expanded_rows(m), m.n_rows)


def spmm_csr(m: CSR, x: torch.Tensor) -> torch.Tensor:
    """Multi-vector right-hand side: x (n_cols, k) -> (n_rows, k)."""
    contrib = m.data[:, None] * x[m.cols]
    return _scatter_rows(contrib, _csr_expanded_rows(m), m.n_rows)


# ---------------------------------------------------------------------------
# COO (row- or column-ordered; the order does not change the result)
# ---------------------------------------------------------------------------
def spmv_coo(m: COO, x: torch.Tensor) -> torch.Tensor:
    return _scatter_rows(m.data * x[m.cols], m.rows, m.n_rows)


def spmm_coo(m: COO, x: torch.Tensor) -> torch.Tensor:
    return _scatter_rows(m.data[:, None] * x[m.cols], m.rows, m.n_rows)


# ---------------------------------------------------------------------------
# CCS — column-major scatter (the paper's Phase-I product).  As in the JAX
# package, the sum is taken in x's dtype.
# ---------------------------------------------------------------------------
def _ccs_expanded_cols(m: CCS) -> torch.Tensor:
    ip = m.indptr
    k = torch.arange(m.nnz_pad, dtype=ip.dtype, device=ip.device)
    cols = torch.searchsorted(ip, k, right=True) - 1
    return cols.clamp_(0, max(m.n_cols - 1, 0))


def spmv_ccs(m: CCS, x: torch.Tensor) -> torch.Tensor:
    contrib = m.data * x[_ccs_expanded_cols(m)]
    return _scatter_rows(contrib.to(x.dtype), m.rows, m.n_rows)


def spmm_ccs(m: CCS, x: torch.Tensor) -> torch.Tensor:
    contrib = m.data[:, None] * x[_ccs_expanded_cols(m)]
    return _scatter_rows(contrib.to(x.dtype), m.rows, m.n_rows)


# ---------------------------------------------------------------------------
# ELL — the vector-friendly format (the paper's hero)
# ---------------------------------------------------------------------------
def _ell_row_major(m: ELL):
    if m.order == "col":
        return m.data.t(), m.cols.t()
    return m.data, m.cols


def spmv_ell(m: ELL, x: torch.Tensor) -> torch.Tensor:
    data, cols = _ell_row_major(m)
    return (data * x[cols]).sum(dim=1)


def spmm_ell(m: ELL, x: torch.Tensor) -> torch.Tensor:
    data, cols = _ell_row_major(m)
    # (rows, width, k) contract width
    return (data[:, :, None] * x[cols]).sum(dim=1)


# ---------------------------------------------------------------------------
# BucketedELL (SELL-C-sigma adaptation)
# ---------------------------------------------------------------------------
def spmv_sell(m: BucketedELL, x: torch.Tensor) -> torch.Tensor:
    # an all-zero matrix may carry an empty bucket list: the product is
    # exactly zeros of (n_rows,) in x's dtype, not an error
    y = torch.zeros(m.n_rows, dtype=x.dtype, device=x.device)
    for off, b in zip(m.row_offsets, m.buckets):
        y[m.perm[off:off + b.n_rows]] = spmv_ell(b, x).to(y.dtype)
    return y


def spmm_sell(m: BucketedELL, x: torch.Tensor) -> torch.Tensor:
    y = torch.zeros((m.n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    for off, b in zip(m.row_offsets, m.buckets):
        y[m.perm[off:off + b.n_rows]] = spmm_ell(b, x).to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# BCSR — b x b dense block matvecs (cache blocking)
# ---------------------------------------------------------------------------
def _bcsr_gather(m: BCSR, x: torch.Tensor):
    """Block row of every stored block, and the ``(b,)`` (or ``(b, B)``)
    slice of x each block multiplies (x zero-padded to whole blocks)."""
    b = m.block
    ip = m.indptr
    k = torch.arange(m.nblocks_pad, dtype=ip.dtype, device=ip.device)
    brow = (torch.searchsorted(ip, k, right=True) - 1).clamp_(
        0, max(m.n_block_rows - 1, 0))
    ncb = -(-m.n_cols // b)
    x_pad = torch.zeros((ncb * b,) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device)
    x_pad[: m.n_cols] = x
    x_blocks = x_pad.reshape((ncb, b) + tuple(x.shape[1:]))[m.block_cols]
    return brow, x_blocks


def spmv_bcsr(m: BCSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, A in BCSR: a stream of b x b dense block matvecs,
    segment-summed per block row."""
    brow, x_blocks = _bcsr_gather(m, x)                       # (nb, b)
    dt = torch.promote_types(m.data.dtype, x.dtype)
    contrib = torch.einsum("kij,kj->ki", m.data.to(dt), x_blocks.to(dt))
    y = _scatter_rows(contrib, brow, m.n_block_rows)          # (nbr, b)
    return y.reshape(m.n_block_rows * m.block)[: m.n_rows]


def spmm_bcsr(m: BCSR, x: torch.Tensor) -> torch.Tensor:
    brow, x_blocks = _bcsr_gather(m, x)                       # (nb, b, B)
    dt = torch.promote_types(m.data.dtype, x.dtype)
    contrib = torch.einsum("kij,kjc->kic", m.data.to(dt), x_blocks.to(dt))
    y = _scatter_rows(contrib, brow, m.n_block_rows)          # (nbr, b, B)
    return y.reshape(m.n_block_rows * m.block, x.shape[1])[: m.n_rows]


# ---------------------------------------------------------------------------
# dispatch — resolved through the core/dispatch registry
# ---------------------------------------------------------------------------
def spmv(m, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for any registered sparse format."""
    return _dispatch.dispatch(m, x, op="spmv")


def spmm(m, x: torch.Tensor) -> torch.Tensor:
    """Y = A @ X, X (n_cols, B), for any registered sparse format."""
    return _dispatch.spmm(m, x)


def spmv_dense(dense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return dense @ x


# ---------------------------------------------------------------------------
# registration: formats (predicate-narrowed where one class serves two
# names) and the reference-tier implementations defined above.
# ---------------------------------------------------------------------------
_dispatch.register_format("csr", CSR)
_dispatch.register_format("ccs", CCS)
_dispatch.register_format("coo_col", COO, lambda m: m.order == "col")
_dispatch.register_format("coo_row", COO)
_dispatch.register_format("ell_col", ELL, lambda m: m.order == "col")
_dispatch.register_format("ell_row", ELL)
_dispatch.register_format("sell", BucketedELL)
_dispatch.register_format("bcsr", BCSR)

for _fmt, _spmv_fn, _spmm_fn in (
    ("csr", spmv_csr, spmm_csr),
    ("coo_row", spmv_coo, spmm_coo),
    ("coo_col", spmv_coo, spmm_coo),
    ("ccs", spmv_ccs, spmm_ccs),
    ("ell_row", spmv_ell, spmm_ell),
    ("ell_col", spmv_ell, spmm_ell),
    ("sell", spmv_sell, spmm_sell),
    ("bcsr", spmv_bcsr, spmm_bcsr),
):
    _dispatch.register_impl(_fmt, "spmv", _spmv_fn)
    _dispatch.register_impl(_fmt, "spmm", _spmm_fn)


__all__ = ["spmv", "spmm", "spmv_csr", "spmm_csr", "spmv_coo", "spmm_coo",
           "spmv_ccs", "spmm_ccs", "spmv_ell", "spmm_ell", "spmv_sell",
           "spmm_sell", "spmv_bcsr", "spmm_bcsr", "spmv_dense"]
