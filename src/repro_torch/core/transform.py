"""Run-time sparse-format transformations (paper §2.1).

Two implementation paths:

* ``host_*`` — numpy, executed at library-call time exactly like the paper's
  Fortran code.  They read the source's tensors on the host (a source that
  lies on the card is copied back first, and that copy is part of their
  time) and return a container of CPU tensors; ``plan.bind`` moves the
  result to the device.
* ``device_*`` — torch ops on the source tensors' own device, so the
  transformation itself can run on the accelerator (its cost there is
  ``t_trans``).  Output widths / nnz pads are host-known from the matrix
  stats at call time — the same run-time model as the paper.

torch raises on an out-of-range gather on the CPU and is undefined on CUDA,
so every gather here is made in range first (``clamp``) and masked after.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from .. import obs as _obs
from ..device import DeviceLike, from_host, resolve_device
from .formats import BCSR, CCS, CSR, COO, ELL, BucketedELL, _np, _vals


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _traced(fmt: str):
    """Wrap a host conversion in a ``transform`` span carrying the target
    format, matrix size, and any simple keyword parameters — so t_trans
    shows up per conversion in every trace, not just in offline records."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(m, *a, **kw):
            tel = _obs.get()
            if not tel.enabled:
                return fn(m, *a, **kw)
            attrs = {"fmt": fmt,
                     "n_rows": int(getattr(m, "n_rows", 0) or 0),
                     "nnz": int(getattr(m, "nnz", 0) or 0)}
            attrs.update((k, v) for k, v in kw.items()
                         if isinstance(v, (bool, int, float, str)))
            with tel.span("transform", **attrs):
                return fn(m, *a, **kw)
        return wrapper
    return deco


def _pad1(x: np.ndarray, n_pad: int, fill=0) -> np.ndarray:
    out = np.full((n_pad,), fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def _t(a: np.ndarray, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Host array -> CPU tensor; value arrays take ``like``'s dtype (which
    restores bf16 from the int16 bit pattern the host code moved around)."""
    return from_host(a, like.dtype if like is not None else None)


# ---------------------------------------------------------------------------
# construction from dense / random (host)
# ---------------------------------------------------------------------------
def csr_from_dense(dense: np.ndarray, pad: int = 1,
                   device: DeviceLike = None) -> CSR:
    """CSR of a dense host array, placed on ``device`` (``None`` = the CUDA
    device; ``"cpu"`` keeps it on the host)."""
    dense = np.asarray(dense)
    n_rows, n_cols = dense.shape
    rows, cols = np.nonzero(dense)
    data = dense[rows, cols]
    nnz = data.shape[0]
    indptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    nnz_pad = max(pad_to_multiple(nnz, pad), pad)
    return CSR(
        data=_t(_pad1(data.astype(dense.dtype), nnz_pad)),
        cols=_t(_pad1(cols.astype(np.int32), nnz_pad)),
        indptr=_t(indptr),
        shape=(n_rows, n_cols),
        nnz=nnz,
    ).to(resolve_device(device))


def _csr_from_flat(cols: np.ndarray, data: np.ndarray, lens: np.ndarray,
                   n_cols: int, pad: int, device: DeviceLike) -> CSR:
    n_rows = lens.shape[0]
    nnz = int(lens.sum())
    indptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(lens, out=indptr[1:])
    nnz_pad = max(pad_to_multiple(nnz, pad), pad)
    return CSR(data=_t(_pad1(data, nnz_pad)), cols=_t(_pad1(cols, nnz_pad)),
               indptr=_t(indptr), shape=(n_rows, n_cols),
               nnz=nnz).to(resolve_device(device))


def csr_from_rows(row_cols: Sequence[np.ndarray],
                  row_vals: Sequence[np.ndarray],
                  n_cols: int, pad: int = 1, dtype=np.float32,
                  device: DeviceLike = None) -> CSR:
    """Build CSR from per-row (cols, vals) lists, placed on ``device``
    (``None`` = the CUDA device)."""
    n_rows = len(row_cols)
    lens = np.fromiter((len(c) for c in row_cols), count=n_rows,
                       dtype=np.int64)
    nnz = int(lens.sum())
    cols = (np.concatenate(row_cols).astype(np.int32) if nnz
            else np.zeros(0, np.int32))
    data = (np.concatenate(row_vals).astype(dtype) if nnz
            else np.zeros(0, dtype))
    return _csr_from_flat(cols, data, lens, n_cols, pad, device)


# ---------------------------------------------------------------------------
# CRS -> COO-Row (host): trivial, row ids from IRP (paper: "easy" direction)
# ---------------------------------------------------------------------------
@_traced("coo_row")
def host_csr_to_coo_row(m: CSR) -> COO:
    ip = _np(m.indptr)
    lens = ip[1:] - ip[:-1]
    rows = np.repeat(np.arange(m.n_rows, dtype=np.int32), lens)
    return COO(data=m.data.detach().cpu().clone(),
               rows=_t(_pad1(rows, m.nnz_pad)),
               cols=m.cols.detach().cpu().clone(),
               shape=m.shape, nnz=m.nnz, order="row")


# ---------------------------------------------------------------------------
# CRS -> CCS (host): the paper's Phase-I counting algorithm.
# ---------------------------------------------------------------------------
def host_csr_to_ccs_paper(m: CSR) -> CCS:
    """Literal translation of the paper's Fortran (§2.1) — O(n + nnz) loops.

    The oracle for :func:`host_csr_to_ccs`; slow in Python, so tests call it
    on small matrices only."""
    n, nnz = m.n_rows, m.nnz
    VAL = _np(m.data)
    ICOL = _np(m.cols)
    IRP = _np(m.indptr)
    # === Count the number of non-zero columns.
    NC_IRP = np.zeros(m.n_cols, dtype=np.int64)
    for i in range(n):
        for j_ptr in range(IRP[i], IRP[i + 1]):
            NC_IRP[ICOL[j_ptr]] += 1
    # === Set IRP.
    IRP_T = np.zeros(m.n_cols + 1, dtype=np.int64)
    for j in range(1, m.n_cols + 1):
        IRP_T[j] = IRP_T[j - 1] + NC_IRP[j - 1]
    cursor = IRP_T[:-1].copy()
    # === Set row numbers (the paper stores ICOL_T(K) = I, the row index).
    VAL_T = np.zeros(nnz, dtype=VAL.dtype)
    IROW_T = np.zeros(nnz, dtype=np.int32)
    for i in range(n):
        for j_ptr in range(IRP[i], IRP[i + 1]):
            jj = ICOL[j_ptr]
            k = cursor[jj]
            cursor[jj] += 1
            VAL_T[k] = VAL[j_ptr]
            IROW_T[k] = i
    return CCS(data=_t(_pad1(VAL_T, m.nnz_pad), m.data),
               rows=_t(_pad1(IROW_T, m.nnz_pad)),
               indptr=_t(IRP_T.astype(np.int32)), shape=m.shape, nnz=nnz)


@_traced("ccs")
def host_csr_to_ccs(m: CSR) -> CCS:
    """Vectorized counting sort — same output order as the paper's algorithm
    (stable within a column by row index, because CSR scans rows in order)."""
    nnz = m.nnz
    cols = _np(m.cols)[:nnz]
    data = _np(m.data)[:nnz]
    ip = _np(m.indptr)
    rows = np.repeat(np.arange(m.n_rows, dtype=np.int32), ip[1:] - ip[:-1])
    counts = np.bincount(cols, minlength=m.n_cols)
    indptr = np.zeros(m.n_cols + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    order = np.argsort(cols, kind="stable")
    return CCS(data=_t(_pad1(data[order], m.nnz_pad), m.data),
               rows=_t(_pad1(rows[order], m.nnz_pad)),
               indptr=_t(indptr), shape=m.shape, nnz=nnz)


# ---------------------------------------------------------------------------
# CRS -> BCSR (host; the paper's named future work, see formats.BCSR)
# ---------------------------------------------------------------------------
@_traced("bcsr")
def host_csr_to_bcsr(m: CSR, block: int = 8) -> BCSR:
    """Group nonzeros into ``block x block`` dense blocks, in CSR order over
    block rows, without a loop over blocks.  A stable sort of the block keys
    (rows come sorted, so the keys arrive in runs) numbers the blocks; the
    values land by one scatter when every row's columns are strictly
    increasing (no cell twice), else by one ``np.add.at`` over all entries
    in CSR order, which sums a cell's duplicates in the order a per-block
    loop does — so the blocks equal the JAX package's bit for bit.
    bfloat16 values are summed in float32 and rounded once (the same unless
    a cell holds three or more duplicates)."""
    b = int(block)
    n_rows, n_cols = m.shape
    nbr = -(-n_rows // b)
    nbc = -(-n_cols // b)
    ip = _np(m.indptr).astype(np.int64)
    lens = ip[1:] - ip[:-1]
    cols = _np(m.cols)[: m.nnz]
    data = _vals(m.data)[: m.nnz]
    r = np.arange(n_rows, dtype=np.int64)
    key = np.repeat(r // b * nbc, lens)                # block row * nbc
    key += cols // b                                   # + block column
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    first = np.ones(sorted_key.shape, dtype=bool)      # a block's first entry
    np.not_equal(sorted_key[1:], sorted_key[:-1], out=first[1:])
    uniq = sorted_key[first]
    nblocks = len(uniq)
    cell = np.empty_like(order)                        # flat index in blocks
    cell[order] = (np.cumsum(first) - 1) * (b * b)
    cell += np.repeat(r % b * b, lens)
    cell += cols % b
    blocks = np.zeros((max(nblocks, 1), b, b), dtype=data.dtype)
    rising = cols[1:] > cols[:-1]
    rising[ip[1:-1][(ip[1:-1] > 0) & (ip[1:-1] < m.nnz)] - 1] = True
    if rising.all():                     # no cell twice: one scatter
        blocks.reshape(-1)[cell] = data
        blocks += 0.0        # as 0 + v would: a stored -0.0 reads +0.0
    else:
        np.add.at(blocks.reshape(-1), cell, data)
    block_cols = np.zeros(max(nblocks, 1), dtype=np.int32)
    block_cols[:nblocks] = uniq % nbc
    indptr = np.zeros(nbr + 1, dtype=np.int32)
    np.cumsum(np.bincount(uniq // nbc, minlength=nbr), out=indptr[1:])
    return BCSR(data=from_host(blocks).to(m.data.dtype),
                block_cols=_t(block_cols), indptr=_t(indptr),
                shape=m.shape, nnz=m.nnz, block=b)


# ---------------------------------------------------------------------------
# CRS -> COO-Column (host): counting sort by column (the paper's Phase I),
# then column ids from the column pointer (Phase II).
# ---------------------------------------------------------------------------
@_traced("coo_col")
def host_csr_to_coo_col(m: CSR) -> COO:
    """Vectorized counting sort — same output order as the paper's algorithm
    (stable within a column by row index, because CSR scans rows in order)."""
    nnz = m.nnz
    cols = _np(m.cols)[:nnz]
    data = _np(m.data)[:nnz]
    ip = _np(m.indptr)
    rows = np.repeat(np.arange(m.n_rows, dtype=np.int32), ip[1:] - ip[:-1])
    order = np.argsort(cols, kind="stable")
    counts = np.bincount(cols, minlength=m.n_cols)
    out_cols = np.repeat(np.arange(m.n_cols, dtype=np.int32), counts)
    return COO(data=_t(_pad1(data[order], m.nnz_pad), m.data),
               rows=_t(_pad1(rows[order], m.nnz_pad)),
               cols=_t(_pad1(out_cols, m.nnz_pad)),
               shape=m.shape, nnz=m.nnz, order="col")


# ---------------------------------------------------------------------------
# CRS -> ELL (host)
# ---------------------------------------------------------------------------
def _gather_band(src_d: np.ndarray, src_c: np.ndarray, starts: np.ndarray,
                 lens: np.ndarray, w: int, nnz_pad: int):
    """(len(starts), w) data/cols panels: entry k of a row is source entry
    ``start + k`` where ``k < len``; everything else is (0, col 0)."""
    n = starts.shape[0]
    data = np.zeros((n, w), dtype=src_d.dtype)
    cols = np.zeros((n, w), dtype=np.int32)
    pos = starts[:, None] + np.arange(w)[None, :]
    valid = np.arange(w)[None, :] < lens[:, None]
    posc = np.clip(pos, 0, nnz_pad - 1)
    np.copyto(data, src_d[posc], where=valid)
    np.copyto(cols, src_c[posc], where=valid)
    return data, cols, valid


@_traced("ell")
def host_csr_to_ell(m: CSR, order: str = "row",
                    width: Optional[int] = None) -> ELL:
    ip = _np(m.indptr)
    lens = ip[1:] - ip[:-1]
    w = int(width if width is not None else (lens.max() if len(lens) else 0))
    w = max(w, 1)
    data, cols, _ = _gather_band(_np(m.data), _np(m.cols), ip[:-1], lens, w,
                                 m.nnz_pad)
    if order == "col":
        data, cols = np.ascontiguousarray(data.T), np.ascontiguousarray(cols.T)
    nnz_kept = int(np.minimum(lens, w).sum())
    return ELL(data=_t(data, m.data), cols=_t(cols), shape=m.shape,
               nnz=nnz_kept, order=order)


# ---------------------------------------------------------------------------
# CRS -> BucketedELL (beyond paper; SELL-C-sigma adaptation)
# ---------------------------------------------------------------------------
@_traced("sell")
def host_csr_to_sell(m: CSR, slice_rows: int = 128,
                     width_quantum: int = 8) -> BucketedELL:
    """Sort rows by length, group into slices of ``slice_rows`` rows, round
    each slice's width up to ``width_quantum`` and merge equal-width
    neighboring slices into buckets.  Each bucket is a dense ELL block."""
    ip = _np(m.indptr)
    lens = ip[1:] - ip[:-1]
    n = m.n_rows
    perm = np.argsort(-lens, kind="stable").astype(np.int32)  # longest first
    sorted_lens = lens[perm]
    src_d, src_c = _np(m.data), _np(m.cols)

    # slice boundaries -> per-slice rounded widths -> merge equal-width runs
    starts = list(range(0, n, slice_rows))
    widths = [pad_to_multiple(
        max(int(sorted_lens[s:min(s + slice_rows, n)].max()), 1),
        width_quantum) for s in starts]
    merged: list = []  # (start, end, w)
    for s, w in zip(starts, widths):
        e = min(s + slice_rows, n)
        if merged and merged[-1][2] == w:
            merged[-1] = (merged[-1][0], e, w)
        else:
            merged.append((s, e, w))

    buckets = []
    offsets = []
    for start, end, w in merged:
        rows_here = perm[start:end]
        data, cols, valid = _gather_band(src_d, src_c, ip[rows_here],
                                         lens[rows_here], w, m.nnz_pad)
        buckets.append(ELL(data=_t(data, m.data), cols=_t(cols),
                           shape=(end - start, m.n_cols),
                           nnz=int(valid.sum()), order="row"))
        offsets.append(start)
    return BucketedELL(perm=_t(perm), buckets=tuple(buckets),
                       row_offsets=tuple(offsets), shape=m.shape, nnz=m.nnz)


# ---------------------------------------------------------------------------
# device transformations (torch ops on the source's device)
# ---------------------------------------------------------------------------
def device_csr_to_ell(m: CSR, width: int, order: str = "row") -> ELL:
    """CRS->ELL on ``m``'s device.  ``width`` is a host-known bound —
    available at call time from MatrixStats, per the paper's run-time model.
    The ``col`` order result is materialized contiguous ``(width, n_rows)``."""
    ip = m.indptr
    lens = ip[1:] - ip[:-1]
    k = torch.arange(width, dtype=ip.dtype, device=ip.device)
    pos = ip[:-1, None] + k[None, :]
    valid = k[None, :] < lens[:, None]
    posc = pos.clamp(0, m.nnz_pad - 1).long()
    data = torch.where(valid, m.data[posc], torch.zeros((), dtype=m.data.dtype,
                                                        device=ip.device))
    cols = torch.where(valid, m.cols[posc], torch.zeros((), dtype=m.cols.dtype,
                                                        device=ip.device))
    if order == "col":
        data, cols = data.t().contiguous(), cols.t().contiguous()
    return ELL(data=data, cols=cols, shape=m.shape, nnz=m.nnz, order=order)


def _expanded_rows(m: CSR) -> torch.Tensor:
    """Row id of every stored slot by binary search over IRP (int64)."""
    k = torch.arange(m.nnz_pad, dtype=m.indptr.dtype, device=m.indptr.device)
    return torch.searchsorted(m.indptr, k, right=True) - 1


def device_csr_to_coo_row(m: CSR) -> COO:
    """CRS->COO-Row: row ids by binary search over IRP; pad slots
    (``k >= nnz``) are masked to row 0."""
    k = torch.arange(m.nnz_pad, device=m.indptr.device)
    rows = torch.where(k < m.nnz, _expanded_rows(m), 0).to(torch.int32)
    return COO(data=m.data, rows=rows, cols=m.cols, shape=m.shape, nnz=m.nnz,
               order="row")


def device_csr_to_coo_col(m: CSR) -> COO:
    """CRS->COO-Column: sentinel-keyed stable sort = counting sort.

    Padded entries get key n_cols so they stay at the tail, preserving the
    padding invariant."""
    coo = device_csr_to_coo_row(m)
    k = torch.arange(m.nnz_pad, device=m.indptr.device)
    live = k < m.nnz
    key = torch.where(live, coo.cols, m.n_cols)
    order = torch.argsort(key, stable=True)
    return COO(data=coo.data[order], rows=coo.rows[order],
               cols=torch.where(live, coo.cols[order], 0).to(torch.int32),
               shape=m.shape, nnz=m.nnz, order="col")


def device_csr_to_ccs(m: CSR) -> CCS:
    """CRS->CCS (the paper's Phase I) on ``m``'s device: the column-sorted
    COO of :func:`device_csr_to_coo_col` plus a column pointer from the
    per-column counts."""
    coo = device_csr_to_coo_col(m)
    counts = torch.bincount(m.cols[: m.nnz].long(), minlength=m.n_cols)
    indptr = torch.zeros(m.n_cols + 1, dtype=torch.int32,
                         device=m.indptr.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return CCS(data=coo.data, rows=coo.rows, indptr=indptr, shape=m.shape,
               nnz=m.nnz)


TRANSFORMS_HOST = {
    "bcsr": lambda m: host_csr_to_bcsr(m),
    "ccs": host_csr_to_ccs,
    "coo_row": host_csr_to_coo_row,
    "coo_col": host_csr_to_coo_col,
    "ell_row": lambda m: host_csr_to_ell(m, order="row"),
    "ell_col": lambda m: host_csr_to_ell(m, order="col"),
    "sell": host_csr_to_sell,
    "csr": lambda m: m,
}

__all__ = [
    "pad_to_multiple", "csr_from_dense", "csr_from_rows",
    "host_csr_to_coo_row", "host_csr_to_ccs_paper", "host_csr_to_ccs",
    "host_csr_to_coo_col", "host_csr_to_ell", "host_csr_to_sell",
    "host_csr_to_bcsr", "device_csr_to_ell", "device_csr_to_coo_row",
    "device_csr_to_coo_col", "device_csr_to_ccs", "TRANSFORMS_HOST",
]
