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


def copy_out(m: CSR) -> CSR:
    """``m`` with its tensors on the host, one copy of each array (none
    when they are there already), inside a ``transform.copy_out`` span:
    the card-to-host leg of a host recipe (the copy to pageable memory
    returns when it is done, so the host's clock times it)."""
    with _obs.get().span("transform.copy_out", nnz=int(m.nnz)):
        return m if m.device.type == "cpu" else m.to("cpu")


def _traced(fmt: str):
    """Wrap a host conversion in a ``transform`` span carrying the target
    format, matrix size, and any simple keyword parameters — so t_trans
    shows up per conversion in every trace, not just in offline records.
    The source is copied to the host once, before the recipe reads it
    (:func:`copy_out`)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(m, *a, **kw):
            # deterministic fault point for chaos tests: a conversion that
            # "fails" here exercises the service's degrade-to-CSR path
            # (the CSR identity is not _traced, so fallbacks stay clean)
            from ..serve import faults as _faults
            _faults.maybe_raise("transform.raise")
            tel = _obs.get()
            if not tel.enabled:
                return fn(copy_out(m), *a, **kw)
            attrs = {"fmt": fmt,
                     "n_rows": int(getattr(m, "n_rows", 0) or 0),
                     "nnz": int(getattr(m, "nnz", 0) or 0)}
            attrs.update((k, v) for k, v in kw.items()
                         if isinstance(v, (bool, int, float, str)))
            with tel.span("transform", **attrs):
                return fn(copy_out(m), *a, **kw)
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
# incremental CSR edits (streaming substrate; see repro_torch.stream.delta)
#
# torch ops on the CSR's own device: a matrix on the card is edited there.
# What crosses to the host is the size of the edit, never of the matrix —
# the edited rows' starts and lengths, and where each probed entry lies.
# ---------------------------------------------------------------------------
def _dev_i64(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def csr_row_bounds(m: CSR, rows: np.ndarray):
    """``(starts, lengths)`` of ``rows`` as host int64 arrays: one gather on
    ``m``'s device and one read back of two integers a row."""
    rows = np.asarray(rows, dtype=np.int64)
    if rows.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    r = _dev_i64(rows, m.indptr.device)
    ip = m.indptr.long()
    se = torch.stack([ip[r], ip[r + 1]]).cpu().numpy()
    return se[0], se[1] - se[0]


def csr_first_match(m: CSR, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Position of the first stored entry ``(rows[i], cols[i])`` in ``m``'s
    slots, ``-1`` where the row stores no such column (host int64).  One
    flat probe over the queried rows' segments on ``m``'s device — cell
    ``k`` of query ``q`` reads slot ``start[q] + k`` — reduced to the least
    matching slot a query."""
    rows = np.asarray(rows, dtype=np.int64)
    nq = rows.shape[0]
    pos = np.full(nq, -1, dtype=np.int64)
    starts, lens = csr_row_bounds(m, rows)
    total = int(lens.sum())
    if total == 0:
        return pos
    dev = m.indptr.device
    q = torch.repeat_interleave(torch.arange(nq, device=dev),
                                _dev_i64(lens, dev), output_size=total)
    offs = _dev_i64(np.cumsum(lens) - lens, dev)
    flat = _dev_i64(starts, dev)[q] + (torch.arange(total, device=dev)
                                       - offs[q])
    hit = m.cols[flat].long() == _dev_i64(cols, dev)[q]
    none = torch.iinfo(torch.int64).max
    first = torch.full((nq,), none, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, q, torch.where(hit, flat, none), "amin")
    first = first.cpu().numpy()
    found = first != none
    pos[found] = first[found]
    return pos


def csr_append_rows(m: CSR, row_cols: Sequence[np.ndarray],
                    row_vals: Sequence[np.ndarray], *,
                    in_place: bool = True, growth: float = 2.0,
                    lens: Optional[np.ndarray] = None) -> CSR:
    """Append whole rows at the tail in O(Δnnz).

    When the existing ``nnz_pad`` slack can hold the new nonzeros (and
    ``in_place`` is allowed) the data/cols tensors are written in place and
    **shared** with the input; otherwise fresh ones are allocated on the
    same device with ``growth``× headroom so repeated appends amortize.
    Only the indptr is ever rebuilt (O(n) int copy on the device).

    ``row_cols``/``row_vals`` are per-row host arrays — or, with ``lens``
    given, single already-flattened arrays."""
    flat = isinstance(row_cols, np.ndarray)
    if lens is None:
        if flat:
            raise ValueError("flattened row_cols requires explicit lens")
        k = len(row_cols)
        lens = np.fromiter((len(c) for c in row_cols), count=k,
                           dtype=np.int64)
    else:
        k = int(np.asarray(lens).shape[0])
    if k == 0:
        return m
    n_rows, n_cols = m.shape
    d = int(np.asarray(lens).sum())
    new_nnz = m.nnz + d
    ip = m.indptr
    dev = ip.device
    new_ip = torch.empty(n_rows + k + 1, dtype=ip.dtype, device=dev)
    new_ip[: n_rows + 1] = ip
    new_ip[n_rows + 1:] = _dev_i64(m.nnz + np.cumsum(lens), dev).to(ip.dtype)
    if in_place and new_nnz <= m.nnz_pad:
        out_d, out_c = m.data, m.cols
    else:
        new_pad = max(new_nnz, int(growth * m.nnz_pad))
        out_d = torch.empty(new_pad, dtype=m.data.dtype, device=dev)
        out_c = torch.empty(new_pad, dtype=m.cols.dtype, device=dev)
        out_d[: m.nnz] = m.data[: m.nnz]
        out_c[: m.nnz] = m.cols[: m.nnz]
        # only the slack needs the (0, 0) pad convention; [nnz, new_nnz)
        # is overwritten by the appended entries below
        out_d[new_nnz:] = 0
        out_c[new_nnz:] = 0
    if d:
        vals = row_vals if flat else np.concatenate(
            [np.asarray(v, dtype=np.float32) for v in row_vals])
        cols = row_cols if flat else np.concatenate(
            [np.asarray(c, dtype=np.int64) for c in row_cols])
        out_d[m.nnz:new_nnz] = torch.as_tensor(
            np.asarray(vals, dtype=np.float32)).to(dev, out_d.dtype)
        out_c[m.nnz:new_nnz] = _dev_i64(cols, dev).to(out_c.dtype)
    return CSR(data=out_d, cols=out_c, indptr=new_ip,
               shape=(n_rows + k, n_cols), nnz=new_nnz)


def csr_set_values(m: CSR, rows: np.ndarray, cols: np.ndarray,
                   vals: np.ndarray, *, in_place: bool = True):
    """Overwrite existing nonzeros in O(Δ · row_len).

    Returns ``(csr, hit)`` where ``hit[i]`` is False when ``(rows[i],
    cols[i])`` has no stored entry (the caller routes misses to
    :func:`csr_splice` as inserts).  With ``in_place`` the value tensor is
    written and the input CSR object itself is returned.  Two updates of
    one entry leave the later value, as the reference's numpy store does
    (a CUDA store of repeated indices keeps an arbitrary one, so repeats
    are dropped first)."""
    pos = csr_first_match(m, rows, np.asarray(cols, dtype=np.int64))
    hit = pos >= 0
    if not hit.any():
        return m, hit
    ph = pos[hit]
    vh = np.asarray(vals, dtype=np.float32)[hit]
    # the last update of each position: first occurrence in reverse order
    uniq, first_rev = np.unique(ph[::-1], return_index=True)
    last = ph.shape[0] - 1 - first_rev
    data = m.data if in_place else m.data.clone()
    dev = data.device
    data[_dev_i64(uniq, dev)] = torch.as_tensor(vh[last]).to(dev, data.dtype)
    if in_place:
        return m, hit
    return CSR(data=data, cols=m.cols, indptr=m.indptr, shape=m.shape,
               nnz=m.nnz), hit


def csr_splice(m: CSR,
               insert_rows: np.ndarray, insert_cols: np.ndarray,
               insert_vals: np.ndarray,
               delete_rows: np.ndarray, delete_cols: np.ndarray) -> CSR:
    """Insert/delete individual nonzeros in one scatter on the device.

    O(nnz) — far cheaper than any format re-transform, but not O(Δ); the
    streaming layer records it as its own apply mode.  A delete removes the
    first stored match of ``(r, c)`` in row ``r``; a delete of an absent
    entry, or of one an earlier request already removed, is ignored.
    Inserts land at their row's end in stable row order (CSR does not
    require column order within a row).  Every surviving entry moves by
    the deletes before it and the inserts of the rows before its own; a
    deleted one is written to a slot past the end and dropped."""
    n_rows, nnz = m.n_rows, m.nnz
    dev = m.data.device
    ip = m.indptr.long()
    change = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    gone = np.zeros(0, dtype=np.int64)
    delete_rows = np.asarray(delete_rows, dtype=np.int64)
    if delete_rows.shape[0]:
        pos = csr_first_match(m, delete_rows,
                              np.asarray(delete_cols, dtype=np.int64))
        found = pos >= 0
        gone, first = np.unique(pos[found], return_index=True)
        change.index_add_(0, _dev_i64(delete_rows[found][first], dev),
                          torch.full((gone.shape[0],), -1, dtype=torch.int64,
                                     device=dev))
    insert_rows = np.asarray(insert_rows, dtype=np.int64)
    k = insert_rows.shape[0]
    if k:
        order = np.argsort(insert_rows, kind="stable")
        ir = insert_rows[order]
        ic = np.asarray(insert_cols, dtype=np.int64)[order]
        iv = np.asarray(insert_vals, dtype=np.float32)[order]
        ir_t = _dev_i64(ir, dev)
        added = torch.zeros(n_rows, dtype=torch.int64, device=dev)
        added.index_add_(0, ir_t, torch.ones(k, dtype=torch.int64,
                                             device=dev))
        change += added
    new_nnz = nnz - int(gone.shape[0]) + k
    new_pad = max(m.nnz_pad, new_nnz)
    new_ip = torch.zeros_like(ip)
    new_ip[1:] = ip[1:] + torch.cumsum(change, 0)
    out_d = torch.zeros(new_pad + 1, dtype=m.data.dtype, device=dev)
    out_c = torch.zeros(new_pad + 1, dtype=m.cols.dtype, device=dev)
    if nnz:
        p = torch.arange(nnz, device=dev)
        row = torch.searchsorted(ip, p, right=True) - 1
        dropped = torch.zeros(nnz, dtype=torch.int64, device=dev)
        dropped[_dev_i64(gone, dev)] = 1
        shift = torch.cumsum(dropped, 0) - dropped      # deletes before p
        to = p - shift
        if k:
            to += (torch.cumsum(added, 0) - added)[row]  # inserts above
        to = torch.where(dropped.bool(), new_pad, to)
        out_d[to] = m.data[:nnz]
        out_c[to] = m.cols[:nnz]
    if k:
        # the j-th insert of row r lands j slots past r's surviving entries
        j = np.arange(k) - np.searchsorted(ir, ir, side="left")
        to = new_ip[ir_t + 1] - added[ir_t] + _dev_i64(j, dev)
        out_d[to] = torch.as_tensor(iv).to(dev, out_d.dtype)
        out_c[to] = _dev_i64(ic, dev).to(out_c.dtype)
    return CSR(data=out_d[:new_pad], cols=out_c[:new_pad],
               indptr=new_ip.to(m.indptr.dtype), shape=m.shape, nnz=new_nnz)


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


@_traced("hybrid")
def _host_csr_to_hybrid(m: CSR, **kw):
    # lazy import: repro_torch.partition imports this module at load time
    from ..partition import host_csr_to_hybrid
    return host_csr_to_hybrid(m, **kw)


TRANSFORMS_HOST = {
    "bcsr": lambda m: host_csr_to_bcsr(m),
    "hybrid": _host_csr_to_hybrid,
    "ccs": host_csr_to_ccs,
    "coo_row": host_csr_to_coo_row,
    "coo_col": host_csr_to_coo_col,
    "ell_row": lambda m: host_csr_to_ell(m, order="row"),
    "ell_col": lambda m: host_csr_to_ell(m, order="col"),
    "sell": host_csr_to_sell,
    "csr": lambda m: m,
}

__all__ = [
    "pad_to_multiple", "copy_out", "csr_from_dense", "csr_from_rows",
    "csr_row_bounds", "csr_first_match", "csr_append_rows",
    "csr_set_values", "csr_splice",
    "host_csr_to_coo_row", "host_csr_to_ccs_paper", "host_csr_to_ccs",
    "host_csr_to_coo_col", "host_csr_to_ell", "host_csr_to_sell",
    "host_csr_to_bcsr", "device_csr_to_ell", "device_csr_to_coo_row",
    "device_csr_to_coo_col", "device_csr_to_ccs", "TRANSFORMS_HOST",
]
