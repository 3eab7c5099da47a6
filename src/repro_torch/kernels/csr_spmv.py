"""CSR SpMV and SpMM — hand-written CUDA kernels (``csrc/csr_spmv.cu``,
``csrc/csr_spmm.cu``) and their plain PyTorch versions.

Replaces the TPU kernel ``repro/kernels/csr_spmv.py:csr_spmv``
(``_csr_spmv_kernel`` with its slab schedule): ``y[r] = sum_{k in [IRP[r],
IRP[r+1])} data[k] * x[cols[k]]``, float32 accumulation; slots past
``IRP[-1]`` are never read.

Bound on an H100: memory.  The least the card must move is
``nnz * (val + 4) + 4 * (n_rows + 1) + val * n_cols + 4 * n_rows`` bytes over
3.35 TB/s.  The design cuts the work by entries, not rows: each CUDA block
owns a slice of ``block_nnz`` entries, finds the rows it owns by a search over
IRP (a first small kernel), sums a few consecutive entries a thread
(16-byte loads) and joins each row's partial sums by a keyed scan over the
warp and across the block's warps, with plain stores only; a row that
crosses slices leaves one partial sum a slice in a carry buffer, which a
last small kernel adds in slice order.  So a row of
thousands of entries costs what as many short rows cost, there is no static
bound on a row's length, and ``y`` is the same bit for bit from run to run
(``csrc/csr_spmv.cu``).

:func:`csr_spmm` replaces ``repro/kernels/csr_spmv.py:csr_spmm``: the same
sum against an ``(n_cols, B)`` panel.  Bound on an H100: memory — A once,
``val * n_cols * B`` for X and ``4 * n_rows * B`` for Y, against
``2 * nnz * B`` flops; what stands in the way is the gather of one X row per
stored entry.  The window kernel gives a CUDA block consecutive rows and a
window of the X rows they share in shared memory, filled by bulk
asynchronous copies and placed at the least first column of its rows (an
entry inside reads its X row there, one outside from global), stages the
block's entries in shared memory, and sums a row longer than the window
with the whole block.  The row-group kernel gives a row to a lane group
and reads every X row from global.  In both a row's group sits along the
tile's columns and stores its Y row once (``csrc/csr_spmm.cu``).  A bound
matrix takes the window kernel where its structure says it pays
(:func:`csr_spmm_structure`, ``_common.csr_spmm_window``).
:func:`csr_spmm_window_misses` counts on the host the entries the windows
do not serve; :func:`csr_spmm_window_plain` is the plain version that reads
X through the same windows (what the CPU wrapper runs).

:func:`slabs_needed` is kept from the reference only so that plan JSON and
``PlannedMatrix.tunings`` carry the same ``slabs_per_block`` value in both
packages; this kernel does not read it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import build as _build
from ._common import (INT32_MAX, MAX_BLOCK_K, PLAIN_CHUNK_ELEMS,
                      check_contiguous, check_current_device, check_index,
                      check_same_device, check_values, csr_slices,
                      csr_spmm_launch, current_stream_ptr)


def slabs_needed(indptr, block_rows: int, block_nnz: int) -> int:
    """The reference's static per-row-block slab count for a concrete IRP
    (pure numpy).  Slab starts are floor-aligned to ``block_nnz``, so a block
    of ``block_rows`` rows needs the slabs from ``floor(first / bn)`` through
    ``floor((last - 1) / bn)``.  Plan-schema parity only."""
    ip = np.asarray(indptr)
    n_rows = ip.shape[0] - 1
    edges = ip[np.minimum(np.arange(0, n_rows + block_rows, block_rows),
                          n_rows)]
    starts, ends = edges[:-1], edges[1:]
    if starts.size == 0:
        return 1
    needed = np.where(ends > starts,
                      (ends - 1) // block_nnz - starts // block_nnz + 1, 1)
    return max(int(needed.max()), 1)


def csr_spmv_plain(data: torch.Tensor, cols: torch.Tensor,
                   indptr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: expand IRP to a row id per stored slot, mask
    the slots past ``IRP[-1]``, scatter-add in float32."""
    n_rows = indptr.shape[0] - 1
    nnz_pad = data.shape[0]
    k = torch.arange(nnz_pad, dtype=indptr.dtype, device=indptr.device)
    rows = torch.searchsorted(indptr, k, right=True) - 1
    live = k < indptr[-1]
    rows = torch.where(live, rows, 0).clamp_(0, max(n_rows - 1, 0))
    contrib = torch.where(live, data.float() * x.float()[cols], 0.0)
    y = torch.zeros(n_rows, dtype=torch.float32, device=data.device)
    return y.index_add_(0, rows, contrib)


def csr_spmv(data: torch.Tensor, cols: torch.Tensor, indptr: torch.Tensor,
             x: torch.Tensor, *,
             block_nnz: Optional[int] = None) -> torch.Tensor:
    """``y = A @ x`` for CSR arrays; returns float32 ``(n_rows,)``, the same
    bits on every launch of the same shape.

    ``block_nnz`` is the number of entries a CUDA block owns (a slice); the
    launch shape comes from host ints only (nothing is read back from the
    device).  CPU tensors run :func:`csr_spmv_plain`; CUDA tensors launch the
    kernel or raise."""
    check_values("data", data, 1)
    check_values("x", x, 1)
    check_index("cols", cols, data)
    if indptr.dtype != torch.int32 or indptr.ndim != 1 or indptr.shape[0] < 1:
        raise TypeError(f"indptr must be a 1-D int32 tensor of n_rows + 1 "
                        f"entries; got {indptr.dtype} {tuple(indptr.shape)}")
    check_same_device(data, cols=cols, indptr=indptr, x=x)
    if data.device.type == "cpu":
        return csr_spmv_plain(data, cols, indptr, x)
    if data.device.type != "cuda":
        raise ValueError(f"csr_spmv takes CPU or CUDA tensors; got "
                         f"{data.device}")
    check_current_device(data)
    check_contiguous(data=data, cols=cols, indptr=indptr, x=x)
    if data.numel() > INT32_MAX or x.numel() > INT32_MAX:
        raise ValueError("nnz_pad or n_cols exceeds 2^31 - 1: int32 indices "
                         "cannot address it")
    n_rows = indptr.shape[0] - 1
    if n_rows == 0:
        # no row to write: no launch, none counted
        return torch.zeros(0, dtype=torch.float32, device=data.device)
    threads, bn, chunk, n_slices = csr_slices(data.shape[0], block_nnz)
    y = torch.empty(n_rows, dtype=torch.float32, device=data.device)
    # each slice's first row, then its carry's row and float32 sum
    scratch = torch.empty(3 * n_slices + 1, dtype=torch.int32,
                          device=data.device)
    code = _build.launcher("csr_spmv")(
        data.data_ptr(), cols.data_ptr(), indptr.data_ptr(), x.data_ptr(),
        y.data_ptr(), scratch.data_ptr(), n_rows, data.shape[0], n_slices,
        threads, bn, chunk, int(data.dtype == torch.bfloat16),
        int(x.dtype == torch.bfloat16), current_stream_ptr())
    _build.check_launch("csr_spmv", code)
    csr_spmv.launches += 1
    return y


#: number of kernel launches made by :func:`csr_spmv` in this process
csr_spmv.launches = 0


def csr_spmm_plain(data: torch.Tensor, cols: torch.Tensor,
                   indptr: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: row id per stored slot by binary search over
    IRP, float32 scatter-add of ``data[k] * x[cols[k], :]`` in chunks of
    entries (no temporary above ``PLAIN_CHUNK_ELEMS``); slots past
    ``IRP[-1]`` are never read."""
    n_rows = indptr.shape[0] - 1
    batch = x.shape[1]
    nnz = int(indptr[-1]) if n_rows > 0 else 0
    xf = x.float()
    y = torch.zeros((n_rows, batch), dtype=torch.float32, device=data.device)
    step = max(1, PLAIN_CHUNK_ELEMS // max(batch, 1))
    for k0 in range(0, nnz, step):
        k = torch.arange(k0, min(k0 + step, nnz), dtype=indptr.dtype,
                         device=indptr.device)
        rows = torch.searchsorted(indptr, k, right=True) - 1
        y.index_add_(0, rows, data[k].float()[:, None] * xf[cols[k]])
    return y


def csr_spmm_windows(cols: torch.Tensor, indptr: torch.Tensor, n_cols: int,
                     rows: int, window: int, stage: int):
    """``(lo, held)`` per CUDA block of a windowed :func:`csr_spmm` launch
    whose blocks own ``rows`` rows and stage their first ``stage`` entries,
    as ``csrc/csr_spmm.cu`` places them: the window starts at the least
    first column of the block's rows that hold 1 to ``window`` entries,
    moved left where it would pass the last column; the block keeps it
    (``held`` X rows, else 0) only if more of its staged entries fall inside
    it than it has X rows to fetch."""
    ip = indptr.long()
    n_rows = ip.shape[0] - 1
    n_blocks = -(-n_rows // rows)
    start, end = ip[:-1], ip[1:]
    vote = (end - start >= 1) & (end - start <= window)
    zeros = torch.zeros(n_blocks, dtype=torch.long, device=ip.device)
    if not bool(vote.any()):
        return zeros, zeros.clone()
    c = cols.long()
    block = torch.arange(n_rows, device=ip.device) // rows
    none = torch.iinfo(torch.long).max
    first = torch.where(vote, c[start.clamp(0, c.shape[0] - 1)], none)
    lo = torch.full((n_blocks,), none, dtype=torch.long,
                    device=ip.device).scatter_reduce(0, block, first, "amin")
    some = lo != none
    lo = torch.where(some, torch.clamp(lo, max=max(0, n_cols - window)), 0)
    held = torch.where(some, torch.clamp(n_cols - lo, max=window), 0)
    # the staged entries: the first `stage` of each block's
    k = torch.arange(int(ip[-1]), device=ip.device)
    blk = (torch.searchsorted(ip, k, right=True) - 1) // rows
    staged = k - ip[blk * rows] < stage
    off = c[k] - lo[blk]
    inside = staged & (off >= 0) & (off < held[blk])
    hits = zeros.index_add(0, blk, inside.long())
    keep = (hits > 0) & (hits >= held)
    return torch.where(keep, lo, 0), torch.where(keep, held, 0)


def _spmm_launch(indptr, x, nnz_pad, block_rows, block_k, window):
    return csr_spmm_launch(x.shape[1], indptr.shape[0] - 1, x.shape[0],
                           nnz_pad, block_rows, block_k, x.element_size(),
                           window)


def csr_spmm_structure(cols: torch.Tensor, indptr: torch.Tensor,
                       n_cols: int) -> tuple:
    """``(heavy, served)`` of a CSR matrix for :func:`csr_spmm`'s choice of
    kernel (``_common.csr_spmm_window``), from the window launch at the
    widest tile (float32, the default rows a block; its window the
    narrowest): whether a row is longer than that window, and the share of
    the entries the windows serve.  One pass over the entries on their
    device, one read back."""
    n_rows = indptr.shape[0] - 1
    _, _, _, _, rows, window, stage = csr_spmm_launch(
        MAX_BLOCK_K, n_rows, n_cols, cols.shape[0], window=True)
    nnz = int(indptr[-1]) if n_rows > 0 else 0
    if nnz == 0:
        return False, 0.0
    heavy = int((indptr[1:] - indptr[:-1]).max()) > window
    lo, held = csr_spmm_windows(cols, indptr, n_cols, rows, window, stage)
    return heavy, 1.0 - _outside(cols, indptr, nnz, rows, lo, held) / nnz


def _outside(cols, indptr, nnz, rows, lo, held) -> int:
    """The first ``nnz`` entries outside their block's window."""
    ip = indptr.long()
    k = torch.arange(nnz, device=ip.device)
    blk = (torch.searchsorted(ip, k, right=True) - 1) // rows
    off = cols[:nnz].long() - lo[blk]
    return nnz - int(((off >= 0) & (off < held[blk])).sum())


def csr_spmm_window_plain(data: torch.Tensor, cols: torch.Tensor,
                          indptr: torch.Tensor, x: torch.Tensor, *,
                          block_rows: Optional[int] = None,
                          block_k: Optional[int] = None,
                          window: Optional[bool] = None) -> torch.Tensor:
    """Plain PyTorch version of the windowed launch: each block's window is
    built as the kernel holds it (X rows ``lo .. lo + held``, NaN past them,
    so a read outside shows), an entry inside reads its X row there, one
    outside from ``x``; float32 scatter-add, blocks taken in chunks (no
    temporary far above ``PLAIN_CHUNK_ELEMS``).  A launch with no window is
    :func:`csr_spmm_plain`."""
    n_rows = indptr.shape[0] - 1
    batch, n_cols = x.shape[1], x.shape[0]
    _, _, _, _, rows, window, stage = _spmm_launch(
        indptr, x, data.shape[0], block_rows, block_k, window)
    if window == 0 or n_rows == 0 or n_cols == 0:
        return csr_spmm_plain(data, cols, indptr, x)
    lo, held = csr_spmm_windows(cols, indptr, n_cols, rows, window, stage)
    ip = indptr.long()
    xf = x.float()
    y = torch.zeros((n_rows, batch), dtype=torch.float32, device=data.device)
    w = torch.arange(window, device=data.device)
    per_row = -(-int(ip[-1]) // n_rows)
    step = max(1, PLAIN_CHUNK_ELEMS // ((window + rows * per_row) * batch))
    for b0 in range(0, lo.shape[0], step):
        b1 = min(b0 + step, lo.shape[0])
        at = lo[b0:b1, None] + w
        xw = torch.where((w < held[b0:b1, None])[..., None],
                         xf[at.clamp(max=n_cols - 1)], float("nan"))
        k = torch.arange(int(ip[b0 * rows]), int(ip[min(b1 * rows, n_rows)]),
                         device=data.device)
        r = torch.searchsorted(ip, k, right=True) - 1
        blk = r // rows
        c = cols[k].long()
        off = c - lo[blk]
        inside = (off >= 0) & (off < held[blk])
        xv = torch.where(inside[:, None],
                         xw[blk - b0, off.clamp(0, window - 1)], xf[c])
        y.index_add_(0, r, data[k].float()[:, None] * xv)
    return y


def csr_spmm_window_misses(cols: torch.Tensor, indptr: torch.Tensor,
                           n_cols: int, batch: int, *,
                           block_rows: Optional[int] = None,
                           block_k: Optional[int] = None,
                           x_dtype: torch.dtype = torch.float32,
                           window: Optional[bool] = None) -> dict:
    """How much of a :func:`csr_spmm` launch its windows serve, counted on
    the host from the structure (in the manner of ``ccs_spmv_flushes``):
    ``rows`` a block owns, ``window`` rows it may hold (0: no window at this
    tile), ``blocks`` and ``windowed`` blocks, ``window_x_rows`` X rows the
    windows fetch (per column tile), and the ``entries`` whose X row comes
    from global, ``misses`` (every entry where there is no window)."""
    n_rows = indptr.shape[0] - 1
    size = torch.empty(0, dtype=x_dtype).element_size()
    _, _, _, _, rows, window, stage = csr_spmm_launch(
        batch, n_rows, n_cols, cols.shape[0], block_rows, block_k, size,
        window)
    nnz = int(indptr[-1]) if n_rows > 0 else 0
    out = {"rows": rows, "window": window, "blocks": -(-n_rows // rows),
           "windowed": 0, "window_x_rows": 0, "entries": nnz,
           "misses": nnz}
    if window == 0 or nnz == 0:
        return out
    lo, held = csr_spmm_windows(cols, indptr, n_cols, rows, window, stage)
    out.update(windowed=int((held > 0).sum()), window_x_rows=int(held.sum()),
               misses=_outside(cols, indptr, nnz, rows, lo, held))
    return out


def csr_spmm(data: torch.Tensor, cols: torch.Tensor, indptr: torch.Tensor,
             x: torch.Tensor, *, block_rows: Optional[int] = None,
             block_k: Optional[int] = None,
             window: Optional[bool] = None) -> torch.Tensor:
    """``Y = A @ X`` for CSR arrays and a contiguous ``(n_cols, B)`` panel;
    returns float32 ``(n_rows, B)``.  ``block_rows`` is the number of rows
    and ``block_k`` the number of right-hand-side columns a CUDA block owns;
    ``window`` picks the window kernel (``None``: by the tile alone,
    :func:`~._common.csr_spmm_window`; see
    :func:`~._common.csr_spmm_launch`).  CPU tensors run
    :func:`csr_spmm_window_plain`; CUDA tensors launch the kernel or
    raise."""
    check_values("data", data, 1)
    check_values("x", x, 2)
    check_index("cols", cols, data)
    if indptr.dtype != torch.int32 or indptr.ndim != 1 or indptr.shape[0] < 1:
        raise TypeError(f"indptr must be a 1-D int32 tensor of n_rows + 1 "
                        f"entries; got {indptr.dtype} {tuple(indptr.shape)}")
    check_same_device(data, cols=cols, indptr=indptr, x=x)
    if data.device.type == "cpu":
        return csr_spmm_window_plain(data, cols, indptr, x,
                                     block_rows=block_rows, block_k=block_k,
                                     window=window)
    if data.device.type != "cuda":
        raise ValueError(f"csr_spmm takes CPU or CUDA tensors; got "
                         f"{data.device}")
    check_current_device(data)
    check_contiguous(data=data, cols=cols, indptr=indptr, x=x)
    if data.numel() > INT32_MAX:
        raise ValueError("nnz_pad exceeds 2^31 - 1: int32 indices cannot "
                         "address it")
    n_rows = indptr.shape[0] - 1
    batch = x.shape[1]
    if n_rows == 0 or batch == 0:
        # no output element to write: no launch, none counted
        return torch.zeros((n_rows, batch), dtype=torch.float32,
                           device=data.device)
    kt, lanes, per_lane, threads, rows, window, stage = _spmm_launch(
        indptr, x, data.shape[0], block_rows, block_k, window)
    y = torch.empty((n_rows, batch), dtype=torch.float32, device=data.device)
    code = _build.launcher("csr_spmm")(
        data.data_ptr(), cols.data_ptr(), indptr.data_ptr(), x.data_ptr(),
        y.data_ptr(), n_rows, x.shape[0], batch, kt, lanes, per_lane,
        threads, rows, window, stage, int(data.dtype == torch.bfloat16),
        int(x.dtype == torch.bfloat16), current_stream_ptr())
    _build.check_launch("csr_spmm", code)
    csr_spmm.launches += 1
    return y


#: number of kernel launches made by :func:`csr_spmm` in this process
csr_spmm.launches = 0

__all__ = ["csr_spmv", "csr_spmv_plain", "csr_spmm", "csr_spmm_plain",
           "csr_spmm_structure", "csr_spmm_window_misses",
           "csr_spmm_window_plain", "csr_spmm_windows", "slabs_needed"]
