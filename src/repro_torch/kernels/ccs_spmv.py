"""CCS SpMV and SpMM — hand-written CUDA kernels (``csrc/ccs_spmv.cu``,
``csrc/ccs_spmm.cu``) and their plain PyTorch versions.

Replaces the TPU kernel ``repro/kernels/ccs_spmv.py:ccs_spmv``
(``_ccs_spmv_kernel`` with its slab schedule over the column pointer):
``y[rows[k]] += data[k] * x[c]`` for ``k in [IRP_T[c], IRP_T[c+1])``, float32
accumulation; slots past ``IRP_T[-1]`` (pads of ``(0, row 0)``) are never
read.

Bound on an H100: memory.  The least the card must move is
``nnz * (val + 4) + 4 * (n_cols + 1) + val * n_cols + 4 * n_rows`` bytes over
3.35 TB/s.  Columns scatter to arbitrary rows and meet in global memory with
float32 ``atomicAdd``, so the design issues few of them: a warp owns a run
of adjacent columns (which in a band share most of their rows), walks their
entries 32 a pass and adds those that fall in its private windows of y rows
in shared memory with plain read-add-writes — one window per column mod 4,
so the columns of a pass never share one, and rows checked to rise within a
column; a pass that breaks either has its lanes on one row summed first —
then adds each touched window row to y once; an entry outside the window
goes to y with one atomic (``csrc/ccs_spmv.cu``).
:func:`ccs_spmv_flushes` counts the global atomics on the host.  The
atomics make the order of the sum, and so the last bits, differ from run to
run: CCS results are compared to a tolerance, never bit for bit.

:func:`ccs_spmm` replaces ``repro/kernels/ccs_spmv.py:ccs_spmm``: the same
scatter against an ``(n_cols, B)`` panel.  Where a tile of right-hand-side
columns spans a warp (B > 16), a block owns adjacent columns,
which in a band share most of their rows, and a window of Y rows around the
rows they map to.  It stages its columns' X rows on the chip (X is read
once), sorts its entries by window row, and lane groups that own the window's
rows sum them in registers — no two threads add to one place — then add each
touched row to Y once; an entry outside the window goes to Y with global
atomics.  A narrower tile runs a lane group a column, which keeps the
column's X slice in registers and adds each entry to Y with global atomics
(``csrc/ccs_spmm.cu``).  :func:`ccs_spmm_flushes` counts the global atomics
on the host.

The reference's ``slabs_per_block`` (:func:`~.csr_spmv.slabs_needed` over
the column pointer) is kept only for plan-schema parity; these kernels do
not read it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import build as _build
from ._common import (INT32_MAX, PLAIN_CHUNK_ELEMS, check_contiguous,
                      check_current_device, check_index, check_same_device,
                      ccs_spmm_launch, ccs_spmv_launch, ccs_window_base,
                      check_values, current_stream_ptr)


def _check(data, rows, indptr, x, ndim: int) -> None:
    check_values("data", data, 1)
    check_values("x", x, ndim)
    check_index("rows", rows, data)
    if indptr.dtype != torch.int32 or indptr.ndim != 1 or indptr.shape[0] < 1:
        raise TypeError(f"indptr must be a 1-D int32 tensor of n_cols + 1 "
                        f"entries; got {indptr.dtype} {tuple(indptr.shape)}")
    if x.shape[0] != indptr.shape[0] - 1:
        raise ValueError(f"x has {x.shape[0]} rows for a matrix of "
                         f"{indptr.shape[0] - 1} columns")
    check_same_device(data, rows=rows, indptr=indptr, x=x)


def _slot_cols(indptr: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Column of each stored slot ``k`` (binary search over IRP_T)."""
    return (torch.searchsorted(indptr, k, right=True) - 1).clamp_(
        0, max(indptr.shape[0] - 2, 0))


def ccs_spmv_plain(data: torch.Tensor, rows: torch.Tensor,
                   indptr: torch.Tensor, x: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """Plain PyTorch version: expand IRP_T to a column id per stored slot,
    mask the slots past ``IRP_T[-1]``, scatter-add by row in float32."""
    k = torch.arange(data.shape[0], dtype=indptr.dtype, device=indptr.device)
    live = k < indptr[-1]
    contrib = torch.where(live, data.float() * x.float()[_slot_cols(indptr, k)],
                          0.0)
    y = torch.zeros(n_rows, dtype=torch.float32, device=data.device)
    return y.index_add_(0, torch.where(live, rows, 0), contrib)


def ccs_spmv(data: torch.Tensor, rows: torch.Tensor, indptr: torch.Tensor,
             x: torch.Tensor, n_rows: int, *,
             block_rows: Optional[int] = None) -> torch.Tensor:
    """``y = A @ x`` for CCS arrays; returns float32 ``(n_rows,)``.

    ``block_rows`` is the number of *columns* a CUDA block owns (the
    segmented-axis tile, as the reference reads the knob for CCS), shared
    out to its warps as :func:`~._common.ccs_spmv_launch` says.  CPU
    tensors run :func:`ccs_spmv_plain`; CUDA tensors launch the kernel or
    raise."""
    _check(data, rows, indptr, x, 1)
    if data.device.type == "cpu":
        return ccs_spmv_plain(data, rows, indptr, x, n_rows)
    if data.device.type != "cuda":
        raise ValueError(f"ccs_spmv takes CPU or CUDA tensors; got "
                         f"{data.device}")
    check_current_device(data)
    check_contiguous(data=data, rows=rows, indptr=indptr, x=x)
    if data.numel() > INT32_MAX:
        raise ValueError("nnz_pad exceeds 2^31 - 1: int32 indices cannot "
                         "address it")
    n_cols = indptr.shape[0] - 1
    y = torch.zeros(n_rows, dtype=torch.float32, device=data.device)
    if n_cols == 0 or n_rows == 0 or data.shape[0] == 0:
        return y                 # nothing stored: no launch, none counted
    threads, _, cols_per_warp, window = ccs_spmv_launch(
        n_rows, n_cols, data.shape[0], block_rows)
    code = _build.launcher("ccs_spmv")(
        data.data_ptr(), rows.data_ptr(), indptr.data_ptr(), x.data_ptr(),
        y.data_ptr(), n_rows, n_cols, threads, cols_per_warp, window,
        int(data.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
        current_stream_ptr())
    _build.check_launch("ccs_spmv", code)
    ccs_spmv.launches += 1
    return y


#: number of kernel launches made by :func:`ccs_spmv` in this process
ccs_spmv.launches = 0


def _window_count(rows: torch.Tensor, indptr: torch.Tensor, n_rows: int,
                  cols: int, window: int):
    """``(flushed, outside)`` of windows of ``window`` rows, each owned by a
    run of ``cols`` adjacent columns: the distinct window rows the entries
    touch, and the entries outside their window."""
    ip = indptr.cpu().numpy().astype(np.int64)
    n_cols = ip.shape[0] - 1
    nnz = int(ip[-1]) if n_cols > 0 else 0
    r = rows[:nnz].cpu().numpy().astype(np.int64)
    owner = np.repeat(np.arange(n_cols, dtype=np.int64) // cols, np.diff(ip))
    n_owners = -(-n_cols // cols)
    base = np.array([ccs_window_base(o, cols, window, n_rows, n_cols)
                     for o in range(n_owners)], dtype=np.int64)
    w = r - base[owner]
    inside = (w >= 0) & (w < window)
    touched = np.zeros(n_owners * window, dtype=bool)
    touched[owner[inside] * window + w[inside]] = True
    return int(touched.sum()), int(nnz - inside.sum())


def ccs_spmv_flushes(rows: torch.Tensor, indptr: torch.Tensor, n_rows: int,
                     block_rows: Optional[int] = None) -> dict:
    """The global atomics :func:`ccs_spmv` issues at its launch, counted on
    the host from the structure: ``cols`` adjacent columns a warp owns, its
    ``window`` rows, ``flushed`` window rows (one per row an entry of the
    warp touched inside its window), ``outside`` entries (one each), and
    ``atomics``, their sum (the parent design's ``nnz``)."""
    n_cols = indptr.shape[0] - 1
    _, _, cols, window = ccs_spmv_launch(n_rows, n_cols, rows.shape[0],
                                         block_rows)
    flushed, outside = (_window_count(rows, indptr, n_rows, cols, window)
                        if n_cols > 0 and n_rows > 0 else (0, 0))
    return {"cols": cols, "window": window, "flushed": flushed,
            "outside": outside, "atomics": flushed + outside}


def ccs_spmm_plain(data: torch.Tensor, rows: torch.Tensor,
                   indptr: torch.Tensor, x: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """Plain PyTorch version: column id per stored slot by binary search
    over IRP_T, float32 scatter-add of ``data[k] * x[c, :]`` by row in
    chunks of entries (no temporary above ``PLAIN_CHUNK_ELEMS``); slots past
    ``IRP_T[-1]`` are never read."""
    batch = x.shape[1]
    nnz = int(indptr[-1])
    xf = x.float()
    y = torch.zeros((n_rows, batch), dtype=torch.float32, device=data.device)
    step = max(1, PLAIN_CHUNK_ELEMS // max(batch, 1))
    for k0 in range(0, nnz, step):
        k = torch.arange(k0, min(k0 + step, nnz), dtype=indptr.dtype,
                         device=indptr.device)
        y.index_add_(0, rows[k],
                     data[k].float()[:, None] * xf[_slot_cols(indptr, k)])
    return y


def ccs_spmm(data: torch.Tensor, rows: torch.Tensor, indptr: torch.Tensor,
             x: torch.Tensor, n_rows: int, *,
             block_rows: Optional[int] = None,
             block_k: Optional[int] = None) -> torch.Tensor:
    """``Y = A @ X`` for CCS arrays and a contiguous ``(n_cols, B)`` panel;
    returns float32 ``(n_rows, B)``.  ``block_rows`` is the number of
    columns and ``block_k`` the number of right-hand-side columns a CUDA
    block owns; the rows of its shared Y window follow from them and the
    shape (host ints: nothing is read back from the device).  CPU tensors
    run :func:`ccs_spmm_plain`; CUDA tensors launch the kernel or raise."""
    _check(data, rows, indptr, x, 2)
    if data.device.type == "cpu":
        return ccs_spmm_plain(data, rows, indptr, x, n_rows)
    if data.device.type != "cuda":
        raise ValueError(f"ccs_spmm takes CPU or CUDA tensors; got "
                         f"{data.device}")
    check_current_device(data)
    check_contiguous(data=data, rows=rows, indptr=indptr, x=x)
    if data.numel() > INT32_MAX:
        raise ValueError("nnz_pad exceeds 2^31 - 1: int32 indices cannot "
                         "address it")
    n_cols = indptr.shape[0] - 1
    batch = x.shape[1]
    y = torch.zeros((n_rows, batch), dtype=torch.float32, device=data.device)
    if n_cols == 0 or n_rows == 0 or batch == 0 or data.shape[0] == 0:
        return y                 # nothing stored: no launch, none counted
    kt, lanes, per_lane, threads, cols, window, rows_per_group = \
        ccs_spmm_launch(batch, n_rows, n_cols, data.shape[0], block_rows,
                        block_k)
    code = _build.launcher("ccs_spmm")(
        data.data_ptr(), rows.data_ptr(), indptr.data_ptr(), x.data_ptr(),
        y.data_ptr(), n_rows, n_cols, batch, kt, lanes, per_lane, threads,
        cols, window, rows_per_group,
        int(data.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
        current_stream_ptr())
    _build.check_launch("ccs_spmm", code)
    ccs_spmm.launches += 1
    return y


def ccs_spmm_flushes(rows: torch.Tensor, indptr: torch.Tensor, n_rows: int,
                     batch: int, block_rows: Optional[int] = None,
                     block_k: Optional[int] = None) -> dict:
    """The global atomics :func:`ccs_spmm` issues at its launch for
    ``batch`` right-hand sides, counted on the host from the structure:
    ``flushed`` window rows (one per row an entry of the block touched
    inside its window), ``outside`` entries (one each, outside the window),
    and ``atomics``, their float32 additions, ``(flushed + outside) * B``
    (the parent design's ``nnz * B``)."""
    n_cols = indptr.shape[0] - 1
    _, _, _, _, cols, window, _ = ccs_spmm_launch(batch, n_rows, n_cols,
                                                  rows.shape[0], block_rows,
                                                  block_k)
    if window == 0:           # a narrow tile: every entry straight to Y
        nnz = int(indptr[-1]) if n_cols > 0 else 0
        return {"cols": cols, "window": 0, "flushed": 0, "outside": nnz,
                "atomics": nnz * batch}
    flushed, outside = _window_count(rows, indptr, n_rows, cols, window)
    return {"cols": cols, "window": window, "flushed": flushed,
            "outside": outside, "atomics": (flushed + outside) * batch}


#: number of kernel launches made by :func:`ccs_spmm` in this process
ccs_spmm.launches = 0

__all__ = ["ccs_spmv", "ccs_spmv_flushes", "ccs_spmv_plain", "ccs_spmm",
           "ccs_spmm_flushes", "ccs_spmm_plain"]
