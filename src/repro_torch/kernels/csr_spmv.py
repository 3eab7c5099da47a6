"""CSR SpMV and SpMM — hand-written CUDA kernels (``csrc/csr_spmv.cu``,
``csrc/csr_spmm.cu``) and their plain PyTorch versions.

Replaces the TPU kernel ``repro/kernels/csr_spmv.py:csr_spmv``
(``_csr_spmv_kernel`` with its slab schedule): ``y[r] = sum_{k in [IRP[r],
IRP[r+1])} data[k] * x[cols[k]]``, float32 accumulation; slots past
``IRP[-1]`` are never read.

Bound on an H100: memory.  The least the card must move is
``nnz * (val + 4) + 4 * (n_rows + 1) + val * n_cols + 4 * n_rows`` bytes over
3.35 TB/s.  The design streams VAL/ICOL once with a group of lanes per row
(CSR-vector; the group is as wide as the mean row is long, so short rows do
not idle most of a warp), reads each row's bounds from IRP at run time —
there is no static bound on a row's length, so a heavy-tail row is just a
longer loop for its group — and reduces with warp shuffles.

:func:`csr_spmm` replaces ``repro/kernels/csr_spmv.py:csr_spmm``: the same
sum against an ``(n_cols, B)`` panel.  Bound on an H100: memory — A once,
``val * n_cols * B`` for X and ``4 * n_rows * B`` for Y, against
``2 * nnz * B`` flops.  A row group sits along the right-hand-side columns
(coalesced X gathers and Y stores), reads its bounds from IRP and shares
VAL/ICOL by shuffle (``csrc/csr_spmm.cu``).

:func:`slabs_needed` is kept from the reference only so that plan JSON and
``PlannedMatrix.tunings`` carry the same ``slabs_per_block`` value in both
packages; this kernel does not read it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import build as _build
from ._common import (INT32_MAX, PLAIN_CHUNK_ELEMS, check_contiguous,
                      check_current_device, check_index, check_same_device,
                      check_values, csr_spmv_lanes, current_stream_ptr,
                      row_group_launch, rows_per_block)


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
             block_rows: Optional[int] = None) -> torch.Tensor:
    """``y = A @ x`` for CSR arrays; returns float32 ``(n_rows,)``.

    ``block_rows`` is the number of rows a CUDA block owns.  The lane group
    is sized from the stored length over the row count (host ints: nothing
    is read back from the device).  CPU tensors run :func:`csr_spmv_plain`;
    CUDA tensors launch the kernel or raise."""
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
    lanes = csr_spmv_lanes(data.shape[0], n_rows)
    y = torch.empty(n_rows, dtype=torch.float32, device=data.device)
    code = _build.launcher("csr_spmv")(
        data.data_ptr(), cols.data_ptr(), indptr.data_ptr(),
        x.data_ptr(), y.data_ptr(), n_rows, lanes,
        rows_per_block(lanes, block_rows),
        int(data.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
        current_stream_ptr())
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


def csr_spmm(data: torch.Tensor, cols: torch.Tensor, indptr: torch.Tensor,
             x: torch.Tensor, *, block_rows: Optional[int] = None,
             block_k: Optional[int] = None) -> torch.Tensor:
    """``Y = A @ X`` for CSR arrays and a contiguous ``(n_cols, B)`` panel;
    returns float32 ``(n_rows, B)``.  ``block_rows`` is the number of rows
    and ``block_k`` the number of right-hand-side columns a CUDA block owns.
    CPU tensors run :func:`csr_spmm_plain`; CUDA tensors launch the kernel
    or raise."""
    check_values("data", data, 1)
    check_values("x", x, 2)
    check_index("cols", cols, data)
    if indptr.dtype != torch.int32 or indptr.ndim != 1 or indptr.shape[0] < 1:
        raise TypeError(f"indptr must be a 1-D int32 tensor of n_rows + 1 "
                        f"entries; got {indptr.dtype} {tuple(indptr.shape)}")
    check_same_device(data, cols=cols, indptr=indptr, x=x)
    if data.device.type == "cpu":
        return csr_spmm_plain(data, cols, indptr, x)
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
    kt, lanes, per_lane, groups = row_group_launch(
        batch, block_rows, block_k)
    y = torch.empty((n_rows, batch), dtype=torch.float32, device=data.device)
    code = _build.launcher("csr_spmm")(
        data.data_ptr(), cols.data_ptr(), indptr.data_ptr(), x.data_ptr(),
        y.data_ptr(), n_rows, batch, kt, lanes, per_lane, groups,
        int(data.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
        current_stream_ptr())
    _build.check_launch("csr_spmm", code)
    csr_spmm.launches += 1
    return y


#: number of kernel launches made by :func:`csr_spmm` in this process
csr_spmm.launches = 0

__all__ = ["csr_spmv", "csr_spmv_plain", "csr_spmm", "csr_spmm_plain",
           "slabs_needed"]
