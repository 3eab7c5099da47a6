"""COO SpMV and SpMM — hand-written CUDA kernels (``csrc/coo_spmv.cu``,
``csrc/coo_spmm.cu``) and their plain PyTorch versions.

Replaces the TPU kernel ``repro/kernels/coo_spmv.py:coo_spmv``
(``_coo_spmv_kernel``): ``y[rows[k]] += data[k] * x[cols[k]]`` for entries in
any order, float32 accumulation; padded entries are ``(0, 0, 0.0)``.

Bound on an H100: memory.  The least the card must move is
``nnz * (val + 8)`` bytes for the three streams plus ``val * n_cols`` for x
and ``4 * n_rows`` for y, over 3.35 TB/s.  The design reads the three streams
once, coalesced (a thread per entry, a contiguous run per block), and meets
in global memory with float32 ``atomicAdd`` — blocks run in no order, so
there is no sequential accumulator to carry.  Atomics make the summation
order, and so the last bits, differ from run to run: COO results are compared
to a tolerance, never bit for bit.

:func:`coo_spmm` replaces ``repro/kernels/coo_spmv.py:coo_spmm``: the same
scatter of ``(nnz, B)`` contributions into an ``(n_rows, B)`` panel.  One
thread per (entry, column) adds with ``atomicAdd``; the B atomics of one
entry hit B consecutive addresses, so a warp's atomics coalesce
(``csrc/coo_spmm.cu``).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build as _build
from ._common import (INT32_MAX, PLAIN_CHUNK_ELEMS, check_contiguous,
                      check_current_device, check_grid_y, check_index,
                      check_same_device, check_values, coo_launch,
                      current_stream_ptr, rhs_tile)


def coo_spmv_plain(data: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, x: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """Plain PyTorch version: float32 scatter-add of ``data * x[cols]``."""
    y = torch.zeros(n_rows, dtype=torch.float32, device=data.device)
    return y.index_add_(0, rows, data.float() * x.float()[cols])


def coo_spmv(data: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor, n_rows: int, *,
             block_nnz: Optional[int] = None) -> torch.Tensor:
    """``y = A @ x`` for COO arrays in any order; returns float32
    ``(n_rows,)``.  ``block_nnz`` is the number of entries a CUDA block owns.
    CPU tensors run :func:`coo_spmv_plain`; CUDA tensors launch the kernel
    or raise."""
    check_values("data", data, 1)
    check_values("x", x, 1)
    check_index("rows", rows, data)
    check_index("cols", cols, data)
    check_same_device(data, rows=rows, cols=cols, x=x)
    if data.device.type == "cpu":
        return coo_spmv_plain(data, rows, cols, x, n_rows)
    if data.device.type != "cuda":
        raise ValueError(f"coo_spmv takes CPU or CUDA tensors; got "
                         f"{data.device}")
    check_current_device(data)
    check_contiguous(data=data, rows=rows, cols=cols, x=x)
    if data.numel() > INT32_MAX or x.numel() > INT32_MAX:
        raise ValueError("nnz_pad or n_cols exceeds 2^31 - 1: int32 indices "
                         "cannot address it")
    y = torch.zeros(n_rows, dtype=torch.float32, device=data.device)
    if data.shape[0] == 0 or n_rows == 0:
        return y                 # nothing stored: no launch, none counted
    threads, bn = coo_launch(block_nnz)
    code = _build.launcher("coo_spmv")(
        data.data_ptr(), rows.data_ptr(), cols.data_ptr(), x.data_ptr(),
        y.data_ptr(), data.shape[0], threads, bn,
        int(data.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
        current_stream_ptr())
    _build.check_launch("coo_spmv", code)
    coo_spmv.launches += 1
    return y


#: number of kernel launches made by :func:`coo_spmv` in this process
coo_spmv.launches = 0


def coo_spmm_plain(data: torch.Tensor, rows: torch.Tensor,
                   cols: torch.Tensor, x: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """Plain PyTorch version: float32 scatter-add of ``data[k] * x[cols[k],
    :]`` in chunks of entries (no temporary above ``PLAIN_CHUNK_ELEMS``)."""
    batch = x.shape[1]
    xf = x.float()
    y = torch.zeros((n_rows, batch), dtype=torch.float32, device=data.device)
    step = max(1, PLAIN_CHUNK_ELEMS // max(batch, 1))
    for k0 in range(0, data.shape[0], step):
        k1 = k0 + step
        y.index_add_(0, rows[k0:k1],
                     data[k0:k1].float()[:, None] * xf[cols[k0:k1]])
    return y


def coo_spmm_launch(batch: int, block_nnz: Optional[int] = None,
                    block_k: Optional[int] = None):
    """``(kt, lanes, per_lane, threads, block_nnz)`` of a COO SpMM launch:
    the right-hand-side tile of :func:`~._common.rhs_tile` and the entries
    per block and threads of :func:`~._common.coo_launch`."""
    kt, lanes, per_lane = rhs_tile(batch, block_k)
    check_grid_y(batch, kt)
    return (kt, lanes, per_lane) + coo_launch(block_nnz)


def coo_spmm(data: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
             x: torch.Tensor, n_rows: int, *,
             block_nnz: Optional[int] = None,
             block_k: Optional[int] = None) -> torch.Tensor:
    """``Y = A @ X`` for COO arrays in any order and a contiguous
    ``(n_cols, B)`` panel; returns float32 ``(n_rows, B)``.  ``block_nnz``
    is the number of entries and ``block_k`` the number of right-hand-side
    columns a CUDA block owns.  CPU tensors run :func:`coo_spmm_plain`; CUDA
    tensors launch the kernel or raise."""
    check_values("data", data, 1)
    check_values("x", x, 2)
    check_index("rows", rows, data)
    check_index("cols", cols, data)
    check_same_device(data, rows=rows, cols=cols, x=x)
    if data.device.type == "cpu":
        return coo_spmm_plain(data, rows, cols, x, n_rows)
    if data.device.type != "cuda":
        raise ValueError(f"coo_spmm takes CPU or CUDA tensors; got "
                         f"{data.device}")
    check_current_device(data)
    check_contiguous(data=data, rows=rows, cols=cols, x=x)
    batch = x.shape[1]
    y = torch.zeros((n_rows, batch), dtype=torch.float32, device=data.device)
    if data.shape[0] == 0 or n_rows == 0 or batch == 0:
        return y                 # nothing stored: no launch, none counted
    kt, lanes, per_lane, threads, bn = coo_spmm_launch(batch, block_nnz,
                                                       block_k)
    code = _build.launcher("coo_spmm")(
        data.data_ptr(), rows.data_ptr(), cols.data_ptr(), x.data_ptr(),
        y.data_ptr(), data.shape[0], batch, kt, lanes, per_lane, threads, bn,
        int(data.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
        current_stream_ptr())
    _build.check_launch("coo_spmm", code)
    coo_spmm.launches += 1
    return y


#: number of kernel launches made by :func:`coo_spmm` in this process
coo_spmm.launches = 0

__all__ = ["coo_spmv", "coo_spmv_plain", "coo_spmm", "coo_spmm_plain",
           "coo_spmm_launch"]
