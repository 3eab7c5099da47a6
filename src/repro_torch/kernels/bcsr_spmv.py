"""BCSR SpMV and SpMM — hand-written CUDA kernels (``csrc/bcsr_spmv.cu``,
``csrc/bcsr_spmm.cu``) and their plain PyTorch versions.

Replaces the TPU kernel ``repro/kernels/bcsr_spmv.py:bcsr_spmv``
(``_bcsr_spmv_kernel``): ``y[br*b:(br+1)*b] += data[p] @ x[bc[p]*b:
(bc[p]+1)*b]`` over the stored ``b x b`` blocks of each block row, float32
accumulation.  The reference pads x to a multiple of b and slices y to
``n_rows``; here neither happens: the kernels mask block columns past
``n_cols`` and write only rows ``< n_rows``.

Bound on an H100: memory.  The least the card must move is the bytes the
format stores, ``nblocks * (b*b * val + 4) + 4 * (nbr + 1)``, plus
``val * n_cols`` for x and ``4 * n_rows`` for y, over 3.35 TB/s — explicit
zeros included (:func:`~repro_torch.core.formats.bcsr_fill_ratio` is the
share of stored scalars that are entries).  The SpMV kernel gives each
scalar row a thread that walks its block row's blocks from the block IRP at
run time; block rows are disjoint, so there are no atomics and the result
is deterministic.

:func:`bcsr_spmm` replaces ``repro/kernels/bcsr_spmv.py:bcsr_spmm``: the
same product against an ``(n_cols, B)`` panel.  For b = 4, 8 and 16 at a
column tile of 64 or more (``_common.bcsr_spmm_mma``) it runs each block
product on the tensor cores (``mma.sync`` with 3xTF32 for a float32
operand; for bfloat16 x bfloat16 at b = 8 and 16, ``m16n8k16`` on two 8 x 8
blocks or one 16 x 16 a step), a warp streaming its block rows' X slices
and values through a ring in shared memory filled by bulk asynchronous
copies.  Any other b or tile runs the first port's kernel: a group of lanes
owns one (block row, column tile), loads each block's ``b x kt`` slice of X
coalesced along B and keeps ``b x per_lane`` accumulators in registers.  No
atomics either way.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build as _build
from ._common import (INT32_MAX, PLAIN_CHUNK_ELEMS, bcsr_spmm_launch,
                      bcsr_spmm_mma, bcsr_spmv_launch, check_contiguous,
                      check_current_device, check_same_device, check_values,
                      current_stream_ptr, row_group_launch)


def _check(data, block_cols, indptr, x, n_rows: int, ndim: int) -> int:
    """Check the operands; returns the block size b."""
    check_values("data", data, 3)
    check_values("x", x, ndim)
    b = int(data.shape[1])
    if data.shape[2] != b or b < 1:
        raise ValueError(f"data must be (nblocks_pad, b, b); got "
                         f"{tuple(data.shape)}")
    if block_cols.dtype != torch.int32 or \
            tuple(block_cols.shape) != (data.shape[0],):
        raise TypeError(f"block_cols must be int32 of shape "
                        f"({data.shape[0]},); got {block_cols.dtype} "
                        f"{tuple(block_cols.shape)}")
    if indptr.dtype != torch.int32 or indptr.ndim != 1 or \
            indptr.shape[0] != -(-int(n_rows) // b) + 1:
        raise TypeError(f"indptr must be a 1-D int32 tensor of "
                        f"ceil(n_rows / b) + 1 = {-(-int(n_rows) // b) + 1} "
                        f"entries; got {indptr.dtype} {tuple(indptr.shape)}")
    check_same_device(data, block_cols=block_cols, indptr=indptr, x=x)
    return b


def _block_rows_of(indptr: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return (torch.searchsorted(indptr, k, right=True) - 1).clamp_(
        0, max(indptr.shape[0] - 2, 0))


def _x_blocks(x: torch.Tensor, b: int) -> torch.Tensor:
    """``x`` in float32, zero-padded to whole blocks and viewed
    ``(n_col_blocks, b, ...)``."""
    n_cols = x.shape[0]
    ncb = -(-n_cols // b)
    xp = torch.zeros((ncb * b,) + tuple(x.shape[1:]), dtype=torch.float32,
                     device=x.device)
    xp[:n_cols] = x
    return xp.reshape((ncb, b) + tuple(x.shape[1:]))


def bcsr_spmv_plain(data: torch.Tensor, block_cols: torch.Tensor,
                    indptr: torch.Tensor, x: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """Plain PyTorch version: block row of each stored block by binary
    search over the block IRP, float32 block matvecs against x padded to
    whole blocks, scatter-added per block row, sliced to ``n_rows``."""
    b = data.shape[1]
    nbr = indptr.shape[0] - 1
    nblocks = int(indptr[-1]) if nbr > 0 else 0
    k = torch.arange(nblocks, dtype=indptr.dtype, device=indptr.device)
    tiles = torch.einsum("kij,kj->ki", data[:nblocks].float(),
                         _x_blocks(x, b)[block_cols[:nblocks]])
    y = torch.zeros((nbr, b), dtype=torch.float32, device=data.device)
    y.index_add_(0, _block_rows_of(indptr, k), tiles)
    return y.reshape(nbr * b)[:n_rows]


def bcsr_spmv(data: torch.Tensor, block_cols: torch.Tensor,
              indptr: torch.Tensor, x: torch.Tensor, n_rows: int, *,
              block_rows: Optional[int] = None) -> torch.Tensor:
    """``y = A @ x`` for BCSR arrays (``data (nblocks_pad, b, b)``, block
    IRP of ``ceil(n_rows / b) + 1`` entries); returns float32 ``(n_rows,)``.
    ``block_rows`` is the number of block rows a CUDA block owns.  CPU
    tensors run :func:`bcsr_spmv_plain`; CUDA tensors launch the kernel or
    raise."""
    b = _check(data, block_cols, indptr, x, n_rows, 1)
    if data.device.type == "cpu":
        return bcsr_spmv_plain(data, block_cols, indptr, x, n_rows)
    if data.device.type != "cuda":
        raise ValueError(f"bcsr_spmv takes CPU or CUDA tensors; got "
                         f"{data.device}")
    check_current_device(data)
    check_contiguous(data=data, block_cols=block_cols, indptr=indptr, x=x)
    if data.shape[0] > INT32_MAX or x.numel() > INT32_MAX:
        raise ValueError("nblocks_pad or n_cols exceeds 2^31 - 1: int32 "
                         "indices cannot address it")
    if n_rows == 0:
        # no row to write: no launch, none counted
        return torch.zeros(0, dtype=torch.float32, device=data.device)
    threads, _ = bcsr_spmv_launch(b, block_rows)
    y = torch.empty(n_rows, dtype=torch.float32, device=data.device)
    code = _build.launcher("bcsr_spmv")(
        data.data_ptr(), block_cols.data_ptr(), indptr.data_ptr(),
        x.data_ptr(), y.data_ptr(), n_rows, x.shape[0], b, threads,
        int(data.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
        current_stream_ptr())
    _build.check_launch("bcsr_spmv", code)
    bcsr_spmv.launches += 1
    return y


#: number of kernel launches made by :func:`bcsr_spmv` in this process
bcsr_spmv.launches = 0


def bcsr_spmm_plain(data: torch.Tensor, block_cols: torch.Tensor,
                    indptr: torch.Tensor, x: torch.Tensor,
                    n_rows: int) -> torch.Tensor:
    """Plain PyTorch version: ``pij,pjc->pic`` block products against the
    ``(b, B)`` slices of X (padded to whole blocks), scatter-added per block
    row, in chunks of blocks (no ``(blocks, b, B)`` temporary above
    ``PLAIN_CHUNK_ELEMS``), sliced to ``n_rows``."""
    b = data.shape[1]
    nbr = indptr.shape[0] - 1
    batch = x.shape[1]
    nblocks = int(indptr[-1]) if nbr > 0 else 0
    xb = _x_blocks(x, b)
    y = torch.zeros((nbr, b, batch), dtype=torch.float32, device=data.device)
    step = max(1, PLAIN_CHUNK_ELEMS // max(b * batch, 1))
    for k0 in range(0, nblocks, step):
        k = torch.arange(k0, min(k0 + step, nblocks), dtype=indptr.dtype,
                         device=indptr.device)
        tiles = torch.einsum("kij,kjc->kic", data[k].float(),
                             xb[block_cols[k]])
        y.index_add_(0, _block_rows_of(indptr, k), tiles)
    return y.reshape(nbr * b, batch)[:n_rows]


def bcsr_spmm(data: torch.Tensor, block_cols: torch.Tensor,
              indptr: torch.Tensor, x: torch.Tensor, n_rows: int, *,
              block_rows: Optional[int] = None,
              block_k: Optional[int] = None,
              mma: Optional[bool] = None) -> torch.Tensor:
    """``Y = A @ X`` for BCSR arrays and a contiguous ``(n_cols, B)``
    panel; returns float32 ``(n_rows, B)``.  ``block_rows`` is the number of
    block rows and ``block_k`` the number of right-hand-side columns a CUDA
    block owns.  ``mma`` picks the tensor-core kernel (``None``:
    ``_common.bcsr_spmm_mma`` decides from b and the tile; True needs b in
    ``BCSR_MMA_BLOCKS``).  CPU tensors run :func:`bcsr_spmm_plain`; CUDA
    tensors launch the kernel or raise."""
    b = _check(data, block_cols, indptr, x, n_rows, 2)
    if data.device.type == "cpu":
        return bcsr_spmm_plain(data, block_cols, indptr, x, n_rows)
    if data.device.type != "cuda":
        raise ValueError(f"bcsr_spmm takes CPU or CUDA tensors; got "
                         f"{data.device}")
    check_current_device(data)
    check_contiguous(data=data, block_cols=block_cols, indptr=indptr, x=x)
    if data.shape[0] > INT32_MAX:
        raise ValueError("nblocks_pad exceeds 2^31 - 1: int32 indices "
                         "cannot address it")
    nbr = indptr.shape[0] - 1
    batch = x.shape[1]
    if n_rows == 0 or batch == 0:
        # no output element to write: no launch, none counted
        return torch.zeros((n_rows, batch), dtype=torch.float32,
                           device=data.device)
    if mma is None:
        mma = bcsr_spmm_mma(batch, b, block_k)
    if mma:
        kt, threads, groups, slots, stride = bcsr_spmm_launch(
            batch, b, block_rows, block_k, x.element_size(),
            data.element_size())
        lanes = per_lane = 0
    else:
        kt, lanes, per_lane, groups = row_group_launch(batch, block_rows,
                                                       block_k)
        threads = slots = stride = 0
    y = torch.empty((n_rows, batch), dtype=torch.float32, device=data.device)
    code = _build.launcher("bcsr_spmm")(
        data.data_ptr(), block_cols.data_ptr(), indptr.data_ptr(),
        x.data_ptr(), y.data_ptr(), n_rows, x.shape[0], nbr, b, batch, kt,
        lanes, per_lane, groups, threads, slots, stride,
        int(data.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
        current_stream_ptr())
    _build.check_launch("bcsr_spmm", code)
    bcsr_spmm.launches += 1
    return y


#: number of kernel launches made by :func:`bcsr_spmm` in this process
bcsr_spmm.launches = 0

__all__ = ["bcsr_spmv", "bcsr_spmv_plain", "bcsr_spmm", "bcsr_spmm_plain"]
