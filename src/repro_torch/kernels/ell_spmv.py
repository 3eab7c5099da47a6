"""ELL SpMV and SpMM — hand-written CUDA kernels (``csrc/ell_spmv.cu``,
``csrc/ell_spmm.cu``) and their plain PyTorch versions.

Replaces the TPU kernel ``repro/kernels/ell_spmv.py:ell_spmv``
(``_ell_spmv_kernel``): ``y[r] = sum_w data[r, w] * x[cols[r, w]]`` with
float32 accumulation; padded slots (val 0, col 0) add zero.

Bound on an H100: memory.  The least the card must move is the panel once,
``n_rows * width * (val + 4)`` bytes, plus ``val * n_cols`` for x and
``4 * n_rows`` for y, over the card's 3.35 TB/s.  The design keeps to that
by reading every panel element exactly once with coalesced loads — one thread
per row for column-major storage (consecutive rows adjacent in memory), a
group of lanes per row for row-major storage — keeping the sum in a register,
and leaving the x gather to L2.  The panel is addressed by strides, so both
ELL layouts and SELL buckets are served without a transpose copy and without
padding to any tile multiple: the ragged edge is masked.

:func:`ell_spmm` replaces ``repro/kernels/ell_spmv.py:ell_spmm``
(``_ell_spmm_kernel``): ``Y[r, :] = sum_w data[r, w] * X[cols[r, w], :]``
for an ``(n_cols, B)`` panel.  Bound on an H100: memory — the panel once,
``val * n_cols * B`` for X and ``4 * n_rows * B`` for Y, against
``2 * nnz * B`` flops.  Threads sit along the right-hand-side columns (four
consecutive ones a thread, one vector load, where B and the pointers allow),
so the X gather and the Y store coalesce; a row group reads the band once
and shares it by shuffle.  A warp-wide group (B >= 17) gathers no X row for
a padded slot: a row whose band holds a ``(±0, column 0)`` slot adds
``0 * X[0, :]`` once, which gives the values of adding it at every such
slot, but that a zero result may change sign (``csrc/ell_spmm.cu``).  So, as in :func:`ell_spmm_plain`, exactly the
rows whose band holds such a slot turn NaN where ``X[0]`` is not finite.
(The reference pads the band to a multiple of 8 for the TPU's tile, so there
every row gains such slots.)
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build as _build
from ._common import (INT32_MAX, check_contiguous, check_current_device,
                      check_index, check_same_device, check_values,
                      current_stream_ptr, ell_spmv_lanes, row_group_launch,
                      rows_per_block)


def ell_spmv_plain(data: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``data``/``cols`` ``(n_rows, width)`` (any
    strides), ``x`` ``(n_cols,)``; float32 accumulate, float32 result."""
    return (data.float() * x.float()[cols]).sum(dim=1)


def ell_spmv(data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
             block_rows: Optional[int] = None) -> torch.Tensor:
    """``y = A @ x`` for an ELL panel viewed as ``(n_rows, width)``.

    ``data`` and ``cols`` may be any strided 2-D views with equal strides
    (pass ``m.data.t()`` for column-major storage); ``x`` is contiguous.
    Returns float32 ``(n_rows,)``.  ``block_rows`` is the number of rows a
    CUDA block owns.  CPU tensors run :func:`ell_spmv_plain`; CUDA tensors
    launch the kernel or raise."""
    check_values("data", data, 2)
    check_values("x", x, 1)
    check_index("cols", cols, data)
    check_same_device(data, cols=cols, x=x)
    if data.device.type == "cpu":
        return ell_spmv_plain(data, cols, x)
    if data.device.type != "cuda":
        raise ValueError(f"ell_spmv takes CPU or CUDA tensors; got "
                         f"{data.device}")
    if data.stride() != cols.stride():
        raise ValueError(f"data and cols must share strides; got "
                         f"{data.stride()} vs {cols.stride()}")
    check_current_device(data)
    check_contiguous(x=x)
    n_rows, width = data.shape
    if data.numel() > INT32_MAX or x.numel() > INT32_MAX:
        raise ValueError("ELL panel or x exceeds 2^31 - 1 elements")
    if n_rows == 0 or width == 0:
        # nothing stored: no launch, none counted
        return torch.zeros(n_rows, dtype=torch.float32, device=data.device)
    lanes = ell_spmv_lanes(width, row_major=data.stride(1) == 1
                           and data.stride(0) != 1)
    y = torch.empty(n_rows, dtype=torch.float32, device=data.device)
    code = _build.launcher("ell_spmv")(
        data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
        n_rows, width, data.stride(0), data.stride(1), lanes,
        rows_per_block(lanes, block_rows),
        int(data.dtype == torch.bfloat16), int(x.dtype == torch.bfloat16),
        current_stream_ptr())
    _build.check_launch("ell_spmv", code)
    ell_spmv.launches += 1
    return y


#: number of kernel launches made by :func:`ell_spmv` in this process
ell_spmv.launches = 0


def ell_spmm_plain(data: torch.Tensor, cols: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``data``/``cols`` ``(n_rows, width)`` (any
    strides), ``x`` ``(n_cols, B)``; float32 accumulate, float32 result.
    Loops over the band, so no temporary is larger than ``(n_rows, B)``."""
    n_rows, width = data.shape
    xf = x.float()
    y = torch.zeros((n_rows, x.shape[1]), dtype=torch.float32,
                    device=data.device)
    for w in range(width):
        y.addcmul_(data[:, w, None].float(), xf[cols[:, w]])
    return y


def ell_spmm(data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
             block_rows: Optional[int] = None,
             block_k: Optional[int] = None) -> torch.Tensor:
    """``Y = A @ X`` for an ELL panel viewed as ``(n_rows, width)`` and a
    contiguous ``(n_cols, B)`` panel ``x``; returns float32 ``(n_rows, B)``.

    ``data`` and ``cols`` may be any strided 2-D views with equal strides.
    ``block_k`` is the number of right-hand-side columns a CUDA block owns,
    ``block_rows`` the number of rows.  CPU tensors run
    :func:`ell_spmm_plain`; CUDA tensors launch the kernel or raise."""
    check_values("data", data, 2)
    check_values("x", x, 2)
    check_index("cols", cols, data)
    check_same_device(data, cols=cols, x=x)
    if data.device.type == "cpu":
        return ell_spmm_plain(data, cols, x)
    if data.device.type != "cuda":
        raise ValueError(f"ell_spmm takes CPU or CUDA tensors; got "
                         f"{data.device}")
    if data.stride() != cols.stride():
        raise ValueError(f"data and cols must share strides; got "
                         f"{data.stride()} vs {cols.stride()}")
    check_current_device(data)
    check_contiguous(x=x)
    n_rows, width = data.shape
    batch = x.shape[1]
    if data.numel() > INT32_MAX:
        raise ValueError("ELL panel exceeds 2^31 - 1 elements")
    if n_rows == 0 or width == 0 or batch == 0:
        # nothing stored: no launch, none counted
        return torch.zeros((n_rows, batch), dtype=torch.float32,
                           device=data.device)
    kt, lanes, per_lane, groups = row_group_launch(
        batch, block_rows, block_k)
    y = torch.empty((n_rows, batch), dtype=torch.float32, device=data.device)
    code = _build.launcher("ell_spmm")(
        data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
        n_rows, width, data.stride(0), data.stride(1), batch, kt, lanes,
        per_lane, groups, int(data.dtype == torch.bfloat16),
        int(x.dtype == torch.bfloat16), current_stream_ptr())
    _build.check_launch("ell_spmm", code)
    ell_spmm.launches += 1
    return y


#: number of kernel launches made by :func:`ell_spmm` in this process
ell_spmm.launches = 0

__all__ = ["ell_spmv", "ell_spmv_plain", "ell_spmm", "ell_spmm_plain"]
