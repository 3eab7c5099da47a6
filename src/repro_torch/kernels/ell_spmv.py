"""ELL SpMV and SpMM — hand-written CUDA kernels (``csrc/ell_spmv.cu``,
``csrc/ell_spmm.cu``) and their plain PyTorch versions.

Replaces the TPU kernel ``repro/kernels/ell_spmv.py:ell_spmv``
(``_ell_spmv_kernel``): ``y[r] = sum_w data[r, w] * x[cols[r, w]]`` with
float32 accumulation; padded slots (val 0, col 0) add zero.

Bound on an H100: memory.  A band padded to its longest row holds mostly
pads (xenon2: 43 slots for 24.6 entries a row), so the design reads each
row's *live extent* only — 1 + the last slot that is not a ``(±0, column
0)`` pad, :func:`ell_extent`, computed once per panel when the panel is bound
(``kernels/ops.py:prepare``) — and adds ``0 * x[0]`` once for a row whose
extent is short of the band: the plain version's values, but that a zero
result may change sign; exactly the rows whose band holds a pad turn NaN
where ``x[0]`` is not finite.  The least the card must move is then the live
slots, ``(val + 4)`` bytes each, the extents (4 bytes a row), ``val *
n_cols`` for x and ``4 * n_rows`` for y, over 3.35 TB/s.  Loads coalesce —
one thread per row for column-major storage (consecutive rows adjacent in
memory), a group of lanes per row for row-major storage — the sum stays in
a register and the x gather is left to L2.  The panel is addressed by
strides, so both ELL layouts and SELL buckets are served without a
transpose copy and without padding to any tile multiple.  Without an extent
(a raw call, ``ell_spmv_ad``) the whole band is read.

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
from ._common import (INT32_MAX, PLAIN_CHUNK_ELEMS, check_contiguous,
                      check_current_device, check_index, check_same_device,
                      check_values, current_stream_ptr, ell_spmv_lanes,
                      row_group_launch, rows_per_block)


def ell_extent(data: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Each row's live extent of an ELL panel viewed ``(n_rows, width)``
    (any strides): 1 + the last slot that is not a ``(±0, column 0)`` pad, 0
    for a row of pads only; int32 ``(n_rows,)`` on the panel's device.  Exact
    for any slot order: a stored zero at another column, or a non-zero (or
    NaN) value at column 0, is live.  A torch reduction, rows taken in
    chunks (no temporary above ``PLAIN_CHUNK_ELEMS`` slots)."""
    n_rows, width = data.shape
    out = torch.zeros(n_rows, dtype=torch.int32, device=data.device)
    if width == 0:
        return out
    slot = torch.arange(1, width + 1, dtype=torch.int32, device=data.device)
    step = max(1, PLAIN_CHUNK_ELEMS // width)
    for r0 in range(0, n_rows, step):
        d, c = data[r0:r0 + step], cols[r0:r0 + step]
        live = (d != 0) | (c != 0)
        out[r0:r0 + step] = torch.where(live, slot, 0).amax(dim=1)
    return out


#: the largest share of a panel's slots inside its rows' extents at which
#: reading up to the extents pays: the extent is one more load a row ahead
#: of the row's slots, and the card fetches whole 64-byte runs of a row, so
#: a band with few pads reads faster whole (PERF.md §6)
EXTENT_MAX_LIVE = 0.75


def extent_pays(extent: torch.Tensor, width: int) -> bool:
    """Whether :func:`ell_spmv` should read a panel up to ``extent``: at
    most ``EXTENT_MAX_LIVE`` of its ``n_rows * width`` slots lie inside the
    extents (one read back from the panel's device)."""
    slots = extent.shape[0] * width
    return slots > 0 and int(extent.sum()) <= EXTENT_MAX_LIVE * slots


def _check_extent(extent: torch.Tensor, data: torch.Tensor) -> None:
    if extent.dtype != torch.int32 or extent.shape != data.shape[:1]:
        raise ValueError(f"extent must be int32 of shape ({data.shape[0]},); "
                         f"got {extent.dtype} {tuple(extent.shape)}")


def ell_spmv_plain(data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor,
                   extent: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ``data``/``cols`` ``(n_rows, width)`` (any
    strides), ``x`` ``(n_cols,)``; float32 accumulate, float32 result.
    With an ``extent`` (:func:`ell_extent`) it repeats the kernel's
    arithmetic: the slots below a row's extent, plus ``0 * x[0]`` once where
    the extent is short of the band."""
    prod = data.float() * x.float()[cols]
    if extent is None:
        return prod.sum(dim=1)
    width = data.shape[1]
    slot = torch.arange(width, device=data.device)
    y = torch.where(slot < extent[:, None], prod, 0.0).sum(dim=1)
    if x.numel() == 0:
        return y
    return y + torch.where(extent < width, 0.0 * x[0].float(), 0.0)


def ell_spmv(data: torch.Tensor, cols: torch.Tensor, x: torch.Tensor, *,
             extent: Optional[torch.Tensor] = None,
             block_rows: Optional[int] = None) -> torch.Tensor:
    """``y = A @ x`` for an ELL panel viewed as ``(n_rows, width)``.

    ``data`` and ``cols`` may be any strided 2-D views with equal strides
    (pass ``m.data.t()`` for column-major storage); ``x`` is contiguous.
    ``extent`` (:func:`ell_extent` of the panel; ``None`` reads the whole
    band) bounds the slots each row reads.  Returns float32 ``(n_rows,)``.
    ``block_rows`` is the number of rows a CUDA block owns.  CPU tensors
    run :func:`ell_spmv_plain`; CUDA tensors launch the kernel or raise."""
    check_values("data", data, 2)
    check_values("x", x, 1)
    check_index("cols", cols, data)
    if extent is not None:
        _check_extent(extent, data)
        check_same_device(data, extent=extent)
    check_same_device(data, cols=cols, x=x)
    if data.device.type == "cpu":
        return ell_spmv_plain(data, cols, x, extent)
    if data.device.type != "cuda":
        raise ValueError(f"ell_spmv takes CPU or CUDA tensors; got "
                         f"{data.device}")
    if data.stride() != cols.stride():
        raise ValueError(f"data and cols must share strides; got "
                         f"{data.stride()} vs {cols.stride()}")
    check_current_device(data)
    check_contiguous(x=x)
    if extent is not None:
        check_contiguous(extent=extent)
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
        data.data_ptr(), cols.data_ptr(),
        None if extent is None else extent.data_ptr(), x.data_ptr(),
        y.data_ptr(), n_rows, width, data.stride(0), data.stride(1), lanes,
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

__all__ = ["ell_extent", "extent_pays", "ell_spmv", "ell_spmv_plain", "ell_spmm",
           "ell_spmm_plain"]
