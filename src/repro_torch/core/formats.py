"""Sparse-matrix storage formats as plain dataclasses over ``torch.Tensor``s.

The paper (Katagiri & Sato) studies run-time transformation between CRS
(a.k.a. CSR), COO (row- and column-ordered) and ELL.  Each format is a
frozen dataclass whose array fields are tensors on one device (``.to(device)``
moves them) and whose *structural* metadata (shape, true nnz, storage order)
are plain Python values.  Index tensors are ``int32``; values are ``float32``
or ``bfloat16``.

Padding conventions (kept from the JAX package so containers compare field
by field):
  * CSR/COO: nnz padded up to ``pad_to`` with (row=0, col=0, val=0) entries
    that lie past ``indptr[-1]`` — harmless for SpMV since the value is zero.
  * ELL: ``data``/``cols`` are dense ``(n_rows, width)`` (row order) or
    ``(width, n_rows)`` (column order, the paper's "ELL-Col" storage);
    missing band entries hold (col=0, val=0) exactly as the paper describes
    ("the value of zero is inserted in the position of missing band parts").

torch raises on an out-of-range gather on the CPU and is undefined on CUDA
(where JAX clamps), so nothing here relies on clamping: pads are real
in-range entries, and every transform masks explicitly.

Beyond the paper's three: ``CCS`` (its Phase-I target, CSR's column-space
mirror) and ``BCSR`` (its named future work, ``b x b`` dense blocks in CSR
order over block rows).
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, from_host, resolve_device, to_host

Tensor = torch.Tensor


class MatrixValidationError(ValueError):
    """A sparse container's structural invariants do not hold (malformed
    indptr, out-of-range indices, wrong dtypes).  Raised at the trust
    boundary — ``plan.bind`` — so corrupt input fails loudly there instead
    of as NaN/garbage (or an out-of-bounds read) deep inside a kernel."""


def _np(x) -> np.ndarray:
    """Host numpy view of a tensor (bf16 as its int16 bit pattern)."""
    return to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _vals(x) -> np.ndarray:
    """Host numpy *values* of a tensor (bf16 widened to float32)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x)


class _TensorContainer:
    """``.to(device)`` / ``.device`` for a dataclass whose tensor fields (and
    nested containers) all live on one device."""

    def to(self, device: DeviceLike):
        dev = torch.device(device)
        moved = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                moved[f.name] = v.to(dev)
            elif isinstance(v, tuple) and v and \
                    isinstance(v[0], _TensorContainer):
                moved[f.name] = tuple(b.to(dev) for b in v)
        return replace(self, **moved)

    @property
    def device(self) -> torch.device:
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                return v.device
        raise AttributeError("container holds no tensor")


# ---------------------------------------------------------------------------
# CSR — the paper's CRS: VAL(1:nnz), ICOL(1:nnz), IRP(1:n+1)
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class CSR(_TensorContainer):
    data: Tensor     # (nnz_pad,)  = VAL
    cols: Tensor     # (nnz_pad,)  = ICOL
    indptr: Tensor   # (n_rows+1,) = IRP
    shape: Tuple[int, int]
    nnz: int         # true nnz (<= nnz_pad)

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz_pad(self) -> int:
        return int(self.data.shape[0])

    def row_lengths(self) -> np.ndarray:
        ip = _np(self.indptr)
        return ip[1:] - ip[:-1]

    def todense(self) -> np.ndarray:
        data = _vals(self.data)
        out = np.zeros(self.shape, dtype=data.dtype)
        rows = np.repeat(np.arange(self.n_rows), self.row_lengths())
        # duplicate (i, j) entries accumulate, matching SpMV semantics
        np.add.at(out, (rows, _np(self.cols)[: self.nnz]), data[: self.nnz])
        return out

    def validate(self) -> "CSR":
        """Check the CSR structural invariants; raises
        :class:`MatrixValidationError` on the first violation, returns
        ``self`` for chaining.  One O(n + nnz) numpy pass on the host —
        cheap at the bind boundary relative to the transform it gates."""
        ip = _np(self.indptr)
        cols = _np(self.cols)
        data = _np(self.data)
        if ip.ndim != 1 or ip.shape[0] != self.n_rows + 1:
            raise MatrixValidationError(
                f"indptr must have shape ({self.n_rows + 1},); "
                f"got {ip.shape}")
        if not np.issubdtype(ip.dtype, np.integer):
            raise MatrixValidationError(
                f"indptr must be an integer array; got dtype {ip.dtype}")
        if not np.issubdtype(cols.dtype, np.integer):
            raise MatrixValidationError(
                f"cols must be an integer array; got dtype {cols.dtype}")
        if int(ip[0]) != 0:
            raise MatrixValidationError(
                f"indptr[0] must be 0; got {int(ip[0])}")
        if np.any(ip[1:] < ip[:-1]):
            i = int(np.argmax(ip[1:] < ip[:-1]))
            raise MatrixValidationError(
                f"indptr must be monotone non-decreasing; "
                f"indptr[{i + 1}]={int(ip[i + 1])} < "
                f"indptr[{i}]={int(ip[i])}")
        if int(ip[-1]) != self.nnz:
            raise MatrixValidationError(
                f"indptr[-1] must equal nnz={self.nnz}; "
                f"got {int(ip[-1])}")
        if self.nnz > self.nnz_pad:
            raise MatrixValidationError(
                f"nnz={self.nnz} exceeds storage nnz_pad={self.nnz_pad}")
        if cols.shape != data.shape:
            raise MatrixValidationError(
                f"cols and data must share a shape; "
                f"got {cols.shape} vs {data.shape}")
        if self.nnz > 0:
            live = cols[: self.nnz]
            lo, hi = int(live.min()), int(live.max())
            if lo < 0 or hi >= self.n_cols:
                raise MatrixValidationError(
                    f"column indices must lie in [0, {self.n_cols}); "
                    f"found range [{lo}, {hi}]")
        return self


# ---------------------------------------------------------------------------
# CCS — compressed column storage (paper's Phase-I target)
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class CCS(_TensorContainer):
    data: Tensor     # (nnz_pad,)  = VAL_T
    rows: Tensor     # (nnz_pad,)  row index of each stored value (IROW_T)
    indptr: Tensor   # (n_cols+1,) = IRP_T
    shape: Tuple[int, int]
    nnz: int

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz_pad(self) -> int:
        return int(self.data.shape[0])

    def todense(self) -> np.ndarray:
        data = _vals(self.data)
        out = np.zeros(self.shape, dtype=data.dtype)
        ip = _np(self.indptr)
        cols = np.repeat(np.arange(self.n_cols), ip[1:] - ip[:-1])
        np.add.at(out, (_np(self.rows)[: self.nnz], cols), data[: self.nnz])
        return out

    def validate(self) -> "CCS":
        """CSR's invariants mirrored over columns: ``indptr`` segments the
        column axis and ``rows`` must stay inside the row space."""
        ip = _np(self.indptr)
        rows = _np(self.rows)
        data = _np(self.data)
        if ip.ndim != 1 or ip.shape[0] != self.n_cols + 1:
            raise MatrixValidationError(
                f"indptr must have shape ({self.n_cols + 1},); "
                f"got {ip.shape}")
        if not np.issubdtype(ip.dtype, np.integer):
            raise MatrixValidationError(
                f"indptr must be an integer array; got dtype {ip.dtype}")
        if not np.issubdtype(rows.dtype, np.integer):
            raise MatrixValidationError(
                f"rows must be an integer array; got dtype {rows.dtype}")
        if int(ip[0]) != 0:
            raise MatrixValidationError(
                f"indptr[0] must be 0; got {int(ip[0])}")
        if np.any(ip[1:] < ip[:-1]):
            j = int(np.argmax(ip[1:] < ip[:-1]))
            raise MatrixValidationError(
                f"indptr must be monotone non-decreasing; "
                f"indptr[{j + 1}]={int(ip[j + 1])} < "
                f"indptr[{j}]={int(ip[j])}")
        if int(ip[-1]) != self.nnz:
            raise MatrixValidationError(
                f"indptr[-1] must equal nnz={self.nnz}; got {int(ip[-1])}")
        if self.nnz > self.nnz_pad:
            raise MatrixValidationError(
                f"nnz={self.nnz} exceeds storage nnz_pad={self.nnz_pad}")
        if rows.shape != data.shape:
            raise MatrixValidationError(
                f"rows and data must share a shape; "
                f"got {rows.shape} vs {data.shape}")
        if self.nnz > 0:
            live = rows[: self.nnz]
            lo, hi = int(live.min()), int(live.max())
            if lo < 0 or hi >= self.n_rows:
                raise MatrixValidationError(
                    f"row indices must lie in [0, {self.n_rows}); "
                    f"found range [{lo}, {hi}]")
        return self


# ---------------------------------------------------------------------------
# COO — VAL, ICOL, IROW; `order` records sortedness ("row" | "col" | None)
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class COO(_TensorContainer):
    data: Tensor     # (nnz_pad,)
    rows: Tensor     # (nnz_pad,)
    cols: Tensor     # (nnz_pad,)
    shape: Tuple[int, int]
    nnz: int
    order: Union[str, None] = "row"

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz_pad(self) -> int:
        return int(self.data.shape[0])

    def todense(self) -> np.ndarray:
        data = _vals(self.data)
        out = np.zeros(self.shape, dtype=data.dtype)
        np.add.at(out, (_np(self.rows), _np(self.cols)), data)
        return out

    def validate(self) -> "COO":
        """Bounds, dtypes, and the sortedness the ``order`` tag promises."""
        data = _np(self.data)
        rows = _np(self.rows)
        cols = _np(self.cols)
        if self.order not in ("row", "col", None):
            raise MatrixValidationError(
                f"order must be 'row', 'col', or None; got {self.order!r}")
        if not (data.ndim == rows.ndim == cols.ndim == 1):
            raise MatrixValidationError(
                "data/rows/cols must be 1-D arrays")
        if not (data.shape == rows.shape == cols.shape):
            raise MatrixValidationError(
                f"data/rows/cols must share a shape; got {data.shape}, "
                f"{rows.shape}, {cols.shape}")
        for name, arr in (("rows", rows), ("cols", cols)):
            if not np.issubdtype(arr.dtype, np.integer):
                raise MatrixValidationError(
                    f"{name} must be an integer array; got dtype "
                    f"{arr.dtype}")
        if self.nnz > self.nnz_pad:
            raise MatrixValidationError(
                f"nnz={self.nnz} exceeds storage nnz_pad={self.nnz_pad}")
        if self.nnz > 0:
            for name, arr, bound in (("rows", rows, self.n_rows),
                                     ("cols", cols, self.n_cols)):
                live = arr[: self.nnz]
                lo, hi = int(live.min()), int(live.max())
                if lo < 0 or hi >= bound:
                    raise MatrixValidationError(
                        f"{name} indices must lie in [0, {bound}); "
                        f"found range [{lo}, {hi}]")
            key = rows if self.order == "row" else \
                cols if self.order == "col" else None
            if key is not None:
                live = key[: self.nnz]
                if np.any(live[1:] < live[:-1]):
                    i = int(np.argmax(live[1:] < live[:-1]))
                    raise MatrixValidationError(
                        f"order={self.order!r} promises sorted "
                        f"{self.order} indices; violated at entry "
                        f"{i + 1} ({int(live[i + 1])} < {int(live[i])})")
        return self


# ---------------------------------------------------------------------------
# ELL — VAL(1:n, 1:nz): dense padded band storage.
#   order == "row": data[r, k] is the k-th stored entry of row r
#                   (paper's ELL-Row: row-major, width minor).
#   order == "col": data[k, r] — the paper's ELL-Col layout: consecutive
#                   rows are adjacent in memory.
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class ELL(_TensorContainer):
    data: Tensor     # (n_rows, width) or (width, n_rows)
    cols: Tensor     # same shape as data; padded entries point at column 0
    shape: Tuple[int, int]
    nnz: int
    order: str = "row"

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def width(self) -> int:
        return int(self.data.shape[1] if self.order == "row"
                   else self.data.shape[0])

    def todense(self) -> np.ndarray:
        data = _vals(self.data)
        cols = _np(self.cols)
        if self.order == "col":
            data, cols = data.T, cols.T
        out = np.zeros(self.shape, dtype=data.dtype)
        rows = np.broadcast_to(np.arange(self.n_rows)[:, None], data.shape)
        np.add.at(out, (rows.ravel(), cols.ravel()), data.ravel())
        return out

    def validate(self) -> "ELL":
        """Band-storage invariants.  Note the band ``width`` may exceed
        ``n_cols``: the transform quantum-pads it (multiples of 8), so
        only the *index* range is bounded, not the width."""
        data = _np(self.data)
        cols = _np(self.cols)
        if self.order not in ("row", "col"):
            raise MatrixValidationError(
                f"order must be 'row' or 'col'; got {self.order!r}")
        if data.ndim != 2 or data.shape != cols.shape:
            raise MatrixValidationError(
                f"data and cols must be 2-D with one shape; got "
                f"{data.shape} vs {cols.shape}")
        if not np.issubdtype(cols.dtype, np.integer):
            raise MatrixValidationError(
                f"cols must be an integer array; got dtype {cols.dtype}")
        row_axis = data.shape[0] if self.order == "row" else data.shape[1]
        if row_axis != self.n_rows:
            raise MatrixValidationError(
                f"{self.order}-order storage must span n_rows="
                f"{self.n_rows} on its row axis; got {row_axis}")
        if self.nnz > self.n_rows * max(self.width, 0):
            raise MatrixValidationError(
                f"nnz={self.nnz} cannot fit n_rows={self.n_rows} x "
                f"width={self.width} band storage")
        if cols.size and self.n_cols > 0:
            # padded entries point at column 0, so every slot is bounded
            lo, hi = int(cols.min()), int(cols.max())
            if lo < 0 or hi >= self.n_cols:
                raise MatrixValidationError(
                    f"column indices must lie in [0, {self.n_cols}); "
                    f"found range [{lo}, {hi}]")
        return self


# ---------------------------------------------------------------------------
# BucketedELL — beyond-paper SELL-C-sigma adaptation.
# Rows are sorted by length (sigma-sort over the whole matrix), grouped into
# width buckets; each bucket is a dense ELL block over a contiguous slice of
# the *permuted* row space.  `perm[i]` = original row of permuted row i.
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class BucketedELL(_TensorContainer):
    perm: Tensor                  # (n_rows,) permuted -> original row index
    buckets: Tuple[ELL, ...]      # each over (bucket_rows, n_cols)
    row_offsets: Tuple[int, ...]  # start row (permuted) of each bucket
    shape: Tuple[int, int]
    nnz: int

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def widths(self) -> Tuple[int, ...]:
        return tuple(b.width for b in self.buckets)

    def padded_nnz(self) -> int:
        return sum(int(b.data.numel()) for b in self.buckets)

    def todense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=_vals(self.buckets[0].data).dtype)
        perm = _np(self.perm)
        for off, b in zip(self.row_offsets, self.buckets):
            dense_b = b.todense()  # (bucket_rows, n_cols)
            rows = perm[off:off + dense_b.shape[0]]
            out[rows] += dense_b
        return out

    def validate(self) -> "BucketedELL":
        """SELL invariants: ``perm`` is a permutation, buckets tile the
        permuted row space contiguously, widths are distinct and strictly
        decreasing (widest bucket first — the sort order the transform
        emits), and the bucket nnz sums to the whole."""
        perm = _np(self.perm)
        if perm.ndim != 1 or perm.shape[0] != self.n_rows:
            raise MatrixValidationError(
                f"perm must have shape ({self.n_rows},); got {perm.shape}")
        if not np.issubdtype(perm.dtype, np.integer):
            raise MatrixValidationError(
                f"perm must be an integer array; got dtype {perm.dtype}")
        if not np.array_equal(np.sort(perm),
                              np.arange(self.n_rows, dtype=perm.dtype)):
            raise MatrixValidationError(
                "perm is not a permutation of the row indices")
        if len(self.row_offsets) != len(self.buckets):
            raise MatrixValidationError(
                f"{len(self.buckets)} buckets but "
                f"{len(self.row_offsets)} row offsets")
        if not self.buckets:
            raise MatrixValidationError("SELL container has no buckets")
        if self.row_offsets[0] != 0:
            raise MatrixValidationError(
                f"row_offsets must start at 0; got {self.row_offsets[0]}")
        end = 0
        for i, (off, b) in enumerate(zip(self.row_offsets, self.buckets)):
            if off != end:
                raise MatrixValidationError(
                    f"bucket {i} starts at permuted row {off}, expected "
                    f"{end} (buckets must tile contiguously)")
            if b.shape[1] != self.n_cols:
                raise MatrixValidationError(
                    f"bucket {i} spans {b.shape[1]} columns, expected "
                    f"{self.n_cols}")
            end = off + b.n_rows
            b.validate()
        if end != self.n_rows:
            raise MatrixValidationError(
                f"buckets cover {end} permuted rows, expected "
                f"{self.n_rows}")
        widths = self.widths
        for a, b_ in zip(widths, widths[1:]):
            if b_ >= a:
                raise MatrixValidationError(
                    f"bucket widths must be distinct and strictly "
                    f"decreasing (widest first); got {widths}")
        if sum(b.nnz for b in self.buckets) != self.nnz:
            raise MatrixValidationError(
                f"bucket nnz sums to "
                f"{sum(b.nnz for b in self.buckets)}, expected {self.nnz}")
        return self


# ---------------------------------------------------------------------------
# BCSR — the paper's named future work ("evaluating the transformation to
# other formats, such as BCSR, which enables cache blocking"): b x b dense
# blocks in CSR order over ceil(n_rows / b) block rows.  Pad blocks (past
# indptr[-1]) are all-zero with block column 0.
# ---------------------------------------------------------------------------
@dataclass(frozen=True, eq=False)
class BCSR(_TensorContainer):
    data: Tensor        # (nblocks_pad, b, b)
    block_cols: Tensor  # (nblocks_pad,) block-column indices
    indptr: Tensor      # (n_block_rows + 1,)
    shape: Tuple[int, int]
    nnz: int            # true scalar nnz represented
    block: int          # b

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def n_block_rows(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def nblocks_pad(self) -> int:
        return int(self.data.shape[0])

    def todense(self) -> np.ndarray:
        b = self.block
        nbr = self.n_block_rows
        dat = _vals(self.data)
        out = np.zeros((nbr * b, self.n_cols + (-self.n_cols) % b),
                       dtype=dat.dtype)
        ip = _np(self.indptr)
        nblocks = int(ip[-1]) if ip.size else 0
        brow = np.repeat(np.arange(nbr), ip[1:] - ip[:-1])
        bc = _np(self.block_cols)[:nblocks]
        # entry (p, i, j) lands at (brow[p] * b + i, bc[p] * b + j)
        r =brow[:, None, None] * b + np.arange(b)[None, :, None]
        c = bc[:, None, None] * b + np.arange(b)[None, None, :]
        np.add.at(out, (np.broadcast_to(r, (nblocks, b, b)),
                        np.broadcast_to(c, (nblocks, b, b))), dat[:nblocks])
        return out[: self.n_rows, : self.n_cols]

    def validate(self) -> "BCSR":
        """CSR invariants lifted to the block grid: ``indptr`` segments
        ``ceil(n_rows / b)`` block rows, stored tiles are dense ``b x b``,
        and block columns stay inside ``ceil(n_cols / b)``."""
        b = self.block
        if not isinstance(b, int) or b < 1:
            raise MatrixValidationError(
                f"block size must be a positive int; got {b!r}")
        ip = _np(self.indptr)
        bc = _np(self.block_cols)
        data = _np(self.data)
        nbr = -(-self.n_rows // b) if self.n_rows else 0
        if data.ndim != 3 or data.shape[1:] != (b, b):
            raise MatrixValidationError(
                f"data must be (nblocks_pad, {b}, {b}) dense tiles; "
                f"got {data.shape}")
        if ip.ndim != 1 or ip.shape[0] != nbr + 1:
            raise MatrixValidationError(
                f"indptr must have shape ({nbr + 1},) for n_rows="
                f"{self.n_rows}, block={b}; got {ip.shape}")
        for name, arr in (("indptr", ip), ("block_cols", bc)):
            if not np.issubdtype(arr.dtype, np.integer):
                raise MatrixValidationError(
                    f"{name} must be an integer array; got dtype "
                    f"{arr.dtype}")
        if int(ip[0]) != 0:
            raise MatrixValidationError(
                f"indptr[0] must be 0; got {int(ip[0])}")
        if np.any(ip[1:] < ip[:-1]):
            i = int(np.argmax(ip[1:] < ip[:-1]))
            raise MatrixValidationError(
                f"indptr must be monotone non-decreasing; "
                f"indptr[{i + 1}]={int(ip[i + 1])} < "
                f"indptr[{i}]={int(ip[i])}")
        nblocks = int(ip[-1]) if ip.size else 0
        if nblocks > self.nblocks_pad:
            raise MatrixValidationError(
                f"indptr stores {nblocks} blocks but only "
                f"{self.nblocks_pad} are allocated")
        if bc.shape != (self.nblocks_pad,):
            raise MatrixValidationError(
                f"block_cols must have shape ({self.nblocks_pad},); "
                f"got {bc.shape}")
        if self.nnz > nblocks * b * b:
            raise MatrixValidationError(
                f"nnz={self.nnz} cannot fit {nblocks} dense {b}x{b} "
                f"blocks")
        if nblocks > 0:
            nbc = -(-self.n_cols // b)
            live = bc[:nblocks]
            lo, hi = int(live.min()), int(live.max())
            if lo < 0 or hi >= nbc:
                raise MatrixValidationError(
                    f"block-column indices must lie in [0, {nbc}); "
                    f"found range [{lo}, {hi}]")
        return self


def bcsr_fill_ratio(m: "BCSR") -> float:
    """nnz / stored scalars — the density of the chosen blocks (the BCSR
    analogue of ELL's padding ratio)."""
    stored = m.nblocks_pad * m.block * m.block
    return m.nnz / stored if stored else 0.0


# ---------------------------------------------------------------------------
# Statistics — the paper's D_mat = sigma / mu (eq. 4)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MatrixStats:
    """Row-length statistics; numpy float64 on the host (one pass over IRP)."""
    n: int
    nnz: int
    mu: float        # mean nnz per row
    sigma: float     # stddev nnz per row (population, as in the paper)
    d_mat: float     # sigma / mu
    max_row: int
    min_row: int

    @staticmethod
    def of(mat: "CSR") -> "MatrixStats":
        lens = mat.row_lengths().astype(np.float64)
        mu = float(lens.mean())
        sigma = float(lens.std())
        return MatrixStats(
            n=mat.n_rows, nnz=mat.nnz, mu=mu, sigma=sigma,
            d_mat=sigma / mu if mu > 0 else float("inf"),
            max_row=int(lens.max()), min_row=int(lens.min()),
        )


def _tensor_leaves(fmt):
    for f in fields(fmt):
        v = getattr(fmt, f.name)
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, tuple) and v and isinstance(v[0], _TensorContainer):
            for b in v:
                yield from _tensor_leaves(b)


def memory_bytes(fmt) -> int:
    """Storage footprint of a format instance (index + value arrays)."""
    return sum(int(t.numel()) * t.element_size() for t in _tensor_leaves(fmt))


def validate_container(obj):
    """Run a container's :meth:`validate` when it has one.  Returns ``obj``
    for chaining — the shared entry point ``plan.bind`` uses after each
    transform."""
    check = getattr(obj, "validate", None)
    if callable(check):
        check()
    return obj


# ---------------------------------------------------------------------------
# numpy interchange — the state carried across packages.  There are no
# weights: the matrices (and the tuning artifacts, which are JSON) are the
# state, and tests hand the same numpy arrays to both packages.
# ---------------------------------------------------------------------------
def _tensor_of(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes array from JAX
        return from_host(a.view(np.int16), torch.bfloat16, device)
    return from_host(a, None, device)


def from_numpy(fmt_name: str, arrays: Dict[str, Any], meta: Dict[str, Any],
               device: DeviceLike = None):
    """Build a container from numpy arrays + static metadata.

    ``fmt_name`` is a registry name (``csr``, ``ccs``, ``coo_row``,
    ``coo_col``, ``ell_row``, ``ell_col``, ``sell``, ``bcsr``); ``arrays``
    maps field name to array (for ``sell``: ``perm`` plus ``buckets``, a
    list of ``{data, cols}``); ``meta`` holds ``shape``, ``nnz`` and, where
    the class has them, ``order`` / ``block`` / ``row_offsets`` /
    per-bucket ``buckets`` metadata."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in meta["shape"])
    nnz = int(meta["nnz"])
    if fmt_name == "csr":
        return CSR(data=_tensor_of(arrays["data"], dev),
                   cols=_tensor_of(arrays["cols"], dev),
                   indptr=_tensor_of(arrays["indptr"], dev),
                   shape=shape, nnz=nnz)
    if fmt_name == "ccs":
        return CCS(data=_tensor_of(arrays["data"], dev),
                   rows=_tensor_of(arrays["rows"], dev),
                   indptr=_tensor_of(arrays["indptr"], dev),
                   shape=shape, nnz=nnz)
    if fmt_name == "bcsr":
        return BCSR(data=_tensor_of(arrays["data"], dev),
                    block_cols=_tensor_of(arrays["block_cols"], dev),
                    indptr=_tensor_of(arrays["indptr"], dev),
                    shape=shape, nnz=nnz, block=int(meta["block"]))
    if fmt_name.startswith("coo"):
        order = meta.get("order", fmt_name[4:] or "row")
        return COO(data=_tensor_of(arrays["data"], dev),
                   rows=_tensor_of(arrays["rows"], dev),
                   cols=_tensor_of(arrays["cols"], dev),
                   shape=shape, nnz=nnz, order=order)
    if fmt_name.startswith("ell"):
        order = meta.get("order", fmt_name[4:] or "row")
        return ELL(data=_tensor_of(arrays["data"], dev),
                   cols=_tensor_of(arrays["cols"], dev),
                   shape=shape, nnz=nnz, order=order)
    if fmt_name == "sell":
        buckets = tuple(
            from_numpy("ell_row", a, m, dev)
            for a, m in zip(arrays["buckets"], meta["buckets"]))
        return BucketedELL(perm=_tensor_of(arrays["perm"], dev),
                           buckets=buckets,
                           row_offsets=tuple(int(o)
                                             for o in meta["row_offsets"]),
                           shape=shape, nnz=nnz)
    raise KeyError(f"unknown format {fmt_name!r}")


def to_numpy(container) -> Tuple[str, Dict[str, Any], Dict[str, Any]]:
    """Inverse of :func:`from_numpy`: ``(fmt_name, arrays, meta)`` with host
    numpy arrays (bf16 values widened to float32)."""
    if isinstance(container, CSR):
        return ("csr",
                {"data": _vals(container.data), "cols": _np(container.cols),
                 "indptr": _np(container.indptr)},
                {"shape": container.shape, "nnz": container.nnz})
    if isinstance(container, CCS):
        return ("ccs",
                {"data": _vals(container.data), "rows": _np(container.rows),
                 "indptr": _np(container.indptr)},
                {"shape": container.shape, "nnz": container.nnz})
    if isinstance(container, BCSR):
        return ("bcsr",
                {"data": _vals(container.data),
                 "block_cols": _np(container.block_cols),
                 "indptr": _np(container.indptr)},
                {"shape": container.shape, "nnz": container.nnz,
                 "block": container.block})
    if isinstance(container, COO):
        return (f"coo_{container.order or 'row'}",
                {"data": _vals(container.data), "rows": _np(container.rows),
                 "cols": _np(container.cols)},
                {"shape": container.shape, "nnz": container.nnz,
                 "order": container.order})
    if isinstance(container, ELL):
        return (f"ell_{container.order}",
                {"data": _vals(container.data), "cols": _np(container.cols)},
                {"shape": container.shape, "nnz": container.nnz,
                 "order": container.order})
    if isinstance(container, BucketedELL):
        parts = [to_numpy(b) for b in container.buckets]
        return ("sell",
                {"perm": _np(container.perm),
                 "buckets": [a for _, a, _ in parts]},
                {"shape": container.shape, "nnz": container.nnz,
                 "row_offsets": container.row_offsets,
                 "buckets": [m for _, _, m in parts]})
    raise TypeError(f"unknown sparse container: {type(container)}")


# FORMAT_NAMES is derived from the dispatch registry so it can never go stale
# against the registered formats.
def __getattr__(name: str):
    if name == "FORMAT_NAMES":
        from . import dispatch
        return tuple(dispatch.registered_formats("spmv"))
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "CSR", "CCS", "COO", "ELL", "BucketedELL", "BCSR", "MatrixStats",
    "MatrixValidationError", "bcsr_fill_ratio", "memory_bytes",
    "validate_container", "from_numpy", "to_numpy", "FORMAT_NAMES",
]
