"""Argument checks and launch shapes shared by the kernel wrappers.

Every launch shape (lanes per row, rows or entries per block, the
right-hand-side tile) is chosen here, on the host, and handed to the C entry
points, which only check it; the tuner's candidate grid
(``core/kernel_tune.py``) calls the same helpers, so a candidate is exactly
the launch a wrapper makes."""
from __future__ import annotations

import torch

from ..device import VALUE_DTYPES

INT32_MAX = 2 ** 31 - 1


def check_values(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.dtype not in VALUE_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16; got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D; got shape "
                         f"{tuple(t.shape)}")


def check_index(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32; got {t.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{name} must have shape {tuple(like.shape)}; got "
                         f"{tuple(t.shape)}")


def check_same_device(ref: torch.Tensor, **others: torch.Tensor) -> None:
    for name, t in others.items():
        if t.device != ref.device:
            raise ValueError(f"{name} lies on {t.device}, expected "
                             f"{ref.device}: all operands of a kernel share "
                             f"one device")


def check_contiguous(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous; got strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")


def check_current_device(t: torch.Tensor) -> None:
    """A kernel launches on the current CUDA device's current stream, so its
    operands must live there."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"operands lie on {t.device} but the current CUDA "
                         f"device is {torch.cuda.current_device()}; wrap the "
                         f"call in torch.cuda.device(...)")


def current_stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# launch shapes (host ints only: nothing is read back from the device)
# ---------------------------------------------------------------------------
#: widest right-hand-side tile one CUDA block owns (32 lanes x 4 columns)
MAX_BLOCK_K = 128
#: threads per block when no ``block_rows`` / ``block_nnz`` is given
DEFAULT_THREADS = 256
#: entries per CUDA block (COO) when no ``block_nnz`` is given
DEFAULT_BLOCK_NNZ = 1024
#: most entries per CUDA block at which a ``coo_spmv`` thread sums 4
#: consecutive entries (8 above it)
COO_CHUNK4_MAX_NNZ = 1024
#: most entries a ``coo_spmv`` block takes in one pass: its shared memory
#: stages 8 bytes per entry of a pass (32 KB)
COO_PASS_NNZ = 4096
#: entries a ``csr_spmv`` block (a slice) owns when no ``block_nnz`` is given:
#: 256 threads of 8 entries, one pass
CSR_DEFAULT_BLOCK_NNZ = 2048
#: columns a ``ccs_spmm`` block owns by default where it keeps a window of Y
#: rows: 32 adjacent columns of a band share ~56 rows, so their window takes
#: most of their entries
CCS_SPMM_COLS = 32
#: most window rows a ``ccs_spmm`` lane group keeps in registers
CCS_ROWS_PER_GROUP_MAX = 16
#: warps a ``ccs_spmv`` block holds
CCS_SPMV_WARPS = 8
#: adjacent columns a ``ccs_spmv`` warp owns by default: 32 columns of a
#: band hold ~14 entries on each row they touch, and runs of 16 or 64 were
#: slower on xenon2 (PERF.md §6)
CCS_SPMV_COLS_PER_WARP = 32
#: fewest and most rows of a ``ccs_spmv`` warp's window
CCS_SPMV_WINDOW_MIN = 128
CCS_SPMV_WINDOW_MAX = 256
#: grid.y limit of a CUDA launch
MAX_GRID_Y = 65535
#: elements of the largest ``(entries, B)`` temporary a plain SpMM version
#: builds (256 MiB of float32): it walks the entries in chunks of this size
PLAIN_CHUNK_ELEMS = 1 << 26


def clamp_threads(threads: int) -> int:
    """A requested thread count as a whole number of warps in [32, 1024]."""
    return (min(max(int(threads), 32), 1024) + 31) // 32 * 32


def rows_per_block(lanes: int, block_rows=None) -> int:
    """Row groups of ``lanes`` threads one CUDA block holds: ``block_rows``
    of them (default ``DEFAULT_THREADS`` threads in all), rounded so the
    block is a whole number of warps, at most 1024 threads."""
    threads = clamp_threads(int(block_rows) * lanes if block_rows
                            else DEFAULT_THREADS)
    return threads // lanes


def ell_spmv_lanes(width: int, row_major: bool) -> int:
    """Threads ``ell_spmv`` gives one row: for a row-major panel a group
    that strides along the band (32 lanes from a band of 128, else 8); for
    any other layout one thread per row (column-major storage then
    coalesces across consecutive rows)."""
    if not row_major:
        return 1
    return 32 if width >= 128 else 8


def bcsr_spmv_launch(block: int, block_rows=None):
    """``(threads, block_rows)`` of a BCSR SpMV launch, one thread per
    scalar row: ``block_rows`` block rows of ``block`` rows each per CUDA
    block (default ``DEFAULT_THREADS`` threads), rounded to whole warps
    within [32, 1024]; the second value is the block rows that many threads
    hold whole (at least 1), so a candidate carrying it makes the same
    launch."""
    threads = clamp_threads(int(block_rows) * block if block_rows
                            else DEFAULT_THREADS)
    return threads, max(1, threads // block)


def coo_launch(block_nnz=None):
    """``(threads, block_nnz, chunk)`` of a COO SpMV launch: ``block_nnz``
    entries per CUDA block (default ``DEFAULT_BLOCK_NNZ``), each thread
    summing ``chunk`` consecutive entries (4, or 8 above
    ``COO_CHUNK4_MAX_NNZ`` entries a block), and as many whole warps as
    cover the block's entries at that chunk, up to ``COO_PASS_NNZ`` entries
    a pass (a larger block walks its entries in several passes)."""
    bn = int(block_nnz) if block_nnz else DEFAULT_BLOCK_NNZ
    chunk = 4 if bn <= COO_CHUNK4_MAX_NNZ else 8
    return clamp_threads(-(-min(bn, COO_PASS_NNZ) // chunk)), bn, chunk


def csr_slices(nnz_pad: int, block_nnz=None):
    """``(threads, block_nnz, chunk, n_slices)`` of a CSR SpMV launch:
    ``block_nnz`` entries a slice (default ``CSR_DEFAULT_BLOCK_NNZ``), one
    CUDA block a slice, threads and entries per thread as :func:`coo_launch`
    gives them; ``n_slices`` cover the ``nnz_pad`` stored slots (at least
    one, which writes the rows of a matrix with no slot)."""
    threads, bn, chunk = coo_launch(block_nnz or CSR_DEFAULT_BLOCK_NNZ)
    return threads, bn, chunk, max(1, -(-int(nnz_pad) // bn))


def coo_spmm_groups(lanes: int, block_nnz=None):
    """``(threads, block_nnz, run)`` of a COO SpMM launch at ``lanes``
    threads per group: ``block_nnz`` entries per CUDA block (default
    ``DEFAULT_BLOCK_NNZ``) cut into one sub-run of ``run`` consecutive
    entries per group; up to ``DEFAULT_THREADS`` threads, and no more
    groups than give each at least ``lanes`` entries."""
    bn = int(block_nnz) if block_nnz else DEFAULT_BLOCK_NNZ
    groups = max(1, min(DEFAULT_THREADS // lanes, -(-bn // lanes)))
    threads = clamp_threads(groups * lanes)
    return threads, bn, -(-bn // (threads // lanes))


def rhs_tile(batch: int, block_k=None):
    """``(kt, lanes, per_lane)`` of an SpMM launch: ``kt`` right-hand-side
    columns per CUDA block (``block_k`` clamped to ``[1, min(B, 128)]``,
    default ``min(B, 128)``), ``lanes`` threads per row group (the smallest
    power of two covering ``min(kt, 32)``) and ``per_lane`` columns each
    thread keeps in registers (1, 2 or 4)."""
    top = max(1, min(int(batch), MAX_BLOCK_K))
    kt = top if block_k is None else max(1, min(int(block_k), top))
    lanes = 1
    while lanes < min(kt, 32):
        lanes *= 2
    per = -(-kt // lanes)
    return kt, lanes, (per if per <= 2 else 4)


def row_group_launch(batch: int, block_rows=None, block_k=None):
    """``(kt, lanes, per_lane, rows_per_block)`` of a row-grouped SpMM launch
    (ELL, CSR; CCS groups columns, BCSR block rows): ``block_rows`` groups
    per CUDA block, as many as fit in a block of at most 1024 threads.  Raises when ``B`` needs more column
    tiles than ``grid.y`` allows."""
    kt, lanes, per_lane = rhs_tile(batch, block_k)
    check_grid_y(batch, kt)
    return kt, lanes, per_lane, rows_per_block(lanes, block_rows)


def ccs_spmm_launch(batch: int, n_rows: int, n_cols: int, nnz_pad: int,
                    block_rows=None, block_k=None):
    """``(kt, lanes, per_lane, threads, cols, window, rows_per_group)`` of a
    CCS SpMM launch.  The column tile is :func:`rhs_tile`'s; ``cols``
    adjacent columns a CUDA block owns (``block_rows``, rounded as
    :func:`rows_per_block` rounds a row group, so a tuner candidate is the
    launch).  A tile of a whole warp (``lanes == 32``) keeps a window of
    ``window`` rows of Y on the chip: ``DEFAULT_THREADS`` threads, ``cols``
    at least ``CCS_SPMM_COLS`` by default, and the rows its columns map to
    (``cols * n_rows / n_cols``) plus the mean column's length — a band
    reaches that far on either side of them — spread over the lane groups,
    ``rows_per_group`` each (a power of two from 2 to
    ``CCS_ROWS_PER_GROUP_MAX``), at most ``n_rows``.  A narrower tile runs a
    lane group a column with no window (``window == 0``): ``cols`` groups of
    ``lanes`` threads, ``DEFAULT_THREADS`` by default."""
    kt, lanes, per_lane = rhs_tile(batch, block_k)
    check_grid_y(batch, kt)
    if lanes < 32:
        cols = rows_per_block(lanes, block_rows)
        return kt, lanes, per_lane, cols * lanes, cols, 0, 0
    cols = rows_per_block(lanes, block_rows or CCS_SPMM_COLS)
    groups = DEFAULT_THREADS // lanes
    n_rows, n_cols = max(int(n_rows), 1), max(int(n_cols), 1)
    span = -(-cols * n_rows // n_cols) + -(-int(nnz_pad) // n_cols)
    rpg = 2
    while rpg < CCS_ROWS_PER_GROUP_MAX and rpg * groups < span:
        rpg *= 2
    return (kt, lanes, per_lane, DEFAULT_THREADS, cols,
            max(1, min(rpg * groups, n_rows)), rpg)


def ccs_spmv_launch(n_rows: int, n_cols: int, nnz_pad: int,
                    block_rows=None):
    """``(threads, cols, cols_per_warp, window)`` of a CCS SpMV launch: a
    CUDA block owns ``cols`` adjacent columns (``block_rows``, default
    ``CCS_SPMV_WARPS * CCS_SPMV_COLS_PER_WARP``), cut into runs of
    ``cols_per_warp`` for its warps (up to ``CCS_SPMV_WARPS`` of them: a
    request is rounded up to whole runs, so a tuner candidate carrying
    ``cols`` is the launch).  Each warp keeps windows (one per column mod
    4, ``csrc/ccs_spmv.cu``) of ``window`` rows of y: the rows its columns
    map to (``cols_per_warp * n_rows / n_cols``)
    plus a mean column on either side — a band reaches that far — as a power
    of two from ``CCS_SPMV_WINDOW_MIN`` to ``CCS_SPMV_WINDOW_MAX``, at most
    ``n_rows``."""
    want = max(1, int(block_rows)) if block_rows else (
        CCS_SPMV_WARPS * CCS_SPMV_COLS_PER_WARP)
    warps = min(CCS_SPMV_WARPS, want)
    per_warp = -(-want // warps)
    n_rows, n_cols = max(int(n_rows), 1), max(int(n_cols), 1)
    span = -(-per_warp * n_rows // n_cols) + 2 * -(-int(nnz_pad) // n_cols)
    window = CCS_SPMV_WINDOW_MIN
    while window < CCS_SPMV_WINDOW_MAX and window < span:
        window *= 2
    return 32 * warps, warps * per_warp, per_warp, min(window, n_rows)


def ccs_window_base(owner: int, cols: int, window: int, n_rows: int,
                    n_cols: int) -> int:
    """First row of a window, as ``csrc/ccs_spmm.cu`` computes it for block
    ``owner`` and ``csrc/ccs_spmv.cu`` for warp ``owner`` (counted over the
    grid): centred on the rows the owner's ``cols`` columns map to, inside
    the matrix."""
    base = (2 * owner * cols + cols) * n_rows // (2 * n_cols) - window // 2
    return max(0, min(base, n_rows - window))


def check_grid_y(batch: int, kt: int) -> None:
    if -(-int(batch) // kt) > MAX_GRID_Y:
        raise ValueError(f"B = {batch} in tiles of {kt} columns needs more "
                         f"than {MAX_GRID_Y} blocks along grid.y; raise "
                         f"block_k")


# ---------------------------------------------------------------------------
# decode attention (K11)
# ---------------------------------------------------------------------------
#: threads per block of the split kernel of ``decode_attention_int8``
DECODE_THREADS = 128
#: resident blocks per SM the split count aims at: enough 16-byte loads in
#: flight per SM to cover device-memory latency
DECODE_BLOCKS_PER_SM = 8
#: fewest keys one split reads (below this the partials' merge dominates)
DECODE_MIN_KEYS = 64
#: widest head the 16-byte-per-thread key groups take (32 lanes)
DECODE_MAX_HEAD_DIM = 512
#: streaming multiprocessors of an H100 SXM
H100_SMS = 132


def decode_attention_launch(batch: int, kv_heads: int, group: int,
                            slots: int, head_dim: int, sms: int = H100_SMS):
    """``(lanes, threads, g_tile, keys_per_split, splits)`` of a
    ``decode_attention_int8`` launch: ``lanes`` threads read one key (16
    int8 codes each, the smallest power of two covering ``head_dim``);
    ``g_tile`` query rows per block (the smallest power of two covering the
    group, at most 4: ``ceil(group / g_tile)`` tiles per kv head); and the
    ``slots`` axis cut into ``splits`` of ``keys_per_split`` keys so that
    the grid, ``batch * kv_heads * tiles * splits`` blocks, holds about
    ``DECODE_BLOCKS_PER_SM`` blocks per SM, with at least
    ``DECODE_MIN_KEYS`` keys a split."""
    if head_dim % 16 or not 16 <= head_dim <= DECODE_MAX_HEAD_DIM:
        raise ValueError(f"decode_attention_int8 reads heads of a multiple "
                         f"of 16 up to {DECODE_MAX_HEAD_DIM}; got {head_dim}")
    lanes = 1
    while lanes * 16 < head_dim:
        lanes *= 2
    g_tile = 1
    while g_tile < min(group, 4):
        g_tile *= 2
    heads = batch * kv_heads * -(-group // g_tile)
    want = -(-DECODE_BLOCKS_PER_SM * sms // max(heads, 1))
    splits = max(1, min(want, slots // DECODE_MIN_KEYS))
    keys_per_split = -(-slots // splits)
    return lanes, DECODE_THREADS, g_tile, keys_per_split, -(-slots //
                                                           keys_per_split)
