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


def csr_spmv_lanes(nnz: int, n_rows: int) -> int:
    """Lanes ``csr_spmv`` gives one row (``ccs_spmv`` one column, called
    with the column count): the smallest power of two covering the mean
    segment length, within [2, 32]."""
    mean = nnz / max(n_rows, 1)
    lanes = 2
    while lanes < 32 and lanes < mean:
        lanes *= 2
    return lanes


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
    """``(threads, block_nnz)`` of a COO launch: ``block_nnz`` entries per
    CUDA block (default ``DEFAULT_BLOCK_NNZ``) walked by
    ``min(block_nnz, DEFAULT_THREADS)`` threads, rounded to whole warps."""
    bn = int(block_nnz) if block_nnz else DEFAULT_BLOCK_NNZ
    return clamp_threads(min(bn, DEFAULT_THREADS)), bn


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
