"""Launch shapes of the CUDA kernels: host integers only.

Every launch shape (lanes per row, rows or entries per block, the
right-hand-side tile, shared-memory windows and rings) is chosen here and
handed to the C entry points, which only check it.  The kernel wrappers
(``kernels/_common.py`` re-exports this module), the tuner's candidate grid
(``core/kernel_tune.py``) and the plan lint (``analyze/planlint.py``) all
call these helpers, so a candidate is exactly the launch a wrapper makes and
a plan is linted against that launch.  The module imports nothing, so the
framework-free lint can use it with torch never imported."""

#: threads a CUDA block holds at most
MAX_THREADS = 1024
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
#: rows a ``csr_spmm`` block owns by default where it keeps a window of X
#: rows: 32 rows of a band share ~75 X rows on xenon2, so each X row the
#: window holds serves ~10 entries, and four such blocks fit on an SM (64
#: rows was 13 % slower, 16 or 128 slower still: PERF.md §6)
CSR_SPMM_ROWS = 32
#: narrowest right-hand-side tile at which ``csr_spmm`` runs its window
#: kernel on a matrix it knows nothing of: below it (X rows of at most 128
#: bytes) the block's set-up costs more than the window saves on a band
#: (xenon2 at B = 32: 7 % slower than a lane group a row, PERF.md §6)
CSR_SPMM_WINDOW_MIN_COLS = 64
#: least share of the entries the windows must serve for a bound matrix
#: without heavy rows to take the window kernel
CSR_SPMM_MIN_SERVED = 0.5
#: fewest rows a block owns among the tuner's ``csr_spmm`` window candidates
CSR_SPMM_MIN_TUNE_ROWS = 8
#: most entries a ``csr_spmm`` window block stages in shared memory (32 KB);
#: by default it stages 5/4 of its rows' mean share, and reads the rest of
#: its entries (a heavy row's) from global
CSR_SPMM_STAGE_MAX = 4096
#: dynamic shared memory a block may take on an H100 (232 448 bytes),
#: less room for the kernels' static shared memory
SMEM_BLOCK_MAX = 232448 - 1024
#: ``csr_spmm`` window blocks that should fit on one SM together: the
#: window is cut to its share of the SM's shared memory (torso1, whose mean
#: row is stretched by its heavy rows, ran at one block an SM and 1.6x
#: slower: PERF.md §6)
CSR_SPMM_BLOCKS_PER_SM = 3
#: narrowest right-hand-side tile at which ``bcsr_spmm`` runs its
#: tensor-core kernel (for b = 4, 8, 16); below it the first port's kernel
#: runs (at B = 32 it was 9-32 % faster on xenon2, viscoplastic2 and torso1,
#: at B = 8 and 1 1.5-2.7x: PERF.md §6)
BCSR_MMA_MIN_COLS = 64
#: block sizes the tensor-core kernel takes
BCSR_MMA_BLOCKS = (4, 8, 16)
#: block rows a tensor-core ``bcsr_spmm`` block owns by default, a warp
#: each (16 ran slower on xenon2 in float32 and on torso1: PERF.md §6); also
#: the most the tuner tries
BCSR_MMA_ROWS = 8
#: most warps a tensor-core ``bcsr_spmm`` block holds (a warp a block row)
BCSR_MMA_WARPS = 8
#: most slices (and mbarriers) such a block keeps in shared memory
BCSR_MMA_MAX_SLOTS = 32
#: slices each warp keeps in flight at least (ring mode)
BCSR_MMA_STAGES = 2
#: tensor-core ``bcsr_spmm`` blocks that should fit on one SM together
BCSR_MMA_BLOCKS_PER_SM = 3
#: grid.y limit of a CUDA launch
MAX_GRID_Y = 65535


def clamp_threads(threads: int) -> int:
    """A requested thread count as a whole number of warps in [32, 1024]."""
    return (min(max(int(threads), 32), MAX_THREADS) + 31) // 32 * 32


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


def bcsr_spmm_mma(batch: int, block: int, block_k=None) -> bool:
    """Whether a BCSR SpMM launch runs the tensor-core kernel: a block size
    it takes (``BCSR_MMA_BLOCKS``) and a column tile of at least
    ``BCSR_MMA_MIN_COLS``; otherwise the first port's lane groups."""
    return (int(block) in BCSR_MMA_BLOCKS
            and rhs_tile(batch, block_k)[0] >= BCSR_MMA_MIN_COLS)


def bcsr_spmm_launch(batch: int, block: int, block_rows=None, block_k=None,
                     x_size: int = 4, data_size: int = 4):
    """``(kt, threads, rows, slots, stride)`` of a tensor-core BCSR SpMM
    launch: ``kt`` columns a CUDA block (:func:`rhs_tile`), ``rows``
    consecutive block rows it owns (``block_rows``, default
    ``BCSR_MMA_ROWS``) on up to ``BCSR_MMA_WARPS`` warps, ``slots`` slices
    of ``block`` X rows of ``stride`` bytes (``kt`` rounded up to 16 values
    of ``x_size`` bytes, padded to a pitch of 8 words mod 32 for float32
    and 4 for bfloat16, so the fragment loads of 4 rows and bfloat16's
    ``ldmatrix`` of 8 hit every bank) beside their ``block * block`` values of
    ``data_size`` bytes: ``BCSR_MMA_STAGES`` a warp at least, else what
    fits ``BCSR_MMA_BLOCKS_PER_SM`` blocks on an SM, at most
    ``BCSR_MMA_MAX_SLOTS`` (fewer warps where two slices a warp would not
    fit)."""
    kt = rhs_tile(batch, block_k)[0]
    check_grid_y(batch, kt)
    b = int(block)
    rows = max(1, int(block_rows)) if block_rows else BCSR_MMA_ROWS
    kt16 = -(-kt // 16) * 16
    stride = -(-kt16 * int(x_size) // 128) * 128 + 8 * int(x_size)
    slice_bytes = b * stride + b * b * int(data_size)
    warps = min(rows, BCSR_MMA_WARPS)
    while warps > 1 and BCSR_MMA_STAGES * warps * slice_bytes > \
            SMEM_BLOCK_MAX:
        warps //= 2
    share = SMEM_BLOCK_MAX // BCSR_MMA_BLOCKS_PER_SM // slice_bytes
    slots = min(BCSR_MMA_MAX_SLOTS, SMEM_BLOCK_MAX // slice_bytes,
                max(BCSR_MMA_STAGES * warps, share))
    return kt, 32 * warps, rows, max(slots, warps), stride


def csr_spmm_window(batch: int, block_k=None, heavy=None,
                    served=None) -> bool:
    """Whether a CSR SpMM launch runs the window kernel.  For a bound
    matrix (``heavy``: it has a row longer than a window; ``served``: the
    share of its entries the windows serve, both from
    ``csr_spmv.csr_spmm_structure``): where it has heavy rows (which the
    window kernel sums with a whole block), or where its windows serve at
    least ``CSR_SPMM_MIN_SERVED`` of its entries at a tile of at least
    ``CSR_SPMM_WINDOW_MIN_COLS`` columns.  Knowing nothing of the matrix:
    from that tile on."""
    wide = rhs_tile(batch, block_k)[0] >= CSR_SPMM_WINDOW_MIN_COLS
    if heavy is None:
        return wide
    return bool(heavy) or (wide and served >= CSR_SPMM_MIN_SERVED)


def csr_spmm_launch(batch: int, n_rows: int, n_cols: int, nnz_pad: int,
                    block_rows=None, block_k=None, x_size: int = 4,
                    window=None):
    """``(kt, lanes, per_lane, threads, rows, window, stage)`` of a CSR SpMM
    launch.  The column tile is :func:`rhs_tile`'s.  The window kernel
    (``window``; ``None``: :func:`csr_spmm_window` knowing nothing of the
    matrix) keeps a window of ``window`` X rows (of ``x_size`` bytes a
    value) in shared memory: a CUDA block owns
    ``rows`` consecutive rows (``block_rows``, default ``CSR_SPMM_ROWS`` or
    a row a lane group, at most ``n_rows``), walked by up to
    ``DEFAULT_THREADS`` threads in lane groups; it stages ``stage`` of
    their entries in shared memory (5/4 of the rows' mean share, a multiple
    of 32, at most ``CSR_SPMM_STAGE_MAX``), and the window spans the columns
    those rows map to (``rows * n_cols / n_rows``) plus twice the mean
    row's length — a band reaches that far — at most ``n_cols`` and what
    fits in a ``CSR_SPMM_BLOCKS_PER_SM``-th of ``SMEM_BLOCK_MAX`` beside
    the rows' IRP, the stage and the partial sums of a heavy row (a row
    longer than the window, which all the block's lane groups sum
    together).  Otherwise a lane group runs a row with every X row from
    global (``window == stage == 0``): ``rows`` groups of ``lanes``
    threads, as :func:`rows_per_block` rounds them."""
    kt, lanes, per_lane = rhs_tile(batch, block_k)
    check_grid_y(batch, kt)
    if window is None:
        window = csr_spmm_window(batch, block_k)
    if not window:
        groups = rows_per_block(lanes, block_rows)
        return kt, lanes, per_lane, groups * lanes, groups, 0, 0
    n_rows, n_cols = max(int(n_rows), 1), max(int(n_cols), 1)
    rows = min(max(1, int(block_rows)) if block_rows
               else max(CSR_SPMM_ROWS, DEFAULT_THREADS // lanes), n_rows)
    threads = clamp_threads(min(DEFAULT_THREADS, rows * lanes))
    mean = -(-int(nnz_pad) // n_rows)
    stage = min(CSR_SPMM_STAGE_MAX, -(-5 * rows * mean // 4 // 32) * 32)
    span = -(-rows * n_cols // n_rows) + 2 * mean
    room = (SMEM_BLOCK_MAX // CSR_SPMM_BLOCKS_PER_SM - 4 * (rows + 4)
            - 8 * stage - 4 * (threads // lanes) * kt)
    return (kt, lanes, per_lane, threads, rows,
            max(1, min(span, room // (kt * int(x_size)), n_cols)), stage)


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
#: threads per block of the split kernel of ``decode_attention_int8``: 8
#: warps, each streaming its own tiles of the split's valid keys
DECODE_THREADS = 256
#: threads per block where a block keeps 4 query rows (their registers,
#: about 200 a thread, leave room for one block of 256 on an SM)
DECODE_THREADS_G4 = 128
#: blocks per SM the split count aims at (2 of 256 threads are resident):
#: 4 (9 splits of the served cache) beat 8 and 16 by 23-42 % at the served
#: case, where a block whose split holds no valid slot exits at once
#: (PERF.md §6)
DECODE_BLOCKS_PER_SM = 4
#: fewest keys one split reads (below this the partials' merge dominates)
DECODE_MIN_KEYS = 64
#: keys of a split each thread lists at most: the split kernel lists its
#: valid slots in shared memory
DECODE_KEYS_PER_THREAD = 8
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
    ``DECODE_MIN_KEYS`` and at most ``DECODE_KEYS_PER_THREAD`` keys a
    thread in a split; ``threads`` is ``DECODE_THREADS``, or
    ``DECODE_THREADS_G4`` where a block keeps 4 query rows."""
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
    threads = DECODE_THREADS if g_tile <= 2 else DECODE_THREADS_G4
    splits = max(1, -(-slots // (DECODE_KEYS_PER_THREAD * threads)),
                 min(want, slots // DECODE_MIN_KEYS))
    keys_per_split = -(-slots // splits)
    return lanes, threads, g_tile, keys_per_split, -(-slots //
                                                    keys_per_split)
