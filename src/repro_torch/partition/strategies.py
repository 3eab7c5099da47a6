"""Row-block partitioning strategies for the hybrid-format subsystem.

The paper's auto-tuner makes one whole-matrix decision from D_mat = sigma/mu,
so a single skewed row stalls ELL for the entire matrix (max_row padding).
Splitting into row blocks and deciding per block (adaptive row-grouped CSR,
Heller & Oberhuber; shared-memory partitioned SpMV, Bergmans et al.) keeps
the per-block D_mat low where the matrix is regular and isolates the heavy
tail into blocks that fall back to CRS/COO on their own.

Every strategy maps a row-length vector to *boundaries*: a strictly
increasing int64 array ``[0, b_1, ..., n_rows]``.  Block i covers permuted
rows ``boundaries[i]:boundaries[i+1]``.  Strategies operate on the (possibly
length-sorted) row space; sorting is the caller's choice (``build_hybrid``).
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def _as_lens(row_lens) -> np.ndarray:
    lens = np.asarray(row_lens, dtype=np.int64)
    if lens.ndim != 1:
        raise ValueError(f"row_lens must be 1-D, got shape {lens.shape}")
    return lens


def _validate(boundaries: np.ndarray, n: int) -> np.ndarray:
    b = np.asarray(boundaries, dtype=np.int64)
    assert b[0] == 0 and b[-1] == n and np.all(np.diff(b) > 0), b
    return b


# ---------------------------------------------------------------------------
# fixed-size blocks
# ---------------------------------------------------------------------------
def partition_fixed(row_lens, block_rows: int = 1024) -> np.ndarray:
    """Uniform blocks of ``block_rows`` rows (last block may be short)."""
    n = _as_lens(row_lens).shape[0]
    block_rows = max(int(block_rows), 1)
    b = np.arange(0, n, block_rows, dtype=np.int64)
    return _validate(np.append(b, n), n)


# ---------------------------------------------------------------------------
# nnz-balanced blocks
# ---------------------------------------------------------------------------
def partition_balanced_nnz(row_lens, n_blocks: int = 8) -> np.ndarray:
    """~Equal nonzeros per block: cut the nnz prefix sum at k/n_blocks.

    This is the load-balancing split of partitioned SpMV — each block does
    the same work even when row lengths are wildly skewed."""
    lens = _as_lens(row_lens)
    n = lens.shape[0]
    n_blocks = int(np.clip(n_blocks, 1, n))
    csum = np.cumsum(lens)
    total = csum[-1] if csum.size else 0
    if total == 0:
        return partition_fixed(lens, max(n // n_blocks, 1))
    targets = total * np.arange(1, n_blocks, dtype=np.float64) / n_blocks
    cuts = np.searchsorted(csum, targets, side="left") + 1
    b = np.concatenate([[0], np.unique(np.clip(cuts, 1, n - 1)), [n]]) \
        if n > 1 else np.array([0, n])
    return _validate(np.unique(b), n)


# ---------------------------------------------------------------------------
# greedy variance splitting
# ---------------------------------------------------------------------------
def _best_split(lens: np.ndarray, s: int, e: int):
    """Best single cut of segment [s, e) by within-segment SSE reduction.

    Prefix sums give the SSE of every (left, right) pair in O(e - s):
      SSE(a, b) = sum(l^2) - sum(l)^2 / (b - a).
    Returns (cut, gain) with gain = SSE(s,e) - SSE(s,cut) - SSE(cut,e).
    """
    seg = lens[s:e].astype(np.float64)
    m = seg.shape[0]
    if m < 2:
        return None, 0.0
    c1 = np.cumsum(seg)
    c2 = np.cumsum(seg * seg)
    k = np.arange(1, m, dtype=np.float64)          # left sizes
    sse_l = c2[:-1] - c1[:-1] ** 2 / k
    sse_r = (c2[-1] - c2[:-1]) - (c1[-1] - c1[:-1]) ** 2 / (m - k)
    sse_all = c2[-1] - c1[-1] ** 2 / m
    gains = sse_all - (sse_l + sse_r)
    i = int(np.argmax(gains))
    return s + i + 1, float(gains[i])


def partition_variance(row_lens, max_blocks: int = 16, min_rows: int = 64,
                       min_gain: float = 1.0) -> np.ndarray:
    """Greedy recursive splitting that minimizes within-block row-length
    variance — the per-block analogue of driving D_mat toward zero.

    Repeatedly cut the segment whose best split yields the largest SSE
    reduction, until ``max_blocks`` segments exist, no split clears
    ``min_gain``, or segments would drop under ``min_rows`` rows.  On a
    length-sorted row space this isolates the heavy tail into its own
    block(s) and leaves near-uniform blocks elsewhere.
    """
    lens = _as_lens(row_lens)
    n = lens.shape[0]
    if n == 0:
        raise ValueError("cannot partition an empty matrix")
    segments = [(0, n)]
    while len(segments) < max_blocks:
        best = None  # (gain, seg_idx, cut)
        for si, (s, e) in enumerate(segments):
            if e - s < 2 * min_rows:
                continue
            cut, gain = _best_split(lens, s, e)
            if cut is None or cut - s < min_rows or e - cut < min_rows:
                # clamp the cut into the feasible band and re-score
                cut = int(np.clip(cut or s + min_rows, s + min_rows,
                                  e - min_rows))
                seg = lens[s:e].astype(np.float64)
                k = cut - s
                sse = lambda v: float(np.sum(v * v) - v.sum() ** 2 / len(v))
                gain = sse(seg) - sse(seg[:k]) - sse(seg[k:])
            if gain > min_gain and (best is None or gain > best[0]):
                best = (gain, si, cut)
        if best is None:
            break
        _, si, cut = best
        s, e = segments[si]
        segments[si:si + 1] = [(s, cut), (cut, e)]
    boundaries = np.array(sorted({s for s, _ in segments} | {n}),
                          dtype=np.int64)
    return _validate(boundaries, n)


PARTITIONERS: Dict[str, Callable[..., np.ndarray]] = {
    "fixed": partition_fixed,
    "balanced_nnz": partition_balanced_nnz,
    "variance": partition_variance,
}


# ---------------------------------------------------------------------------
# device-count granularity (the sharding tier's view of the strategies)
# ---------------------------------------------------------------------------
def _split_heaviest(boundaries: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Add one cut: bisect the slab with the most nnz at its nnz midpoint
    (falling back to the row midpoint for empty slabs)."""
    csum = np.concatenate([[0], np.cumsum(lens)])
    slab_nnz = csum[boundaries[1:]] - csum[boundaries[:-1]]
    slab_rows = np.diff(boundaries)
    # only slabs with >= 2 rows can be split again
    candidates = np.where(slab_rows >= 2, slab_nnz, -1)
    i = int(np.argmax(candidates))
    if candidates[i] < 0:
        raise ValueError("cannot split further: every slab has one row")
    s, e = int(boundaries[i]), int(boundaries[i + 1])
    target = (csum[s] + csum[e]) / 2.0
    cut = int(np.searchsorted(csum[s:e], target, side="left")) + s
    cut = int(np.clip(cut, s + 1, e - 1))
    return np.insert(boundaries, i + 1, cut)


def partition_for_devices(row_lens, n_devices: int,
                          strategy: str = "balanced_nnz",
                          **strategy_kw) -> np.ndarray:
    """Exactly ``n_devices`` slabs — the strategies lifted to device-count
    granularity for the sharding tier.

    The block partitioners are free to emit however many blocks the data
    suggests; a device mesh needs *exactly one slab per device*.  The
    named strategy proposes boundaries (fixed/balanced_nnz are asked for
    ``n_devices`` blocks directly; variance keeps its own knobs capped at
    ``n_devices``), then the result is refined to the exact count:
    too few -> bisect the heaviest slab at its nnz midpoint; too many ->
    merge the lightest adjacent pair.  Unlike ``build_hybrid`` the row
    space is *never* sorted here — device slabs must stay contiguous in
    the original row order so shard outputs reassemble by concatenation
    alone (no scatter collective)."""
    lens = _as_lens(row_lens)
    n = lens.shape[0]
    n_devices = int(n_devices)
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if n_devices > n:
        raise ValueError(f"cannot cut {n} rows into {n_devices} device "
                         f"slabs (need >= 1 row per device)")
    if strategy == "fixed":
        # equal row counts, ignoring block_rows: the device analogue
        b = np.round(np.linspace(0, n, n_devices + 1)).astype(np.int64)
    elif strategy == "balanced_nnz":
        b = partition_balanced_nnz(lens, n_blocks=n_devices)
    elif strategy == "variance":
        kw = dict(strategy_kw)
        kw.setdefault("min_rows", max(1, n // (4 * n_devices)))
        kw["max_blocks"] = n_devices
        b = partition_variance(lens, **kw)
    elif strategy in PARTITIONERS:
        b = PARTITIONERS[strategy](lens, **strategy_kw)
    else:
        raise KeyError(f"unknown strategy {strategy!r}; "
                       f"one of {sorted(PARTITIONERS)}")
    b = np.unique(np.clip(np.asarray(b, dtype=np.int64), 0, n))
    while b.shape[0] - 1 < n_devices:
        b = _split_heaviest(b, lens)
    while b.shape[0] - 1 > n_devices:
        # merge the adjacent pair with the least combined nnz
        csum = np.concatenate([[0], np.cumsum(lens)])
        slab_nnz = csum[b[1:]] - csum[b[:-1]]
        i = int(np.argmin(slab_nnz[:-1] + slab_nnz[1:]))
        b = np.delete(b, i + 1)
    return _validate(b, n)


__all__ = ["partition_fixed", "partition_balanced_nnz", "partition_variance",
           "partition_for_devices", "PARTITIONERS"]
