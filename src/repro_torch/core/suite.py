"""Synthetic benchmark-matrix suite reproducing Table 1 of the paper.

The UF Sparse Matrix Collection is not bundled,
so each of the paper's 22 matrices is *synthesized* to match its published
(N, NNZ, mu, sigma, D_mat) row-statistics exactly in expectation:

  * low-variation matrices (D_mat < 0.8): row lengths ~ round(N(mu, sigma)),
    clipped to [1, n] — FEM/banded character (chem_master, wang, epb, ...);
  * heavy-tailed matrices (memplus D=3.10, torso1 D=5.72): a two-point row-
    length mixture (a few very long rows among short ones) whose parameters
    are solved analytically from (mu, sigma) — this reproduces exactly the
    structure that makes ELL explode (the paper removed torso1's ELL run for
    memory overflow; our generator reproduces that pathology).

Row totals are then exactly adjusted to hit NNZ.  Column patterns are
contiguous bands centered on the diagonal (optionally hash-scattered), so
all row indices are unique per row.

The generators produce, array for array, what the JAX package's produce from
the same seed; the per-row Python loop there is vectorized here
(``np.repeat``-based band / scatter columns) so that a full-size matrix
takes seconds.  Matrices are built on the host (CPU tensors).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike
from .formats import CSR, MatrixStats
from .transform import _csr_from_flat


@dataclass(frozen=True)
class MatrixSpec:
    no: int
    name: str
    n: int
    nnz: int
    mu: float
    sigma: float
    d_mat: float
    field: str
    scatter: bool = False   # hash-scattered columns instead of a band


TABLE1: Tuple[MatrixSpec, ...] = (
    MatrixSpec(1, "chipcool0", 20082, 281150, 14.00, 2.69, 0.19, "2D/3D"),
    MatrixSpec(2, "chem_master1", 40401, 201201, 4.98, 0.14, 0.02, "2D/3D"),
    MatrixSpec(3, "torso1", 116158, 8516500, 73.31, 419.58, 5.72, "2D/3D"),
    MatrixSpec(4, "torso2", 115067, 1033473, 8.91, 0.58, 0.06, "2D/3D"),
    MatrixSpec(5, "torso3", 259156, 4429042, 17.09, 4.39, 0.25, "2D/3D"),
    MatrixSpec(6, "memplus", 17758, 126150, 7.10, 22.03, 3.10,
               "Electric circuit", scatter=True),
    MatrixSpec(7, "ex19", 12005, 259879, 21.64, 12.28, 0.56, "Fluid dynamics"),
    MatrixSpec(8, "poisson3Da", 13514, 352762, 26.10, 13.76, 0.52,
               "Fluid dynamics"),
    MatrixSpec(9, "poisson3Db", 85623, 2374949, 27.73, 14.71, 0.53,
               "Fluid dynamics"),
    MatrixSpec(10, "airfoil_2d", 14214, 259688, 18.26, 3.94, 0.21,
               "Fluid dynamics"),
    MatrixSpec(11, "viscoplastic2", 32769, 381326, 11.63, 13.95, 1.19,
               "Materials", scatter=True),
    MatrixSpec(12, "xenon1", 48600, 1181120, 24.30, 4.25, 0.17, "Materials"),
    MatrixSpec(13, "xenon2", 157464, 3866688, 24.55, 4.06, 0.16, "Materials"),
    MatrixSpec(14, "wang3", 26064, 177168, 6.79, 0.43, 0.06, "Semiconductor"),
    MatrixSpec(15, "wang4", 26068, 177196, 6.79, 0.43, 0.06, "Semiconductor"),
    MatrixSpec(16, "ec132", 51993, 380415, 7.31, 3.35, 0.45, "Semiconductor"),
    MatrixSpec(17, "sme3Da", 12504, 874887, 69.96, 34.92, 0.49, "Structural"),
    MatrixSpec(18, "sme3Db", 29067, 2081063, 71.59, 37.06, 0.51, "Structural"),
    MatrixSpec(19, "sme3Dc", 42930, 3148656, 73.34, 36.98, 0.50, "Structural"),
    MatrixSpec(20, "epb1", 14734, 95053, 6.45, 0.57, 0.08, "Thermal"),
    MatrixSpec(21, "epb2", 25228, 175027, 6.93, 6.38, 0.92, "Thermal",
               scatter=True),
    MatrixSpec(22, "epb3", 84617, 463625, 5.47, 0.54, 0.10, "Thermal"),
)


# ---------------------------------------------------------------------------
# row-length models
# ---------------------------------------------------------------------------
def _lengths_normal(rng: np.random.Generator, n: int, mu: float,
                    sigma: float) -> np.ndarray:
    lens = np.rint(rng.normal(mu, sigma, size=n)).astype(np.int64)
    return np.clip(lens, 1, n)


def _lengths_two_point(n: int, mu: float, sigma: float) -> np.ndarray:
    """Deterministic two-point mixture matching (mu, sigma) exactly:
    f*B + (1-f)*S = mu ;  f*B^2 + (1-f)*S^2 = sigma^2 + mu^2."""
    s = max(1, int(round(mu / 2)))
    m2 = sigma * sigma + mu * mu
    big = (m2 - s * s) / max(mu - s, 1e-9)          # B = E[L^2]-S^2 / E[L]-S
    f = (mu - s) / max(big - s, 1e-9)
    big = int(min(round(big), n))                    # ELL width cap = n
    n_big = max(1, int(round(f * n)))
    lens = np.full(n, s, dtype=np.int64)
    # spread long rows evenly so bands don't collide
    idx = np.linspace(0, n - 1, n_big).astype(np.int64)
    lens[idx] = big
    return lens


def _adjust_total(lens: np.ndarray, target_nnz: int, n: int) -> np.ndarray:
    """Exactly hit the target total by +/-1 adjustments on random rows."""
    lens = lens.copy()
    diff = int(target_nnz - lens.sum())
    if diff == 0:
        return lens
    step = 1 if diff > 0 else -1
    k = abs(diff)
    order = np.argsort(lens) if step > 0 else np.argsort(-lens)
    i = 0
    while k > 0:
        r = order[i % n]
        new = lens[r] + step
        if 1 <= new <= n:
            lens[r] = new
            k -= 1
        i += 1
    return lens


# ---------------------------------------------------------------------------
# column patterns (vectorized over all rows at once)
# ---------------------------------------------------------------------------
def _row_offsets(lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per stored entry: its row, and its position within that row."""
    n = lens.shape[0]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]) if n else lens
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    within = np.arange(int(lens.sum()), dtype=np.int64) - starts[rows]
    return rows, within


def _band_cols(lens: np.ndarray, n: int) -> np.ndarray:
    """Row i holds the contiguous band of its length centered on the
    diagonal, shifted to stay inside [0, n)."""
    i = np.arange(lens.shape[0], dtype=np.int64)
    start = np.minimum(np.maximum(i - lens // 2, 0), n - lens)
    rows, within = _row_offsets(lens)
    return (start[rows] + within).astype(np.int32)


_PRIMES = (1000003, 411451, 611953)


def _scatter_cols(lens: np.ndarray, n: int, salt: int) -> np.ndarray:
    """Unique pseudo-random columns: i + k*h (mod n) with gcd(h, n) = 1."""
    h = _PRIMES[salt % len(_PRIMES)]
    while np.gcd(h, n) != 1:
        h += 2
    rows, within = _row_offsets(lens)
    return ((rows + within * h) % n).astype(np.int32)


# ---------------------------------------------------------------------------
# matrix synthesis
# ---------------------------------------------------------------------------
def synthesize(spec: MatrixSpec, scale: float = 1.0, seed: int = 0,
               pad: int = 8, device: DeviceLike = None) -> CSR:
    """Generate a CSR matrix matching ``spec``'s row statistics.

    ``scale`` != 1 scales N (and NNZ proportionally) while preserving
    mu/sigma/D_mat — the statistics the AT method keys on are
    scale-invariant."""
    rng = np.random.default_rng(seed + spec.no)
    n = max(int(round(spec.n * scale)), 64)
    nnz = max(int(round(spec.nnz * scale)), n)
    if spec.d_mat >= 0.8:
        lens = _lengths_two_point(n, spec.mu, spec.sigma)
    else:
        lens = _lengths_normal(rng, n, spec.mu, spec.sigma)
    lens = _adjust_total(lens, nnz, n)
    lens = np.minimum(lens, n)

    cols = (_scatter_cols(lens, n, spec.no) if spec.scatter
            else _band_cols(lens, n))
    # deterministic value pattern (diag-dominant-ish), cheap:
    vals = (1.0 + 0.01 * (np.arange(cols.shape[0]) % 7)).astype(np.float32)
    return _csr_from_flat(cols, vals, lens, n_cols=n, pad=pad, device=device)


def paper_suite(scale: float = 1.0, seed: int = 0,
                include: Optional[Sequence[str]] = None,
                skip_ell_overflow: bool = False,
                device: DeviceLike = None) -> List[Tuple[str, CSR]]:
    """The 22-matrix Table-1 suite.  ``skip_ell_overflow`` drops torso1,
    mirroring the paper ("the overflow memory space is in the ELL format ...
    we removed the data")."""
    out = []
    for spec in TABLE1:
        if include is not None and spec.name not in include:
            continue
        if skip_ell_overflow and spec.name == "torso1":
            continue
        out.append((spec.name, synthesize(spec, scale=scale, seed=seed,
                                          device=device)))
    return out


def synthesize_power_law(n: int = 8192, mu: float = 8.0, alpha: float = 2.0,
                         seed: int = 0, random_values: bool = False,
                         device: DeviceLike = None) -> CSR:
    """Beyond Table 1: Zipf-ish row lengths (most rows short, a few huge) —
    the heavy-tail structure that stalls whole-matrix ELL via max_row
    padding."""
    rng = np.random.default_rng(seed)
    lens = np.minimum((rng.pareto(alpha, size=n) + 1) * mu / 2, n // 2)
    lens = np.maximum(lens.astype(np.int64), 1)
    cols = _band_cols(lens, n)
    # one draw of the total length equals the per-row draws in row order
    vals = (rng.normal(size=cols.shape[0]).astype(np.float32)
            if random_values else np.full(cols.shape[0], 1.0, np.float32))
    return _csr_from_flat(cols, vals, lens, n_cols=n, pad=8, device=device)


#: entry orders that stress the COO kernels' reduction of runs of equal rows
#: (every one a valid COO): all entries in one row, rows alternating every
#: entry, a random permutation, rows descending, pads ``(0, 0, 0.0)`` at the
#: end, two empty rows around each stored one, and an odd entry count (no
#: multiple of any block or per-thread chunk)
COO_ORDERS = ("one_row", "alternating", "random", "descending",
              "pads_at_end", "empty_rows", "ragged")


def coo_entries(rows: np.ndarray, cols: np.ndarray, data: np.ndarray,
                n_rows: int, order: str, seed: int = 0):
    """``(rows, cols, data, n_rows)``: the COO entries of an ``n_rows``-row
    matrix rearranged in ``order`` (one of :data:`COO_ORDERS`) as numpy
    arrays — inputs on which the COO kernels are held against their plain
    versions.  ``one_row`` and ``alternating`` move the entries to other
    rows, ``empty_rows`` to row ``3 r + 1`` of ``3 n_rows + 1``."""
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    data = np.asarray(data)
    nnz = rows.shape[0]
    if order == "one_row":
        return np.full(nnz, n_rows // 2, np.int32), cols, data, n_rows
    if order == "alternating":
        alt = np.where(np.arange(nnz) % 2 == 0, 0, n_rows - 1)
        return alt.astype(np.int32), cols, data, n_rows
    if order in ("random", "descending"):
        perm = (np.random.default_rng(seed).permutation(nnz)
                if order == "random" else np.argsort(-rows, kind="stable"))
        return rows[perm], cols[perm], data[perm], n_rows
    if order == "pads_at_end":
        pads = nnz // 3 + 5
        return (np.concatenate([rows, np.zeros(pads, np.int32)]),
                np.concatenate([cols, np.zeros(pads, np.int32)]),
                np.concatenate([data, np.zeros(pads, data.dtype)]), n_rows)
    if order == "empty_rows":
        return 3 * rows + 1, cols, data, 3 * n_rows + 1
    if order == "ragged":
        keep = nnz - 1 + nnz % 2        # the largest odd count <= nnz
        return rows[:keep], cols[:keep], data[:keep], n_rows
    raise ValueError(f"unknown COO order {order!r}; one of {COO_ORDERS}")


def verify_suite(scale: float = 1.0, rtol: float = 0.25) -> List[str]:
    """Return a list of mismatch messages (empty = all stats reproduced)."""
    msgs = []
    for spec in TABLE1:
        st = MatrixStats.of(synthesize(spec, scale=scale, device="cpu"))
        for field, want, got in (("mu", spec.mu, st.mu),
                                 ("d_mat", spec.d_mat, st.d_mat)):
            if abs(got - want) > rtol * max(want, 0.05):
                msgs.append(f"{spec.name}.{field}: want {want}, got {got:.3f}")
    return msgs


__all__ = ["MatrixSpec", "TABLE1", "synthesize", "synthesize_power_law",
           "paper_suite", "verify_suite", "COO_ORDERS", "coo_entries"]
