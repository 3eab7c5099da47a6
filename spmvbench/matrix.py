"""The benchmark's own CSR arrays: what a generator makes from the seed and
hands, unchanged, to the program and to the reference."""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Matrix:
    """A CSR matrix as three device arrays: ``indptr`` (n_rows + 1, int32),
    ``cols`` (nnz, int32, ascending within a row), ``vals`` (nnz,
    float32)."""
    indptr: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    n_cols: int

    @property
    def n_rows(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def nnz(self) -> int:
        return int(self.cols.shape[0])

    def row_lengths(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def row_ids(self) -> torch.Tensor:
        """The row of every entry (int64)."""
        return torch.repeat_interleave(
            torch.arange(self.n_rows, device=self.indptr.device),
            self.row_lengths().long(), output_size=self.nnz)

    def with_values(self, vals: torch.Tensor) -> "Matrix":
        """A fresh matrix of the same pattern: every array its own copy."""
        return Matrix(self.indptr.clone(), self.cols.clone(), vals,
                      self.n_cols)

    def to_program(self):
        """The port's CSR container over copies of these arrays, so that
        nothing the program does can reach the arrays the reference
        reads."""
        from repro_torch.core.formats import CSR
        return CSR(data=self.vals.clone(), cols=self.cols.clone(),
                   indptr=self.indptr.clone(),
                   shape=(self.n_rows, self.n_cols), nnz=self.nnz)


def from_coordinates(rows: torch.Tensor, cols: torch.Tensor,
                     vals: torch.Tensor, n_rows: int, n_cols: int) -> Matrix:
    """CSR from entries already sorted by (row, column), without
    duplicates."""
    counts = torch.bincount(rows, minlength=n_rows)
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return Matrix(indptr.to(torch.int32), cols.to(torch.int32),
                  vals.to(torch.float32), n_cols)


def generator(seed: int, device: torch.device, *salt: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` and the
    ``salt`` integers (a stream of its own for each purpose)."""
    s = int(seed) & ((1 << 63) - 1)
    for v in salt:
        # splitmix64 step: distinct salts give unrelated streams
        s = (s + 0x9E3779B97F4A7C15 + int(v)) & ((1 << 64) - 1)
        s ^= s >> 30
        s = (s * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        s ^= s >> 27
        s = (s * 0x94D049BB133111EB) & ((1 << 64) - 1)
        s ^= s >> 31
    g = torch.Generator(device=device)
    g.manual_seed(s & ((1 << 63) - 1))
    return g
