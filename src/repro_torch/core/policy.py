"""Memory-budget auto-tuning policy (paper §2.2, second drawback).

"Approximately 2x or more of memory space is needed in comparison with
using CRS.  To solve this memory problem, we proposed the 'auto-tuning
policy' for memory space from user requirements" — realized here as a
filter over candidate formats given a user byte budget."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

from .formats import CSR, MatrixStats, memory_bytes
from .transform import pad_to_multiple


@dataclass(frozen=True)
class MemoryPolicy:
    """``budget_ratio``: allowed bytes(fmt)/bytes(csr).  inf = unrestricted.
    ``hard_bytes``: absolute cap (e.g. free device memory), 0 = ignore."""
    budget_ratio: float = 2.0
    hard_bytes: int = 0

    def estimate_bytes(self, fmt: str, stats: MatrixStats,
                       val_bytes: int = 4, idx_bytes: int = 4) -> int:
        n, nnz = stats.n, stats.nnz
        if fmt == "csr":
            return nnz * (val_bytes + idx_bytes) + (n + 1) * idx_bytes
        if fmt.startswith("coo"):
            return nnz * (val_bytes + 2 * idx_bytes)
        if fmt.startswith("ell"):
            return n * stats.max_row * (val_bytes + idx_bytes)
        if fmt == "sell":
            # sigma-sort removes inter-slice padding: ~ nnz rounded up
            w = pad_to_multiple(max(int(stats.mu + stats.sigma), 1), 8)
            return n * w * (val_bytes + idx_bytes) + n * idx_bytes
        if fmt == "hybrid":
            # each block independently passes this policy against its own
            # CSR footprint, and CSR is always a candidate, so the whole
            # matrix is bounded by ~CSR plus per-block indptr/perm overhead
            csr = nnz * (val_bytes + idx_bytes) + (n + 1) * idx_bytes
            return int(1.05 * csr) + n * idx_bytes
        raise KeyError(fmt)

    def allowed(self, formats: Sequence[str], csr: CSR) -> Dict[str, bool]:
        stats = MatrixStats.of(csr)
        base = memory_bytes(csr)
        out = {}
        for f in formats:
            b = self.estimate_bytes(f, stats)
            ok = b <= self.budget_ratio * base
            if self.hard_bytes:
                ok = ok and b <= self.hard_bytes
            out[f] = ok
        return out


__all__ = ["MemoryPolicy"]
