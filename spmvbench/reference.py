"""The plain reference: ``A @ x`` from the benchmark's own CSR arrays in
float64, in plain PyTorch, in blocks of entries so that it fits beside
what the run keeps.  It imports nothing of the program and reads nothing
the program made.

``LowerPrecision`` is the control: the same product computed in bfloat16
(values and vector rounded to bfloat16, each product rounded to bfloat16
and summed in float32, the result rounded to bfloat16), the step below
the configuration's float32 that would tempt a later change.  It is put
in the program's place by ``program.Control`` (``spmvbench.calibrate``),
never by a benchmark run."""
from __future__ import annotations

import torch

from .matrix import Matrix

#: entries a block of the reference product
BLOCK = 1 << 24


class Reference:
    """``A @ x`` (vector or (n, B) panel) in float64."""

    dtype = torch.float64

    def __init__(self, m: Matrix):
        self.m = m
        self.rows = m.row_ids()

    def values(self, s: int, e: int) -> torch.Tensor:
        return self.m.vals[s:e].to(self.dtype)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        m = self.m
        x = x.to(self.dtype)
        out = torch.zeros((m.n_rows,) + tuple(x.shape[1:]), dtype=self.dtype,
                          device=x.device)
        for s in range(0, m.nnz, BLOCK):
            e = min(s + BLOCK, m.nnz)
            v = self.values(s, e)
            xs = x.index_select(0, m.cols[s:e].long())
            prod = xs * (v if x.ndim == 1 else v[:, None])
            out.index_add_(0, self.rows[s:e], prod)
        return out

    def abs_product(self, x: torch.Tensor) -> torch.Tensor:
        """``|A| @ |x|`` in float64: the scale a product's rounding error is
        measured against."""
        m = self.m
        x = x.to(torch.float64).abs()
        out = torch.zeros((m.n_rows,) + tuple(x.shape[1:]),
                          dtype=torch.float64, device=x.device)
        for s in range(0, m.nnz, BLOCK):
            e = min(s + BLOCK, m.nnz)
            v = m.vals[s:e].to(torch.float64).abs()
            xs = x.index_select(0, m.cols[s:e].long())
            out.index_add_(0, self.rows[s:e], xs * (v if x.ndim == 1
                                                     else v[:, None]))
        return out


class LowerPrecision(Reference):
    """The control: the reference's product in bfloat16, returned in the
    caller's dtype."""

    def values(self, s: int, e: int) -> torch.Tensor:
        return self.m.vals[s:e].to(torch.bfloat16).to(torch.float32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        m = self.m
        xb = x.to(torch.bfloat16).to(torch.float32)
        out = torch.zeros((m.n_rows,) + tuple(x.shape[1:]),
                          dtype=torch.float32, device=x.device)
        for s in range(0, m.nnz, BLOCK):
            e = min(s + BLOCK, m.nnz)
            v = self.values(s, e)
            prod = (xb.index_select(0, m.cols[s:e].long())
                    * (v if x.ndim == 1 else v[:, None]))
            out.index_add_(0, self.rows[s:e],
                           prod.to(torch.bfloat16).to(torch.float32))
        return out.to(torch.bfloat16).to(x.dtype)
