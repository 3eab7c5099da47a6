"""HPCG's operator (Dongarra, Heroux, Luszczek, HPCG Technical
Specification, SAND2013-8752, section 2): the 27-point stencil on an
``nx x ny x nz`` grid, ``diagonal`` on the diagonal and ``off_diagonal``
for every neighbour inside the grid, rows in HPCG's order
(``iz * nx * ny + iy * nx + ix``) and each row's columns ascending, as
HPCG's loop over ``sz, sy, sx`` in -1..1 writes them.  Built on the card
from index arithmetic."""
from __future__ import annotations

import torch

from ..matrix import Matrix


def build(cfg, seed, device) -> Matrix:
    nx, ny, nz = int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])
    n = nx * ny * nz
    r = torch.arange(n, device=device, dtype=torch.int64)
    ix, iy, iz = r % nx, (r // nx) % ny, r // (nx * ny)
    step = torch.tensor([-1, 0, 1], device=device, dtype=torch.int64)
    sz, sy, sx = torch.meshgrid(step, step, step, indexing="ij")
    sz, sy, sx = sz.reshape(-1), sy.reshape(-1), sx.reshape(-1)
    valid = (((ix[:, None] + sx) >= 0) & ((ix[:, None] + sx) < nx)
             & ((iy[:, None] + sy) >= 0) & ((iy[:, None] + sy) < ny)
             & ((iz[:, None] + sz) >= 0) & ((iz[:, None] + sz) < nz))
    cols = (r[:, None] + (sz * nx * ny + sy * nx + sx))[valid]
    diag = cols == r.repeat_interleave(valid.sum(1))
    vals = torch.where(diag, float(cfg["diagonal"]),
                       float(cfg["off_diagonal"])).to(torch.float32)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(valid.sum(1), 0, out=indptr[1:])
    return Matrix(indptr.to(torch.int32), cols.to(torch.int32), vals, n)
