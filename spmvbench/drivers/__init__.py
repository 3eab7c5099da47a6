"""Traffic drivers, one module a kind, found by the ``driver`` key of a
traffic file.  Each has ``Driver(ctx)`` with ``setup()`` (which calls
``draw()``: the seed's vectors and zeroed counters), ``unit()`` (one
set, job or flush, ended by a synchronize), ``end_to_end(window_s,
setup_s)``, ``describe(view)``, ``release()`` and ``check()``; its
counters ``units``, ``attempted`` and ``failed``; and ``plan_line``, the
formats the program chose.  A driver reaches the system under test only
through ``ctx.program`` (``spmvbench.program``): the port in a benchmark
run, the control in its place in a control run."""
from __future__ import annotations

import torch

from ..matrix import generator


def vectors(ctx, count: int, kind: str, salt: int) -> torch.Tensor:
    """``count`` vectors of the matrix's width, drawn on the card from the
    seed: ``normal`` (a right-hand side, a query) or ``simplex`` (uniform,
    scaled to sum 1: a teleport vector)."""
    g = generator(ctx.seed, ctx.device, salt)
    n = ctx.matrix.n_cols
    if kind == "normal":
        return torch.randn((count, n), generator=g, device=ctx.device)
    v = torch.rand((count, n), generator=g, device=ctx.device) + 0.5
    return v / v.sum(dim=1, keepdim=True)


def max_gap(a: torch.Tensor, b: torch.Tensor, scale: float) -> float:
    """``max |a - b| / scale`` in float64; infinite where either side is
    not finite, so that a NaN can never pass."""
    g = float((a.double() - b.double()).abs().max()) / scale
    return g if g == g else float("inf")
