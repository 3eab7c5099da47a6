"""The iterative methods a set runs: a fixed number of iterations, no value
read back inside a set.  One loop serves the program (float32, its
``P @ x``), the reference (float64) and the control, which differ only in
the product and the dtype they are given.

``mark`` wraps each product (a ``torch.profiler.record_function`` range in
a traced run, nothing otherwise)."""
from __future__ import annotations

import contextlib

import torch

NO_MARK = contextlib.nullcontext


def cg(matvec, b, iterations, mark=NO_MARK):
    """Unpreconditioned conjugate gradients from ``x0 = 0`` (so ``r0 = b``):
    ``examples/torch_cg_solver.py``'s loop without its per-iteration
    readback.  Returns ``(x, r, r.r)``, the last a device scalar."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = torch.dot(r, r)
    for _ in range(iterations):
        with mark("spmv"):
            ap = matvec(p)
        alpha = rs / torch.dot(p, ap)
        x.add_(alpha * p)
        r.sub_(alpha * ap)
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x, r, rs


def pagerank(matvec, v, iterations, damping, mark=NO_MARK):
    """GAP's PageRank over the transition matrix (``A[i, j] = 1/deg(j)``),
    personalised by the teleport vector ``v`` (sum 1): ``r <- (1 - d) v +
    d A r`` from ``r0 = v``.  A vertex with no edge passes nothing on, as
    in GAP.  Returns ``(r, ||r_k - r_{k-1}||_1)``, the last a device
    scalar (GAP's error)."""
    base = (1.0 - damping) * v
    r = v.clone()
    err = torch.zeros((), dtype=v.dtype, device=v.device)
    for _ in range(iterations):
        with mark("spmv"):
            y = matvec(r)
        r_new = torch.add(base, y, alpha=damping)
        err = (r_new - r).abs().sum()
        r = r_new
    return r, err
