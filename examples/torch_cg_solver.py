"""End-to-end example of the paper's use case on the PyTorch/CUDA port: an
iterative solver whose SpMV is auto-tuned at run time.

The paper's amortization argument (§2.2): transformation pays off when the
iteration count covers the transformation cost — 'this range is achievable
for many iterative solvers'.  This Conjugate-Gradient solver is exactly
that setting: we report total solve time with CRS vs with the auto-tuned
format, including the transformation overhead.

The port of ``examples/cg_solver.py``, step for step.  Every SpMV runs on
the kernel tier: the hand-written CUDA kernels on the card (CRS: the CSR
kernel; ELL-Row: the ELL kernel), their plain PyTorch versions on the CPU.
The off-line phase times those kernels, so its ``D*`` is the card's.

    PYTHONPATH=src python examples/torch_cg_solver.py
    PYTHONPATH=src python examples/torch_cg_solver.py --n 2097152
    PYTHONPATH=src python examples/torch_cg_solver.py --device cpu --n 2000
"""
import argparse
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch import MatrixStats, Planner, offline_phase
from repro_torch.core.formats import CSR
from repro_torch.core.suite import paper_suite
from repro_torch.device import resolve_device


def spd_band_matrix(n=20_000, band=9, device=None):
    """Symmetric positive-definite banded matrix (uniform rows: low D_mat —
    the regime where the ELL transformation wins).

    The reference's matrix (``csr_from_rows(..., pad=8)`` of one row at a
    time), built in numpy without a loop over rows so that it reaches
    millions of rows."""
    half = band // 2
    rows = np.arange(n, dtype=np.int32)
    cols = rows[:, None] + np.arange(-half, half + 1, dtype=np.int32)
    live = (cols >= 0) & (cols < n)
    lens = live.sum(axis=1)
    cols = cols[live]
    vals = np.where(cols == np.repeat(rows, lens), np.float32(band + 2),
                    np.float32(-0.5)).astype(np.float32)
    nnz = int(cols.shape[0])
    nnz_pad = max(-(-nnz // 8) * 8, 8)
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(lens, out=indptr[1:])
    data = np.zeros(nnz_pad, np.float32)
    data[:nnz] = vals
    padded_cols = np.zeros(nnz_pad, np.int32)
    padded_cols[:nnz] = cols
    return CSR(data=torch.from_numpy(data),
               cols=torch.from_numpy(padded_cols),
               indptr=torch.from_numpy(indptr), shape=(n, n),
               nnz=nnz).to(resolve_device(device))


def cg(matvec, b, iters=150, tol=1e-6):
    """The reference's CG; returns ``(x, residual, iterations run)``.  The
    residual's norm is read to the host every iteration, as there."""
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r
    rs = torch.dot(r, r)
    done = 0
    for _ in range(iters):
        Ap = matvec(p)
        alpha = rs / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        done += 1
        if float(torch.sqrt(rs_new)) < tol:
            break
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x, float(torch.sqrt(rs)), done


def clock(device):
    """Host seconds, read once the card has finished what was enqueued."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@dataclass
class Solve:
    x: torch.Tensor
    residual: float
    iterations: int
    seconds: float       # the whole timed window
    fmt: str
    rule: str
    P: Any               # the bound operator (``P @ x``)
    t_plan: float = 0.0  # D_mat and the decision
    t_bind: float = 0.0  # the run-time transform: host recipe, upload, set-up


def offline_db(device):
    """The off-line phase over the suite on this machine, timing the
    kernel tier's SpMV (the reference's arguments)."""
    from repro_torch.kernels import ops
    return offline_phase(paper_suite(scale=0.02, skip_ell_overflow=True,
                                     device=device),
                         formats=("ell_row", "sell"), iters=2,
                         machine="cg-example",
                         spmv_impls=ops.KERNEL_SPMV_IMPLS, device=device)


def crs_solve(A, b, iters=150):
    """CG over the CRS product (the CSR kernel); the first product, which
    loads the kernel, runs outside the timing, as the reference compiles
    its jitted SpMV outside it."""
    device = b.device
    P = Planner(tier="kernel", device=device).plan(A, fmt="csr").bind(
        A, device=device)
    _ = P @ b
    t0 = clock(device)
    x, res, done = cg(P, b, iters)
    return Solve(x, res, done, clock(device) - t0, "csr", "crs", P)


def tuned_solve(A, b, db, iters=150, fmt=None):
    """CG over the auto-tuned format, the run-time transformation inside
    the timing: plan (``D_mat`` and the generalized rule over ``iters``
    expected iterations; ``fmt`` forces a format), bind (the transform),
    the first product, then CG."""
    device = b.device
    t0 = clock(device)
    plan = Planner(db=db, tier="kernel", device=device).plan(
        A, rule="generalized", expected_iterations=iters, fmt=fmt)
    t1 = time.perf_counter()
    P = plan.bind(A, db=db, device=device)
    t2 = clock(device)
    _ = P @ b
    x, res, done = cg(P, b, iters)
    return Solve(x, res, done, clock(device) - t0, plan.fmt, plan.rule, P,
                 t_plan=t1 - t0, t_bind=t2 - t1)


def agree(x_a, x_b):
    """The reference's check that two solutions agree."""
    np.testing.assert_allclose(x_a.cpu().numpy(), x_b.cpu().numpy(),
                               rtol=1e-3, atol=1e-4)


def run(db, A, iters=150):
    """Both solves of ``A x = 1``, printed; returns the figures."""
    stats = MatrixStats.of(A)
    b = torch.ones((A.n_cols,), dtype=torch.float32, device=A.data.device)
    print(f"matrix: n={stats.n} nnz={stats.nnz} D_mat={stats.d_mat:.3f}")

    print("== CRS baseline ==")
    crs = crs_solve(A, b, iters)
    print(f"CRS   : {crs.seconds*1e3:8.1f} ms  residual={crs.residual:.2e}")

    print("== auto-tuned (includes run-time transformation) ==")
    at = tuned_solve(A, b, db, iters)
    print(f"{at.fmt:6s}: {at.seconds*1e3:8.1f} ms  "
          f"residual={at.residual:.2e}  (decision rule={at.rule})")
    print(f"speedup including transformation: "
          f"{crs.seconds / at.seconds:.2f}x")
    agree(crs.x, at.x)
    print("solutions agree.")
    return {"n": stats.n, "nnz": stats.nnz, "d_mat": stats.d_mat,
            "fmt": at.fmt, "rule": at.rule, "t_crs": crs.seconds,
            "t_at": at.seconds, "t_plan_at": at.t_plan,
            "t_bind_at": at.t_bind, "iterations_crs": crs.iterations,
            "iterations_at": at.iterations, "residual_crs": crs.residual,
            "residual_at": at.residual}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20_000, help="matrix rows")
    ap.add_argument("--band", type=int, default=9, help="band width")
    ap.add_argument("--iters", type=int, default=150,
                    help="CG iterations at most (and the rule's expected "
                         "iterations)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("== off-line phase (suite on this machine) ==")
    db = offline_db(device)
    return run(db, spd_band_matrix(args.n, args.band, device), args.iters)


if __name__ == "__main__":
    main()
