"""Closed loop, one client: back-to-back run-time jobs.  A job makes a
fresh CRS on the card (the configuration's pattern with new values),
plans it (``Planner.plan``), binds it (``ExecutionPlan.bind``: the
run-time transform) and runs one set of CG on the new operator, then one
synchronize and one read of its residual.

The values of job ``j`` are drawn from the seed and ``j``: each
off-diagonal entry ``-(1 + spread * u)``, with ``u`` uniform and equal for
(i, j) and (j, i), and each diagonal entry one more than its row's
off-diagonal sum, so the matrix stays symmetric and positive definite.

Traffic keys: ``iterations``, ``spread``, ``rhs_pool``, ``check_sets``,
``trace_units``."""
from __future__ import annotations

import math

import torch

from .. import methods, roofline
from ..harness import Keep
from ..matrix import generator
from ..reference import Reference
from . import max_gap, vectors

WARM_UP = -1


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.iterations = int(t["iterations"])
        self.plans = set()

    def draw(self):
        """The seed's right-hand sides; the window's counters from zero."""
        ctx = self.ctx
        self.pool = vectors(ctx, int(ctx.traffic["rhs_pool"]), "normal", 1)
        self.keep = Keep(int(ctx.traffic["check_sets"]), ctx.seed)
        self.units = self.attempted = self.failed = 0
        self.host = {"plan": [], "bind": []}
        self.last = None

    def values(self, j: int) -> torch.Tensor:
        """Job ``j``'s values on the pattern."""
        m, dev = self.ctx.matrix, self.ctx.device
        g = generator(self.ctx.seed, dev, 2, j)
        gv = torch.rand(m.n_rows, generator=g, device=dev,
                        dtype=torch.float64)
        u = torch.frac(gv[self.rows] + gv[self.cols])
        off = -(1.0 + float(self.ctx.traffic["spread"]) * u)
        off = torch.where(self.diag, 0.0, off)
        # each row's sum by a float64 prefix sum: the same on every run
        cs = torch.cumsum(off.abs(), 0)
        ip = m.indptr.long()
        total = torch.cat([cs.new_zeros(1), cs])
        rowsum = total[ip[1:]] - total[ip[:-1]]
        vals = torch.where(self.diag, rowsum[self.rows] + 1.0, off)
        return vals.to(torch.float32)

    def setup(self):
        ctx, m = self.ctx, self.ctx.matrix
        self.rows = m.row_ids()
        self.cols = m.cols.long()
        self.diag = self.rows == self.cols
        self.draw()
        self._job(WARM_UP, self.pool[0])          # warm-up: one job
        ctx.sync()
        self.host = {"plan": [], "bind": []}
        self.plan_line = " | ".join(sorted(self.plans))
        self.plans = set()

    @property
    def window_plans(self) -> str:
        """The formats of every job's plan since set-up."""
        return " | ".join(sorted(self.plans))

    def _job(self, j, b):
        ctx, prog = self.ctx, self.ctx.program
        mark = ctx.mark
        with mark("values"):
            mj = ctx.matrix.with_values(self.values(j))
        t0 = ctx.now()
        with mark("plan"):
            planned = prog.plan(mj, self.iterations)
        t1 = ctx.now()
        with mark("bind"):
            P = prog.bind(planned)
            t2 = ctx.now()
        self.host["plan"].append(t1 - t0)
        self.host["bind"].append(t2 - t1)
        self.plans.add(prog.describe(P))
        x, r, rs = methods.cg(P, b, self.iterations, mark)
        return x, r, rs

    def unit(self):
        ctx = self.ctx
        j = self.units
        k = j % self.pool.shape[0]
        with ctx.mark("job"):
            x, r, rs = self._job(j, self.pool[k])
            ctx.sync()
            residual = float(rs.sqrt())
        self.units += 1
        self.attempted += 1
        if not math.isfinite(residual):
            self.failed += 1
        self.keep.offer(lambda: (j, k, x, r))
        self.last = (j, k, x, r)

    def end_to_end(self, window_s, setup_s):
        return {"job_ms": window_s / self.units * 1e3, "setup_s": setup_s}

    def describe(self, view):
        view.counts.update(units=self.units,
                           iterations=self.units * self.iterations,
                           products=self.units * self.iterations)
        view.host.update(self.host)
        view.info["product_bytes"] = roofline.form_bytes(self.ctx.matrix)

    def release(self):
        self.ctx.program.release()

    def check(self):
        gap = {"x_gap": 0.0, "r_gap": 0.0}
        for j, k, x, r in self.keep.items + [self.last]:
            ref = Reference(self.ctx.matrix.with_values(self.values(j)))
            b = self.pool[k].double()
            x_ref, r_ref, _ = methods.cg(ref, b, self.iterations)
            gap["x_gap"] = max(gap["x_gap"], max_gap(
                x, x_ref, float(x_ref.abs().max())))
            gap["r_gap"] = max(gap["r_gap"], max_gap(
                r, r_ref, float(b.abs().max())))
        return gap
