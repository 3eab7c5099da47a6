"""Closed loop, one client: back-to-back sets of an iterative method on an
operator planned and bound in set-up.  A set runs ``iterations`` products
from a right-hand side of the seed's pool, then one synchronize and one
read of its residual.

Traffic keys: ``method`` (``cg`` | ``pagerank``), ``iterations``,
``damping`` (PageRank), ``rhs_pool`` (vectors drawn from the seed),
``check_sets`` (sets compared with the reference, drawn from the seed;
the window's last set is compared too), ``trace_units`` (sets in the
traced window), ``reports`` (the name of the end-to-end metric a set's
mean time is reported under: each method's sets under a bound of their
own)."""
from __future__ import annotations

import math

from .. import methods, roofline
from ..harness import Keep
from ..reference import Reference
from . import max_gap, vectors


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.method = t["method"]
        self.iterations = int(t["iterations"])
        self.P = None

    def draw(self):
        """The seed's right-hand sides; the window's counters from zero."""
        ctx = self.ctx
        kind = "normal" if self.method == "cg" else "simplex"
        self.pool = vectors(ctx, int(ctx.traffic["rhs_pool"]), kind, 1)
        self.keep = Keep(int(ctx.traffic["check_sets"]), ctx.seed)
        self.units = self.attempted = self.failed = 0
        self.last = None

    def _run(self, matvec, b, mark=methods.NO_MARK):
        if self.method == "cg":
            x, r, rs = methods.cg(matvec, b, self.iterations, mark)
            return x, r, rs.sqrt()
        r, err = methods.pagerank(matvec, b, self.iterations,
                                  float(self.ctx.traffic["damping"]), mark)
        return r, None, err

    def setup(self):
        ctx = self.ctx
        self.draw()
        prog = ctx.program
        self.P = prog.bind(prog.plan(ctx.matrix, self.iterations))
        self.plan_line = prog.describe(self.P)
        self._run(self.P, self.pool[0])          # warm-up: one set
        ctx.sync()

    def unit(self):
        ctx = self.ctx
        k = self.units % self.pool.shape[0]
        with ctx.mark("set"):
            x, r, res = self._run(self.P, self.pool[k], ctx.mark)
            ctx.sync()
            residual = float(res)
        self.units += 1
        self.attempted += 1
        if not math.isfinite(residual):
            self.failed += 1
        self.keep.offer(lambda: (k, x, r))
        self.last = (k, x, r)

    def end_to_end(self, window_s, setup_s):
        return {self.ctx.traffic["reports"]: window_s / self.units * 1e3,
                "setup_s": setup_s}

    def describe(self, view):
        view.counts.update(units=self.units,
                           iterations=self.units * self.iterations,
                           products=self.units * self.iterations)
        view.info["product_bytes"] = roofline.form_bytes(self.ctx.matrix)

    def release(self):
        self.P = None
        self.ctx.program.release()

    def check(self):
        ref = Reference(self.ctx.matrix)
        gap = {"x_gap": 0.0, "r_gap": 0.0} if self.method == "cg" \
            else {"score_gap": 0.0}
        for k, x, r in self.keep.items + [self.last]:
            b = self.pool[k].double()
            x_ref, r_ref, _ = self._run(ref, b)
            if self.method == "cg":
                gap["x_gap"] = max(gap["x_gap"], max_gap(
                    x, x_ref, float(x_ref.abs().max())))
                gap["r_gap"] = max(gap["r_gap"], max_gap(
                    r, r_ref, float(b.abs().max())))
            else:
                gap["score_gap"] = max(gap["score_gap"], max_gap(
                    x, x_ref, float(x_ref.abs().max())))
        return gap
