"""Closed loop, one client, queue never empty: single query vectors from a
pool drawn from the seed are submitted back to back to ``SpMVService``
under one registered key; every ``max_batch``-th submit flushes a panel.
A vector is answered once the synchronize after its flush returns; its
latency runs from its ``submit`` to that synchronize.

The service runs at its defaults (guard on, no TuningDB), with a tuner
that may time only the default launch (``spmvbench.program``).

Traffic keys: ``max_batch``, ``query_pool``, ``check_vectors`` (answers
compared with the reference, drawn from the seed; the last flush's first
answer too), ``trace_units`` (flushes in the traced window)."""
from __future__ import annotations

import math
import time

from .. import roofline
from ..harness import Keep
from ..reference import Reference
from . import max_gap, vectors

KEY = "matrix"


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.batch = int(t["max_batch"])

    def draw(self):
        """The seed's query vectors; the window's counters from zero."""
        ctx = self.ctx
        self.pool = vectors(ctx, int(ctx.traffic["query_pool"]), "normal", 3)
        self.keep = Keep(int(ctx.traffic["check_vectors"]), ctx.seed)
        self.units = self.attempted = self.failed = 0
        self.submitted = 0
        self.latencies, self.flush_s = [], []
        self.last = None

    def setup(self):
        ctx = self.ctx
        self.draw()
        self.svc, self.plan_line = ctx.program.service(KEY, ctx.matrix,
                                                       self.batch)
        self._flush(count=False)                 # warm-up: one flush
        self.latencies, self.flush_s = [], []

    def _flush(self, count=True):
        ctx, mark = self.ctx, self.ctx.mark
        starts, futs = [], []
        for i in range(self.batch):
            k = self.submitted % self.pool.shape[0]
            self.submitted += 1
            if i == self.batch - 1:
                ctx.sync()
                t0 = time.perf_counter()
                starts.append(t0)
                with mark("flush"):
                    futs.append((k, self.svc.submit(KEY, self.pool[k])))
                    ctx.sync()
            else:
                starts.append(time.perf_counter())
                futs.append((k, self.svc.submit(KEY, self.pool[k])))
        ctx.sync()
        done = time.perf_counter()
        if not count:
            return
        self.flush_s.append(done - t0)
        self.latencies.extend(done - s for s in starts)
        for k, f in futs:
            self.attempted += 1
            try:
                y = f.result(timeout=60)
            except Exception:           # a failed answer counts as failed
                self.failed += 1
                continue
            # a wrong answer (NaN included) is the check's to find
            self.keep.offer(lambda k=k, y=y: (k, y))
        self.last = futs[0][0], futs[0][1].result()

    def unit(self):
        self._flush()
        self.units += 1

    def end_to_end(self, window_s, setup_s):
        lat = sorted(self.latencies)
        p95 = lat[max(math.ceil(0.95 * len(lat)) - 1, 0)]
        return {"vectors_per_s": len(lat) / window_s,
                "vector_p95_ms": p95 * 1e3, "setup_s": setup_s}

    def describe(self, view):
        view.counts.update(units=self.units, flushes=self.units,
                           vectors=len(self.latencies))
        view.host["flush"] = list(self.flush_s)
        view.info["panel_bytes"] = roofline.form_bytes(self.ctx.matrix,
                                                       rhs=self.batch)

    def release(self):
        self.svc = None
        self.ctx.program.release()

    def check(self):
        ref = Reference(self.ctx.matrix)
        gap = 0.0
        for k, y in self.keep.items + [self.last]:
            x = self.pool[k]
            scale = float(ref.abs_product(x).max())
            gap = max(gap, max_gap(y, ref(x), scale))
        return {"y_gap": gap}
