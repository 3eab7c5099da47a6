"""What the drivers call: the system under test, or the control in its
place, so that no driver has a branch of its own for the control.

:class:`Program` plans and binds an operator with the port's ``Planner``
(``tier="kernel"``, no ``TuningDB``, no tuner: the cost model and the
default launch shapes) and registers a key with its ``SpMVService``.
:class:`Control` answers the same calls with the bfloat16 reference
(``reference.LowerPrecision``): the control of ``correct``, run by
``spmvbench.calibrate`` and the tests, never by a benchmark run."""
from __future__ import annotations

from concurrent.futures import Future

import torch

from .reference import LowerPrecision


def describe_plan(P) -> str:
    """The format a bound plan serves, with its SELL buckets' widths or its
    hybrid blocks' formats."""
    m = P.matrix
    if hasattr(m, "buckets"):
        widths = [int(b.cols.shape[-1]) for b in m.buckets]
        return f"{P.fmt} buckets={len(widths)} widths={widths[:8]}" + (
            "..." if len(widths) > 8 else "")
    if hasattr(m, "blocks"):
        return f"{P.fmt} blocks={list(m.formats)}"
    return str(P.fmt)


class Program:
    """The port, as every cell runs it."""

    def __init__(self, device: torch.device):
        self.device = device
        self._planner = None

    def plan(self, m, iterations: int):
        """``Planner.plan`` over the port's CSR container of ``m`` (a copy
        of the benchmark's arrays)."""
        if self._planner is None:
            from repro_torch import Planner
            self._planner = Planner(tier="kernel", device=self.device)
        csr = m.to_program()
        return self._planner.plan(csr, expected_iterations=iterations), csr

    def bind(self, planned):
        """``ExecutionPlan.bind``: the run-time transform; the operator."""
        plan, csr = planned
        return plan.bind(csr, device=self.device)

    def describe(self, op) -> str:
        return describe_plan(op)

    def service(self, key: str, m, batch: int):
        """``SpMVService`` at its defaults with ``m`` registered under
        ``key``, and the line that names its blocks' formats.

        Without a tuner the service serves the reference tier (plain
        PyTorch), not the CUDA kernels; so it is given a ``KernelTuner``
        that may time only the default launch (``max_candidates=0``): the
        kernels serve, at their default geometry, in every run."""
        from repro_torch.api import KernelTuner, SpMVService
        svc = SpMVService(device=self.device, max_batch=batch,
                          tuner=KernelTuner(max_candidates=0))
        entry = svc.register(key, m.to_program(), batch=batch)
        return svc, (f"hybrid blocks={entry.formats()} "
                     f"order={list(entry.matrix.formats)}")

    def release(self) -> None:
        self._planner = None


class Control(Program):
    """The bfloat16 reference in the program's place."""

    LINE = "control: the bfloat16 reference"

    def plan(self, m, iterations: int):
        return m

    def bind(self, m):
        return LowerPrecision(m)

    def describe(self, op) -> str:
        return self.LINE

    def service(self, key: str, m, batch: int):
        return ControlService(m, batch), self.LINE


class ControlService:
    """``submit`` queues; the ``max_batch``-th submit answers the panel
    with the bfloat16 reference."""

    def __init__(self, m, max_batch: int):
        self.op = LowerPrecision(m)
        self.max_batch = max_batch
        self.pending: list = []

    def submit(self, key, x):
        fut: Future = Future()
        self.pending.append((fut, x.clone()))
        if len(self.pending) >= self.max_batch:
            Y = self.op(torch.stack([v for _, v in self.pending], dim=1))
            for i, (f, _) in enumerate(self.pending):
                f.set_result(Y[:, i].contiguous())
            self.pending = []
        return fut
