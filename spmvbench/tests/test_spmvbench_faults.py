"""``correct`` comes out false when the timed path is broken underneath
(the harness's look for a card skipped: the cells run on the CPU at a test
size), once for each fault a cell can have, and for the control, the
bfloat16 reference in the program's place.  One card, so no exchange
between cards to leave out."""
from __future__ import annotations

import time

import pytest
import torch

from repro_torch.core.plan import PlannedMatrix
from repro_torch.serve.spmv_service import SpMVService
from spmvbench import calibrate, harness

CPU = torch.device("cpu")
CELLS = ("hpcg256.cg50", "kron23.pr20", "hpcg128.rebind", "kron23.serve32")


def unchanged(x, y):
    """The product returns its input: the state is left as it was."""
    return x.clone()


def half_left_out(x, y):
    """Half the batch left out: the second half of a panel's columns, or
    of a vector's rows."""
    y = y.clone()
    if y.ndim == 2:
        y[:, y.shape[1] // 2:] = 0
    else:
        y[y.shape[0] // 2:] = 0
    return y


def altered(x, y):
    """One answer of every product altered where it is produced."""
    y = y.clone()
    k = int(torch.randint(y.shape[0], (1,)))
    y[k] += y.abs().max() + 1.0
    return y


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(tiny_root, monkeypatch, workload, fault):
    spmv = PlannedMatrix.spmv
    run_ = SpMVService._run
    monkeypatch.setattr(PlannedMatrix, "spmv",
                        lambda self, x: fault(x, spmv(self, x)))
    monkeypatch.setattr(
        SpMVService, "_run",
        lambda self, e, op, x: fault(x, run_(self, e, op, x)))
    r = harness.run(tiny_root, workload, 991, 0.2, False, CPU,
                    time.perf_counter(), log=lambda s: None)
    assert r is not None and not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny_root, workload):
    """The control's readings exceed the cell's limits on three seeds."""
    limits = harness.load_limits(tiny_root, workload)
    rows, _, plan = calibrate.readings(tiny_root, workload, [1, 2, 3], True,
                                       0.1, CPU)
    assert plan.startswith("control")
    for _, checks, units, failed in rows:
        assert units > 0 and failed == 0
        assert any(checks[k] > lim for k, lim in limits.items())


@pytest.mark.parametrize("workload", CELLS)
def test_program_readings_within_limits(tiny_root, workload):
    limits = harness.load_limits(tiny_root, workload)
    rows, _, _ = calibrate.readings(tiny_root, workload, [4, 5, 6], False,
                                    0.1, CPU)
    for _, checks, units, failed in rows:
        assert units > 0 and failed == 0
        assert all(checks[k] <= lim for k, lim in limits.items())
