"""Port vs reference: degrade-don't-die serving.

Mirrors ``tests/test_guard.py`` on ``repro_torch.serve``: the
fault-injection harness, the guarded degradation ladder and its circuit
breaker, admission control on the micro-batch queue, typed eviction, and
input validation — all deterministic (fault registry + the port's
FakeClock, no sleeps), on the CPU, where each kernel runs its plain
version.  The fault registry is a copy of the JAX package's, and its
seeded decisions are held against it.  All 35 of the reference's cases
are mirrored, ``test_sharded_dispatch_per_shard_guards`` among them (the
sharded tier's per-shard ladders); streaming and sharded registrations
serve, and the one refusal left — the multi-device ``shard_map`` mode —
names ROADMAP.md item A15b.
"""
import numpy as np
import pytest
import torch

import repro_torch.obs as obs
from repro.serve import faults as ref_faults
from repro_torch.obs import FakeClock, InMemorySink, Telemetry
from repro_torch.core.formats import CSR, MatrixValidationError
from repro_torch.core.plan import ExecutionPlan
from repro_torch.core.transform import csr_from_dense
from repro_torch.serve import faults
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError
from repro_torch.serve.guard import (CLOSED, HALF_OPEN, OPEN,
                                     CircuitBreaker, GuardError,
                                     guard_ladder, is_device_fault)
from repro_torch.serve.spmv_service import (AdmissionError, EvictedError,
                                            SpMVService)


def _svc(**kw):
    return SpMVService(device="cpu", **kw)


@pytest.fixture()
def tel():
    t = Telemetry(enabled=True, clock=FakeClock(), sinks=[InMemorySink()])
    prev = obs.set_default(t)
    yield t
    obs.set_default(prev)


@pytest.fixture(autouse=True)
def clean_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


@pytest.fixture(scope="module")
def problem(rng):
    d = (rng.random((80, 64)) < 0.15).astype(np.float32)
    dense = d * rng.normal(1.0, 1.0, size=d.shape).astype(np.float32)
    return dense, csr_from_dense(dense, pad=8, device="cpu")


# ---------------------------------------------------------------------------
# the fault registry
# ---------------------------------------------------------------------------
def test_fault_registry_arm_disarm():
    reg = faults.FaultRegistry()
    assert not reg.armed()
    reg.arm("kernel.raise", prob=1.0)
    assert reg.armed("kernel.raise") and reg.should_fire("kernel.raise")
    reg.disarm("kernel.raise")
    assert not reg.should_fire("kernel.raise")


def test_fault_registry_rejects_unknown_point_and_bad_prob():
    reg = faults.FaultRegistry()
    with pytest.raises(ValueError, match="unknown fault point"):
        reg.arm("kernel.explode")
    with pytest.raises(ValueError):
        reg.arm("kernel.raise", prob=1.5)


def test_fault_probability_is_seeded_and_deterministic():
    a = faults.FaultRegistry()
    b = faults.FaultRegistry()
    for reg in (a, b):
        reg.arm("kernel.raise", prob=0.5, seed=123)
    seq_a = [a.should_fire("kernel.raise") for _ in range(50)]
    seq_b = [b.should_fire("kernel.raise") for _ in range(50)]
    assert seq_a == seq_b
    assert any(seq_a) and not all(seq_a)
    # the same seed fires on the same calls as the JAX package's registry
    r = ref_faults.FaultRegistry()
    r.arm("kernel.raise", prob=0.5, seed=123)
    assert [r.should_fire("kernel.raise") for _ in range(50)] == seq_a
    assert faults.FAULT_POINTS == ref_faults.FAULT_POINTS
    assert faults.SKEW_S == ref_faults.SKEW_S


def test_arm_from_env_spec_parsing():
    reg = faults.FaultRegistry()
    reg.arm_from_env("kernel.nan:1.0:7,transform.raise")
    assert reg.armed("kernel.nan") and reg.armed("transform.raise")
    with pytest.raises(ValueError):
        faults.FaultRegistry().arm_from_env("not.a.point:1.0")


def test_inject_context_manager_restores():
    with faults.inject("kernel.raise", prob=1.0):
        assert faults.armed("kernel.raise")
        with pytest.raises(faults.InjectedFault):
            faults.maybe_raise("kernel.raise")
    assert not faults.armed("kernel.raise")


def test_clock_skew_point():
    assert faults.skew(1.0) == 1.0
    with faults.inject("clock.skew", prob=1.0):
        assert faults.skew(1.0) == 1.0 + faults.SKEW_S


# ---------------------------------------------------------------------------
# circuit breaker state machine (FakeClock, no sleeps)
# ---------------------------------------------------------------------------
def test_breaker_opens_after_consecutive_failures():
    clk = FakeClock()
    br = CircuitBreaker(failures=3, cooldown_s=10.0, clock=clk)
    assert br.state == CLOSED and br.allow()
    br.record_failure()
    br.record_failure()
    assert br.state == CLOSED          # 2 < 3
    br.record_failure()
    assert br.state == OPEN
    assert not br.allow()              # cooldown not elapsed


def test_breaker_success_resets_consecutive_count():
    br = CircuitBreaker(failures=3, clock=FakeClock())
    br.record_failure()
    br.record_failure()
    br.record_success()
    br.record_failure()
    br.record_failure()
    assert br.state == CLOSED          # never 3 in a row


def test_breaker_half_open_probe_closes_on_success():
    clk = FakeClock()
    br = CircuitBreaker(failures=1, cooldown_s=10.0, clock=clk)
    br.record_failure()
    assert br.state == OPEN
    clk.advance(10.0)
    assert br.allow()                  # the single probe
    assert br.state == HALF_OPEN
    assert not br.allow()              # no second probe while in flight
    br.record_success()
    assert br.state == CLOSED and br.allow()


def test_breaker_half_open_probe_failure_reopens():
    clk = FakeClock()
    br = CircuitBreaker(failures=1, cooldown_s=5.0, clock=clk)
    br.record_failure()
    clk.advance(5.0)
    assert br.allow()
    br.record_failure()                # probe failed
    assert br.state == OPEN
    assert not br.allow()              # cooldown restarted
    assert br.opens == 2


# ---------------------------------------------------------------------------
# the guarded ladder
# ---------------------------------------------------------------------------
def test_ladder_serves_top_rung_when_healthy():
    g = guard_ladder("k", "spmv",
                     [("tuned", lambda x: x + 1), ("csr", lambda x: x + 2)],
                     probe_finite=False)
    assert g(torch.zeros(3))[0] == 1
    assert g.snapshot()["served_by"] == {"tuned": 1, "csr": 0}


def test_ladder_demotes_on_exception():
    def boom(x):
        raise RuntimeError("broken kernel")
    g = guard_ladder("k", "spmv",
                     [("tuned", boom), ("csr", lambda x: x + 2)])
    y = g(torch.zeros(3))
    assert y[0] == 2
    snap = g.snapshot()
    assert snap["failures"] == {"tuned/exception": 1}
    assert snap["fallback_calls"] == 1


def test_ladder_demotes_on_non_finite_output():
    g = guard_ladder("k", "spmv",
                     [("tuned", lambda x: x * float("nan")),
                      ("csr", lambda x: x + 2)])
    assert g(torch.zeros(3))[0] == 2
    assert g.snapshot()["failures"] == {"tuned/non_finite": 1}


def test_last_rung_is_the_unprobed_oracle():
    # a non-finite final rung is served as-is: there is nothing below it
    g = guard_ladder("k", "spmv", [("csr", lambda x: x * float("nan"))])
    assert bool(torch.isnan(g(torch.ones(3)))[0])


def test_ladder_budget_demotes_slow_rung():
    clk = FakeClock(tick=1.0)          # every clock read advances 1s
    g = guard_ladder("k", "spmv",
                     [("tuned", lambda x: x + 1), ("csr", lambda x: x + 2)],
                     budget_s=0.5, probe_finite=False, clock=clk)
    assert g(torch.zeros(3))[0] == 2     # tuned "took" 1s > 0.5s budget
    assert g.snapshot()["failures"] == {"tuned/budget": 1}


def test_ladder_raises_guard_error_when_every_rung_fails():
    def boom(x):
        raise ValueError("nope")
    g = guard_ladder("k", "spmv", [("tuned", boom), ("csr", boom)])
    with pytest.raises(GuardError) as ei:
        g(torch.zeros(3))
    assert [r for r, _ in ei.value.causes] == ["tuned", "csr"]


_DEVICE_FAULTS = {
    "build": KernelBuildError("nvcc refused csrc/ell_spmv.cu"),
    "launch": KernelLaunchError("ell_spmv kernel launch failed: "
                                "cudaError 700"),
    "cuda_error": RuntimeError("CUDA error: an illegal memory access was "
                               "encountered"),
}


@pytest.mark.parametrize("rung", ["tuned", "reference"])
@pytest.mark.parametrize("kind", sorted(_DEVICE_FAULTS))
def test_device_faults_raise_instead_of_moving_down(kind, rung):
    """A kernel that does not build or launch, or a CUDA error, is raised
    from whatever rung meets it: the ladder never serves it around with a
    plain version, and it is not a rung failure the breaker counts."""
    err = _DEVICE_FAULTS[kind]
    assert is_device_fault(err)
    served = []

    def boom(x):
        raise err

    def tuned(x):
        if rung == "reference":
            raise ValueError("an ordinary tuned-rung failure")
        raise err

    g = guard_ladder("k", "spmv",
                     [("tuned", tuned),
                      ("reference", boom if rung == "reference"
                       else lambda x: served.append(x) or x),
                      ("csr", lambda x: served.append(x) or x)])
    with pytest.raises(type(err)) as ei:
        g(torch.zeros(3))
    assert ei.value is err and not served
    snap = g.snapshot()
    assert snap["fallback_calls"] == 0
    assert snap["served_by"] == {"tuned": 0, "reference": 0, "csr": 0}
    assert "reference/exception" not in snap["failures"]


def test_ordinary_errors_are_not_device_faults():
    for e in (RuntimeError("broken kernel"), ValueError("CUDA error"),
              faults.InjectedFault("kernel.raise"), MemoryError()):
        assert not is_device_fault(e)


def test_open_breaker_short_circuits_the_top_rung():
    calls = {"tuned": 0}

    def tuned(x):
        calls["tuned"] += 1
        raise RuntimeError("still broken")

    clk = FakeClock()
    br = CircuitBreaker(failures=2, cooldown_s=30.0, clock=clk)
    g = guard_ladder("k", "spmv",
                     [("tuned", tuned), ("csr", lambda x: x)],
                     breaker=br)
    for _ in range(5):
        g(torch.ones(3))
    # rung 0 ran only until the breaker opened
    assert calls["tuned"] == 2
    assert g.snapshot()["short_circuits"] == 3
    assert g.snapshot()["breaker"]["state"] == OPEN


# ---------------------------------------------------------------------------
# chaos invariants through the service: faults at probability 1.0 never
# change served results
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("point", ["kernel.raise", "kernel.nan"])
def test_service_results_survive_kernel_faults(problem, rng, point, tel):
    dense, csr = problem
    svc = _svc(max_batch=4)
    svc.register("m", csr, measure_baseline=False)
    x = rng.normal(size=64).astype(np.float32)
    X = rng.normal(size=(64, 3)).astype(np.float32)
    with faults.inject(point, prob=1.0, seed=0):
        y = svc.spmv("m", x)
        Y = svc.spmm("m", X)
        f = svc.submit("m", x)
        svc.flush("m")
    np.testing.assert_allclose(y.numpy(), dense @ x,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(Y.numpy(), dense @ X,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f.result().numpy(), dense @ x,
                               rtol=2e-4, atol=2e-4)
    g = svc.stats()["m"]["guard"]["spmv"]
    assert g["served_by"]["reference"] >= 1
    fb = {k: v for k, v in tel.snapshot()["counters"].items()
          if k.startswith("service.fallback")}
    assert fb and sum(fb.values()) >= 3


def test_breaker_opens_in_stats_and_probe_restores_tuned_tier(problem, rng):
    dense, csr = problem
    clk = FakeClock()
    svc = _svc(clock=clk, breaker_failures=2,
                      breaker_cooldown_s=10.0, max_batch=4)
    svc.register("m", csr, measure_baseline=False)
    x = rng.normal(size=64).astype(np.float32)

    with faults.inject("kernel.raise", prob=1.0):
        for _ in range(3):
            np.testing.assert_allclose(svc.spmv("m", x).numpy(),
                                       dense @ x, rtol=2e-4, atol=2e-4)
    g = svc.stats()["m"]["guard"]["spmv"]
    assert g["breaker"]["state"] == OPEN
    assert g["short_circuits"] == 1    # third call skipped the tuned rung

    # faults cleared but the breaker is still cooling: served degraded,
    # no tuned attempts
    tuned_before = g["served_by"]["tuned"]
    np.testing.assert_allclose(svc.spmv("m", x).numpy(), dense @ x,
                               rtol=2e-4, atol=2e-4)
    g = svc.stats()["m"]["guard"]["spmv"]
    assert g["served_by"]["tuned"] == tuned_before
    assert g["breaker"]["state"] == OPEN

    # past the cooldown the half-open probe runs clean and restores tuned
    clk.advance(10.0)
    np.testing.assert_allclose(svc.spmv("m", x).numpy(), dense @ x,
                               rtol=2e-4, atol=2e-4)
    g = svc.stats()["m"]["guard"]["spmv"]
    assert g["breaker"]["state"] == CLOSED
    assert g["served_by"]["tuned"] == tuned_before + 1


def test_register_degrades_to_csr_when_transform_faults(problem, rng, tel):
    dense, csr = problem
    svc = _svc()
    with faults.inject("transform.raise", prob=1.0):
        entry = svc.register("m", csr, measure_baseline=False)
    assert entry.plan is not None and entry.plan.rule == "degraded"
    assert entry.matrix.formats == ("csr",)
    x = rng.normal(size=64).astype(np.float32)
    np.testing.assert_allclose(svc.spmv("m", x).numpy(), dense @ x,
                               rtol=2e-4, atol=2e-4)
    fb = [k for k in tel.snapshot()["counters"]
          if k.startswith("service.fallback") and "op=register" in k]
    assert fb


def test_sharded_and_streaming_registration_name_their_items(problem, rng):
    """A sharded plan and a streaming registration both serve (through
    the sharded tier's and the streaming tier's ladders); the one refusal
    left, an explicit multi-device ``shard_map``, names A15b."""
    from repro_torch.core.plan import Planner
    from repro_torch.stream import random_delta
    dense, csr = problem
    svc = _svc()
    plan = Planner(device="cpu").plan_sharded(csr, n_shards=2)
    entry = svc.register("s", csr, plan=plan, measure_baseline=False)
    assert entry.matrix.mode == "dispatch" and entry.from_plan
    x = rng.normal(size=64).astype(np.float32)
    np.testing.assert_allclose(svc.spmv("s", x).numpy(), dense @ x,
                               rtol=2e-4, atol=2e-4)
    assert svc.stats()["s"]["guard"]["spmv"]["served_by"]["tuned"] == 1
    with pytest.raises(NotImplementedError, match="A15b"):
        svc.register("t", csr, plan=plan, measure_baseline=False,
                     mode="shard_map", devices=["cpu", "cpu"])
    # a delta edits the registered tensors in place (as the reference's
    # numpy arrays are): the module's matrix stays untouched on a copy
    mine = CSR(data=csr.data.clone(), cols=csr.cols.clone(),
               indptr=csr.indptr.clone(), shape=csr.shape, nnz=csr.nnz)
    svc.register("m", mine, measure_baseline=False, streaming=True,
                 plan=Planner(device="cpu").plan(mine, fmt="csr"))
    res = svc.apply_delta("m", random_delta(np.random.default_rng(3), mine,
                                            n_updates=4, n_deletes=2))
    assert not res.fallback
    src = svc.entries["m"].source
    np.testing.assert_allclose(svc.spmv("m", x).numpy(), src.todense() @ x,
                               rtol=2e-4, atol=2e-4)
    assert svc.stats()["m"]["streaming"]["deltas"] == 1


def test_sharded_dispatch_per_shard_guards(problem, rng):
    dense, csr = problem
    from repro_torch.sharding.spmv import build_sharded
    spm = build_sharded(csr, n_shards=2, mode="dispatch", device="cpu")
    assert len(spm.shard_guards) == 2
    x = rng.normal(size=64).astype(np.float32)
    with faults.inject("kernel.raise", prob=1.0):
        y = spm.spmv(x)
    np.testing.assert_allclose(y.numpy(), dense @ x, rtol=2e-4, atol=2e-4)
    for shard in spm.guard_report():
        assert shard["spmv"]["served_by"]["csr"] == 1


def test_guard_off_switch_serves_raw(problem, rng):
    dense, csr = problem
    svc = _svc(guard=False)
    svc.register("m", csr, measure_baseline=False)
    assert svc.stats()["m"]["guard"] == {}
    with faults.inject("kernel.raise", prob=1.0):
        # no ladder: the fault point is only threaded through guards, so
        # the raw path serves normally
        x = rng.normal(size=64).astype(np.float32)
        np.testing.assert_allclose(svc.spmv("m", x).numpy(), dense @ x,
                                   rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------
def test_admission_reject_bounds_queue_depth(problem, rng):
    dense, csr = problem
    svc = _svc(max_batch=16, max_queue=2, admission="reject")
    svc.register("m", csr, measure_baseline=False)
    x = rng.normal(size=64).astype(np.float32)
    f1, f2 = svc.submit("m", x), svc.submit("m", x)
    with pytest.raises(AdmissionError):
        svc.submit("m", x)
    assert svc.pending_count("m") == 2
    svc.flush("m")
    for f in (f1, f2):
        np.testing.assert_allclose(f.result().numpy(), dense @ x,
                                   rtol=2e-4, atol=2e-4)


def test_admission_shed_oldest_fails_the_oldest_future(problem, rng):
    dense, csr = problem
    svc = _svc(max_batch=16, max_queue=2, admission="shed_oldest")
    svc.register("m", csr, measure_baseline=False)
    x = rng.normal(size=64).astype(np.float32)
    f1, f2 = svc.submit("m", x), svc.submit("m", x)
    f3 = svc.submit("m", x)            # sheds f1, enqueues f3
    with pytest.raises(AdmissionError):
        f1.result(timeout=0)
    assert svc.pending_count("m") == 2
    assert svc.stats()["m"]["shed"] == 1
    svc.flush("m")
    for f in (f2, f3):
        np.testing.assert_allclose(f.result().numpy(), dense @ x,
                                   rtol=2e-4, atol=2e-4)


def test_admission_block_flushes_to_make_room(problem, rng):
    dense, csr = problem
    svc = _svc(max_batch=16, max_queue=2, admission="block")
    svc.register("m", csr, measure_baseline=False)
    x = rng.normal(size=64).astype(np.float32)
    f1, f2 = svc.submit("m", x), svc.submit("m", x)
    f3 = svc.submit("m", x)            # flushes f1+f2 synchronously
    assert f1.done() and f2.done()
    assert svc.pending_count("m") == 1
    svc.flush("m")
    for f in (f1, f2, f3):
        np.testing.assert_allclose(f.result().numpy(), dense @ x,
                                   rtol=2e-4, atol=2e-4)


def test_admission_deadline_rejects_predicted_late_requests(problem, rng):
    _, csr = problem
    svc = _svc(max_batch=4, deadline_ms=5.0, clock=FakeClock())
    entry = svc.register("m", csr, measure_baseline=False)
    entry.flush_ema_s = 0.010          # recent flushes took 10ms > 5ms
    x = rng.normal(size=64).astype(np.float32)
    with pytest.raises(AdmissionError, match="predicted wait"):
        svc.submit("m", x)
    assert svc.pending_count("m") == 0


def test_eviction_fails_outstanding_futures_typed(problem, rng):
    _, csr = problem
    svc = _svc(max_batch=16)
    svc.register("m", csr, measure_baseline=False)
    x = rng.normal(size=64).astype(np.float32)
    f = svc.submit("m", x)
    svc.evict("m")
    with pytest.raises(EvictedError):
        f.result(timeout=0)
    # typed, but still a KeyError for callers that treated it as one
    assert issubclass(EvictedError, KeyError)
    with pytest.raises(KeyError):
        svc.submit("m", x)


def test_reregister_keeps_serving_queued_vectors(problem, rng):
    dense, csr = problem
    svc = _svc(max_batch=16)
    svc.register("m", csr, measure_baseline=False)
    x = rng.normal(size=64).astype(np.float32)
    f = svc.submit("m", x)
    svc.register("m", csr, measure_baseline=False)   # replaces the entry
    np.testing.assert_allclose(f.result(timeout=0).numpy(), dense @ x,
                               rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# input validation
# ---------------------------------------------------------------------------
def _bad_csr(problem, **patch):
    _, good = problem
    kw = dict(data=good.data.clone(), cols=good.cols.clone(),
              indptr=good.indptr.clone(), shape=good.shape, nnz=good.nnz)
    kw.update(patch)
    return CSR(**kw)


def test_validate_accepts_well_formed(problem):
    _, csr = problem
    assert csr.validate() is csr


def test_validate_rejects_nonmonotone_indptr(problem):
    bad_ip = problem[1].indptr.clone()
    bad_ip[3], bad_ip[4] = int(bad_ip[4]), int(bad_ip[3]) + 1
    with pytest.raises(MatrixValidationError, match="monoton"):
        _bad_csr(problem, indptr=bad_ip).validate()


def test_validate_rejects_wrong_first_and_last_indptr(problem):
    ip = problem[1].indptr.clone()
    ip[0] = 1
    with pytest.raises(MatrixValidationError):
        _bad_csr(problem, indptr=ip).validate()
    ip2 = problem[1].indptr.clone()
    ip2[-1] = problem[1].nnz + 3
    with pytest.raises(MatrixValidationError):
        _bad_csr(problem, indptr=ip2).validate()


def test_validate_rejects_out_of_range_and_float_indices(problem):
    cols = problem[1].cols.clone()
    cols[0] = problem[1].n_cols + 5
    with pytest.raises(MatrixValidationError, match="range"):
        _bad_csr(problem, cols=cols).validate()
    with pytest.raises(MatrixValidationError, match="dtype"):
        _bad_csr(problem,
                 indptr=problem[1].indptr.float()).validate()


def test_service_register_rejects_malformed_matrix(problem):
    bad_ip = problem[1].indptr.clone()
    bad_ip[0] = 2
    bad = _bad_csr(problem, indptr=bad_ip)
    svc = _svc()
    with pytest.raises(MatrixValidationError):
        svc.register("m", bad)
    assert "m" not in svc.entries


def test_plan_bind_rejects_malformed_matrix(problem):
    _, csr = problem
    plan = ExecutionPlan(fmt="csr")
    cols = csr.cols.clone()
    if csr.nnz:
        cols[0] = -2
    bad = _bad_csr(problem, cols=cols)
    with pytest.raises(MatrixValidationError):
        plan.bind(bad, device="cpu")


def test_swallowed_errors_are_counted(problem, tel):
    _, csr = problem
    svc = _svc()
    entry = svc.register("m", csr, measure_baseline=False)
    svc.evict("m")
    entry.compile_count()              # evicted stubs record no signature
    swallowed = [k for k in tel.snapshot()["counters"]
                 if k.startswith("service.swallowed_errors")]
    assert swallowed
