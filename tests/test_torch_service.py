"""Port vs reference: the register-once / query-many ``SpMVService``.

The service cases of ``tests/test_spmm.py`` (direct SpMM, the micro-batch
queue, ragged panels, flush failures, re-registration, eviction, deadlines,
the tuner), of ``tests/test_plan.py`` (plan minting, replay, mismatch, disk
round trips, impl overrides) and of ``tests/test_partition.py`` (the serve
path), run through ``repro_torch.serve.SpMVService`` on the CPU — where the
kernel tier runs each kernel's plain version — and, where the JAX
package's service answers the same question, held against it on the same
numpy inputs: products within 1e-5 (both sum in float32, in other orders),
a dense oracle within 1e-4, plan JSON key by key (floats to 1e-12).  Then
what torch tensors change: ``submit`` keeps its own copy of ``x``, a flush
hands each future its own tensor, and padded panels keep one SpMM
signature a matrix.  The ``transform.raise`` fault point degrades a
registration to the reference's own CSR plan.
"""
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import plan as RPL
from repro.core.kernel_tune import KernelTuner as RTuner
from repro.core.transform import csr_from_dense as r_csr_from_dense
from repro.serve import faults as ref_faults
from repro.serve.spmv_service import SpMVService as RService
from repro_torch import kernels as TK
from repro_torch.core.autotune import MachineModel, TuningDB
from repro_torch.core.kernel_tune import KernelTuner
from repro_torch.core.plan import ExecutionPlan, Planner
from repro_torch.core.policy import MemoryPolicy
from repro_torch.core.transform import TRANSFORMS_HOST, csr_from_dense
from repro_torch.kernels import ops as T_ops
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError
from repro_torch.serve import SpMVService, faults

TOL = dict(rtol=1e-4, atol=1e-4)          # against the dense oracle
REF_TOL = dict(rtol=1e-5, atol=1e-5)      # against the JAX package's service
BATCHES = (1, 3, 128)


def random_dense(rng, n_rows, n_cols, density):
    d = (rng.random((n_rows, n_cols)) < density).astype(np.float32)
    return d * rng.normal(1.0, 1.0, size=d.shape).astype(np.float32)


def both(dense, pad=8):
    return (r_csr_from_dense(dense, pad=pad),
            csr_from_dense(dense, pad=pad, device="cpu"))


def svc(**kw):
    return SpMVService(device="cpu", **kw)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a, np.float32)


def same_plan(a, b, path="plan"):
    """Plan JSON key by key; floats to 1e-12."""
    if isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12, nan_ok=True), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), \
            (path, sorted(a), sorted(b))
        for k in a:
            same_plan(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            same_plan(u, v, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def structure(plan_dict):
    """A hybrid plan without its launch geometry (the two tuners search
    different grids: TPU tiles against CUDA launches)."""
    d = json.loads(json.dumps(plan_dict))
    for b in d.get("blocks") or []:
        b["plan"]["geometry"] = {}
    return d


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


@pytest.fixture(autouse=True)
def clean_faults():
    faults.clear()
    ref_faults.clear()
    yield
    faults.clear()
    ref_faults.clear()


@pytest.fixture(scope="module")
def problem(rng):
    dense = random_dense(rng, 180, 140, 0.08)
    # a heavy tail so variance partitioning produces >1 block regime
    dense[:3, :] = rng.normal(size=(3, 140)).astype(np.float32)
    return (dense,) + both(dense)


def fake_timer(prefer_rows=32):
    calls = []

    def timer(thunk, g):
        thunk()
        calls.append(g)
        if g is None:
            return 1.0
        return 0.5 + abs((g.block_rows or prefer_rows) - prefer_rows) * 1e-3

    timer.calls = calls
    return timer


# ---------------------------------------------------------------------------
# tests/test_spmm.py: direct SpMM + the micro-batching queue
# ---------------------------------------------------------------------------
def test_service_spmm_and_microbatch_queue(rng):
    dense = random_dense(rng, 100, 80, 0.1)
    rm, tm = both(dense)
    t, r = svc(max_batch=4), RService(max_batch=4)
    for s, m in ((t, tm), (r, rm)):
        s.register("m", m, expected_iterations=200, batch=8)
    same_plan(t.entries["m"].plan.to_dict(), r.entries["m"].plan.to_dict())

    X = rng.normal(size=(80, 5)).astype(np.float32)
    Y = t.spmm("m", X)
    np.testing.assert_allclose(Y.numpy(), dense @ X, **TOL)
    np.testing.assert_allclose(Y.numpy(), f32(r.spmm("m", jnp.asarray(X))),
                               **REF_TOL)

    # 6 submits with max_batch=4: one auto-flush, then a ragged tail of 2
    futs = {n: [s.submit("m", X[:, i % 5]) for i in range(6)]
            for n, s in (("t", t), ("r", r))}
    assert t.pending_count("m") == r.pending_count("m") == 2
    assert t.flush("m") == r.flush("m") == 2
    for i, (ft, fr) in enumerate(zip(futs["t"], futs["r"])):
        np.testing.assert_allclose(ft.result().numpy(), dense @ X[:, i % 5],
                                   **TOL)
        np.testing.assert_allclose(ft.result().numpy(), f32(fr.result()),
                                   **REF_TOL)
    st, sr = t.stats()["m"], r.stats()["m"]
    assert st["n_spmm_calls"] == sr["n_spmm_calls"] == 3
    assert st["n_spmm_cols"] == sr["n_spmm_cols"] == 11
    assert st["pending"] == 0 and st["builds"] == 1
    assert st["formats"] == sr["formats"]
    assert set(sr) <= set(st)


def test_service_flush_all_and_empty(rng):
    dense = random_dense(rng, 40, 30, 0.2)
    _, m = both(dense)
    s = svc(max_batch=8)
    s.register("a", m, measure_baseline=False)
    s.register("b", m, measure_baseline=False)
    assert s.flush() == 0
    fa = s.submit("a", torch.ones(30))
    fb = s.submit("b", torch.ones(30))
    assert s.flush() == 2
    np.testing.assert_allclose(fa.result().numpy(),
                               dense @ np.ones(30, np.float32), **TOL)
    assert fb.done()


def _boom(m, x):
    raise RuntimeError("kernel failure")


def test_service_submit_rejects_bad_shape_and_flush_fails_whole_panel(rng):
    dense = random_dense(rng, 40, 30, 0.2)
    _, m = both(dense)
    # guard=False: with the degradation ladder on, a failing SpMM is
    # served by a fallback rung instead of raising (test_torch_guard.py);
    # this test pins the raw failure-propagation contract underneath it
    s = svc(max_batch=8, guard=False)
    s.register("m", m, measure_baseline=False)
    with pytest.raises(ValueError):
        s.submit("m", torch.ones(31))                  # wrong n_cols
    fut = s.submit("m", torch.ones(30))
    s.entries["m"].spmm_fn = _boom
    # a healthy second matrix must still be served by the same flush()
    dense2 = random_dense(rng, 40, 30, 0.2)
    s.register("ok", both(dense2)[1], measure_baseline=False)
    x2 = np.arange(30, dtype=np.float32)
    fut2 = s.submit("ok", x2)
    with pytest.raises(RuntimeError):
        s.flush()
    with pytest.raises(RuntimeError):
        fut.result(timeout=0)
    np.testing.assert_allclose(fut2.result(timeout=0).numpy(), dense2 @ x2,
                               **TOL)


def test_service_reregister_drains_pending_first(rng):
    dense = random_dense(rng, 40, 30, 0.2)
    _, m = both(dense)
    s = svc(max_batch=8)
    s.register("m", m, measure_baseline=False)
    x = np.arange(30, dtype=np.float32)
    fut = s.submit("m", x)
    s.register("m", m, measure_baseline=False)   # drains, then rebuilds
    np.testing.assert_allclose(fut.result(timeout=0).numpy(), dense @ x,
                               **TOL)
    assert s.stats()["m"]["builds"] == 2


def test_service_evict_releases_and_reregister_counts(rng):
    dense = random_dense(rng, 50, 50, 0.1)
    rm, tm = both(dense)
    s, r = svc(), RService()
    e1 = s.register("m", tm, measure_baseline=False)
    r.register("m", rm, measure_baseline=False)
    s.spmv("m", torch.ones(50))
    r.spmv("m", jnp.ones((50,), jnp.float32))
    assert s.stats()["m"]["compiled"] == r.stats()["m"]["compiled"] >= 1
    e2 = s.register("m", tm, measure_baseline=False)   # replaces e1
    assert e2 is not e1 and s.stats()["m"]["builds"] == 2
    # the stale entry's dispatchers are released
    with pytest.raises(RuntimeError):
        e1.fn(e1.matrix, torch.ones(50))
    fut = s.submit("m", torch.ones(50))
    s.evict("m")
    assert "m" not in s.entries
    with pytest.raises(KeyError):
        fut.result(timeout=0)


def test_service_deadline_flush_and_poll(rng):
    from repro_torch.obs import FakeClock

    dense = random_dense(rng, 40, 30, 0.2)
    _, m = both(dense)
    clk = FakeClock()
    s = svc(max_batch=64, deadline_ms=1.0, clock=clk)
    s.register("m", m, measure_baseline=False)
    x = np.arange(30, dtype=np.float32)
    f1 = s.submit("m", x)
    assert not f1.done()                      # queue far below max_batch
    clk.advance(0.005)                        # 5 ms > the 1 ms deadline
    f2 = s.submit("m", x)
    assert f1.done() and f2.done()
    np.testing.assert_allclose(f1.result(timeout=0).numpy(), dense @ x,
                               **TOL)
    f3 = s.submit("m", x)
    assert s.poll() == 0                      # not yet overdue
    clk.advance(0.0015)                       # now past the deadline
    assert s.poll() == 1 and f3.done()
    clk2 = FakeClock()
    s2 = svc(max_batch=64, clock=clk2)
    s2.register("m", m, measure_baseline=False)
    f4 = s2.submit("m", x)
    clk2.advance(0.005)
    s2.submit("m", x)
    assert s2.poll() == 0 and not f4.done()
    assert s2.flush("m") == 2


def test_service_register_with_tuner_serves_tuned_kernels(rng):
    def timer(thunk, g):
        thunk()
        return 1.0 if g is None else 0.5

    dense = random_dense(rng, 96, 64, 0.15)
    rm, tm = both(dense)
    s = svc(tuner=KernelTuner(timer=timer), max_batch=4)
    entry = s.register("m", tm, measure_baseline=False)
    st = s.stats()["m"]
    assert st["tuned"].get("spmv"), st  # a geometry won per block format
    assert entry.plan.tier == "kernel"
    # the blocks and their formats are the JAX package's; the geometry
    # each tuner picks comes from its own grid
    r = RService(tuner=RTuner(timer=lambda t, g: 1.0 if g is None else 0.5,
                              interpret=True), max_batch=4)
    rplan = r.register("m", rm, measure_baseline=False).plan
    same_plan(structure(entry.plan.to_dict()), structure(rplan.to_dict()))
    x = rng.normal(size=64).astype(np.float32)
    np.testing.assert_allclose(s.spmv("m", x).numpy(), dense @ x, **TOL)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(s.spmm("m", X).numpy(), dense @ X, **TOL)


def test_service_sell_blocks_carry_per_bucket_geometry(rng):
    """A sell block registered through the service is tuned per bucket:
    the bound geometry carries a width-keyed table, and queries serve
    through it."""
    def width_timer(thunk, g):
        thunk()
        return 1.0 if g is None else 0.5 - (g.block_rows or 0) * 1e-6

    dense = np.zeros((128, 96), np.float32)
    for r in range(16):
        dense[r, rng.choice(96, 50, replace=False)] = rng.normal(size=50)
    for r in range(16, 128):
        dense[r, rng.choice(96, 6, replace=False)] = rng.normal(size=6)
    _, m = both(dense)
    s = svc(tuner=KernelTuner(timer=width_timer), strategy="fixed",
            model=MachineModel(segment_penalty=1e4),
            policy=MemoryPolicy(budget_ratio=10.0))
    s.register("m", m, measure_baseline=False, formats=("sell",))
    st = s.stats()["m"]
    assert st["formats"] == {"sell": 1}, st["formats"]
    for op in ("spmv", "spmm"):
        tuned = st["tuned"][op].get("sell")
        assert tuned is not None and tuned.get("buckets"), (op, tuned)
    x = rng.normal(size=96).astype(np.float32)
    np.testing.assert_allclose(s.spmv("m", x).numpy(), dense @ x, **TOL)
    X = rng.normal(size=(96, 4)).astype(np.float32)
    np.testing.assert_allclose(s.spmm("m", X).numpy(), dense @ X, **TOL)


# ---------------------------------------------------------------------------
# tests/test_plan.py: plans minted and replayed by the service
# ---------------------------------------------------------------------------
def test_service_register_returns_plan_and_replays_it(problem, rng):
    dense, _, csr = problem
    timer = fake_timer()
    db = TuningDB(machine="svc", c=1.0, records=[], d_star={})
    s = svc(tuner=KernelTuner(db=db, timer=timer), max_batch=4)
    entry = s.register("a", csr, measure_baseline=False)
    assert entry.plan is not None and entry.plan.is_hybrid
    assert not entry.from_plan
    n_timed = len(timer.calls)
    assert n_timed > 0

    # save → load → register-with-plan: zero additional tuner timings
    plan = ExecutionPlan.from_json(entry.plan.to_json())
    entry2 = s.register("b", csr, plan=plan, measure_baseline=False)
    assert entry2.from_plan
    assert len(timer.calls) == n_timed, "register(plan=...) must skip tuning"
    assert entry2.matrix.formats == entry.matrix.formats
    assert entry2.tunings == entry.tunings
    x = rng.normal(size=140).astype(np.float32)
    np.testing.assert_allclose(s.spmv("b", x).numpy(), dense @ x, **TOL)
    X = rng.normal(size=(140, 4)).astype(np.float32)
    np.testing.assert_allclose(s.spmm("b", X).numpy(), dense @ X, **TOL)
    st = s.stats()
    assert st["b"]["plan"]["from_plan"] is True
    assert st["a"]["plan"]["from_plan"] is False
    assert st["b"]["plan"]["schema_version"] == 1


def test_service_mismatched_plan_falls_back(problem, rng):
    dense, _, csr = problem
    s = svc()
    entry = s.register("a", csr, measure_baseline=False)
    other_dense = random_dense(rng, 77, 140, 0.15)
    r_other, other = both(other_dense)
    entry2 = s.register("o", other, plan=entry.plan, measure_baseline=False)
    assert not entry2.from_plan        # rebuilt + re-decided
    r = RService()
    rentry = r.register("o", r_other, plan=RPL.ExecutionPlan.from_dict(
        entry.plan.to_dict()), measure_baseline=False)
    same_plan(entry2.plan.to_dict(), rentry.plan.to_dict())
    x = rng.normal(size=140).astype(np.float32)
    y = s.spmv("o", x).numpy()
    np.testing.assert_allclose(y, other_dense @ x, **TOL)
    np.testing.assert_allclose(y, f32(r.spmv("o", jnp.asarray(x))),
                               **REF_TOL)


def test_service_plan_roundtrips_through_disk(problem, rng, tmp_path):
    """Mint, save, reload 'in a fresh process' (fresh service +
    deserialized plan), bind, serve — the reference service's plan key by
    key, identical format decisions and dense-oracle parity for SpMV and
    SpMM."""
    dense, rcsr, csr = problem
    s = svc()
    entry = s.register("m", csr, measure_baseline=False)
    rentry = RService().register("m", rcsr, measure_baseline=False)
    same_plan(entry.plan.to_dict(), rentry.plan.to_dict())
    p = tmp_path / "svc_plan.json"
    entry.plan.save(str(p))

    fresh = svc()
    loaded = ExecutionPlan.load(str(p))
    entry2 = fresh.register("m", csr, plan=loaded, measure_baseline=False)
    assert entry2.from_plan
    assert entry2.matrix.formats == entry.matrix.formats
    # the JAX package replays the port's file too
    r = RService()
    assert r.register("m", rcsr, plan=RPL.ExecutionPlan.load(str(p)),
                      measure_baseline=False).from_plan
    x = rng.normal(size=140).astype(np.float32)
    y = fresh.spmv("m", x).numpy()
    np.testing.assert_allclose(y, dense @ x, **TOL)
    np.testing.assert_allclose(y, f32(r.spmv("m", jnp.asarray(x))),
                               **REF_TOL)
    for b in BATCHES[1:]:
        X = rng.normal(size=(140, b)).astype(np.float32)
        Y = fresh.spmm("m", X).numpy()
        np.testing.assert_allclose(Y, dense @ X, **TOL)
        np.testing.assert_allclose(Y, f32(r.spmm("m", jnp.asarray(X))),
                                   **REF_TOL)


def test_hybrid_bind_honors_impls_override(problem, rng):
    """A per-format impls override must be used even when the plan
    resolved to the hybrid container."""
    dense, _, csr = problem
    called = []

    def my_hybrid(m, x):
        called.append(True)
        from repro_torch.partition import spmv_hybrid
        return spmv_hybrid(m, x)

    plan = Planner(device="cpu").plan(csr, partition="variance",
                                      max_blocks=3, min_rows=16)
    P = plan.bind(csr, impls={"hybrid": my_hybrid}, device="cpu")
    x = rng.normal(size=140).astype(np.float32)
    y = P @ torch.from_numpy(x)
    assert called, "hybrid impls override was ignored"
    np.testing.assert_allclose(y.numpy(), dense @ x, **TOL)


def test_plan_replay_with_tuning_less_user_impl(problem, rng):
    """register(plan=) must not partial tuning= onto a user-supplied impl
    that does not accept it (bind_tunings signature guard)."""
    dense, _, csr = problem

    def plain_csr_impl(m, v):      # no tuning kwarg
        from repro_torch.core.spmv import spmv
        return spmv(m, v)

    def ft(thunk, g):
        thunk()
        return 1.0 if g is None else 0.6

    db = TuningDB(machine="m", c=1.0, records=[], d_star={})
    tuned = svc(tuner=KernelTuner(db=db, timer=ft), max_batch=4)
    plan = tuned.register("k", csr, measure_baseline=False).plan
    s = svc(impls={"csr": plain_csr_impl}, max_batch=4)
    entry = s.register("k", csr, plan=ExecutionPlan.from_json(plan.to_json()),
                       measure_baseline=False)
    assert entry.from_plan
    x = rng.normal(size=140).astype(np.float32)
    np.testing.assert_allclose(s.spmv("k", x).numpy(), dense @ x, **TOL)


# ---------------------------------------------------------------------------
# tests/test_partition.py: the serve path
# ---------------------------------------------------------------------------
def test_spmv_service(rng):
    dense = random_dense(rng, 200, 200, 0.05)
    rm, m = both(dense)
    s = svc()
    entry = s.register("m0", m, expected_iterations=500)
    assert entry.matrix.n_blocks >= 1
    r = RService()
    rentry = r.register("m0", rm, expected_iterations=500)
    assert entry.matrix.formats == rentry.matrix.formats
    x = rng.normal(size=200).astype(np.float32)
    for _ in range(3):
        y = s.spmv("m0", x)
    np.testing.assert_allclose(y.numpy(), dense @ x, **TOL)
    np.testing.assert_allclose(y.numpy(), f32(r.spmv("m0", jnp.asarray(x))),
                               **REF_TOL)
    st = s.stats()["m0"]
    assert st["n_calls"] == 3 and st["t_build_s"] > 0
    assert sum(st["formats"].values()) == st["n_blocks"]
    s.evict("m0")
    assert "m0" not in s.entries


# ---------------------------------------------------------------------------
# what torch tensors change: copies at submit and at flush
# ---------------------------------------------------------------------------
def test_submit_keeps_its_own_copy_of_x(rng):
    """torch tensors alias: a caller editing ``x`` after ``submit`` must
    not change its answer."""
    dense = random_dense(rng, 40, 30, 0.2)
    _, m = both(dense)
    s = svc(max_batch=8)
    s.register("m", m, measure_baseline=False)
    x = torch.arange(30, dtype=torch.float32)
    want = dense @ x.numpy()
    xn = np.arange(30, dtype=np.float32)
    f, fn = s.submit("m", x), s.submit("m", xn)
    x.mul_(-3.0)                     # edited in place after submit
    xn[:] = 0.0
    s.flush("m")
    np.testing.assert_allclose(f.result().numpy(), want, **TOL)
    np.testing.assert_allclose(fn.result().numpy(), want, **TOL)


def test_flush_hands_each_future_its_own_tensor(rng):
    """One client's in-place edit of its result must not change
    another's: each future holds its own tensor, not a view of the
    panel."""
    dense = random_dense(rng, 40, 30, 0.2)
    _, m = both(dense)
    for max_batch in (1, 4):
        s = svc(max_batch=max_batch)
        s.register("m", m, measure_baseline=False)
        xs = [np.full(30, i + 1, np.float32) for i in range(3)]
        futs = [s.submit("m", x) for x in xs]
        s.flush("m")
        ys = [f.result() for f in futs]
        ys[0].fill_(12345.0)
        for x, y in zip(xs[1:], ys[1:]):
            np.testing.assert_allclose(y.numpy(), dense @ x, **TOL)
            assert y.is_contiguous() and y.shape == (40,)
        assert len({y.data_ptr() for y in ys}) == 3


def test_padded_panels_keep_one_spmm_signature(rng):
    """``compile_count`` counts the input signatures a dispatcher served
    (what a jit cache holds): ragged panels padded to ``max_batch`` are
    one SpMM signature, as in the JAX package."""
    dense = random_dense(rng, 40, 30, 0.2)
    rm, m = both(dense)
    s, r = svc(max_batch=4), RService(max_batch=4)
    for srv, mat in ((s, m), (r, rm)):
        srv.register("m", mat, measure_baseline=False)
        for n in (4, 3, 1, 2):           # a full panel, then ragged ones
            for i in range(n):
                srv.submit("m", np.full(30, i, np.float32))
            srv.flush("m")
    assert s.stats()["m"]["compiled"] == r.stats()["m"]["compiled"] == 1
    assert s.entries["m"].spmm_fn.signatures == {((30, 4), "torch.float32")}


# ---------------------------------------------------------------------------
# the transform.raise fault point and the degraded registration
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", sorted(TRANSFORMS_HOST))
def test_transform_raise_fault_point_fires_in_each_host_transform(problem,
                                                                  fmt):
    """Every traced host conversion consults ``transform.raise``, as the
    JAX package's do; the CSR identity is not traced."""
    _, _, csr = problem
    with faults.inject("transform.raise", prob=1.0):
        if fmt == "csr":
            TRANSFORMS_HOST[fmt](csr)
        else:
            with pytest.raises(faults.InjectedFault):
                TRANSFORMS_HOST[fmt](csr)
    TRANSFORMS_HOST[fmt](csr)


def test_register_degrades_to_the_reference_csr_plan(problem, rng):
    dense, rcsr, csr = problem
    s, r = svc(), RService()
    with faults.inject("transform.raise", prob=1.0), \
            ref_faults.inject("transform.raise", prob=1.0):
        entry = s.register("m", csr, measure_baseline=False)
        rentry = r.register("m", rcsr, measure_baseline=False)
    assert entry.plan.rule == "degraded" and entry.plan.tier == "reference"
    assert entry.matrix.formats == rentry.matrix.formats == ("csr",)
    same_plan(entry.plan.to_dict(), rentry.plan.to_dict())
    x = rng.normal(size=140).astype(np.float32)
    np.testing.assert_allclose(s.spmv("m", x).numpy(), dense @ x, **TOL)


@pytest.mark.parametrize("where,err", [
    ("tune", KernelBuildError("nvcc refused csrc/csr_spmv.cu")),
    ("tune", KernelLaunchError("csr_spmv kernel launch failed: "
                               "cudaError 700")),
    ("prepare", KernelBuildError("nvcc refused csrc/ell_spmv.cu")),
    ("replay", KernelBuildError("nvcc refused csrc/ell_spmv.cu")),
])
def test_register_raises_when_a_kernel_does_not_build_or_launch(
        problem, monkeypatch, where, err):
    """Only the host transform degrades a registration.  A kernel that
    does not build or launch while the kernel tier is prepared
    (``kernels.ops.prepare``), tuned, or replayed from a kernel-tier plan
    raises to the caller: the key is not quietly served by a plain
    reference-CSR operator."""
    _, _, csr = problem

    def boom(*a, **k):
        raise err

    plan = None
    if where == "replay":
        plan = svc(tuner=KernelTuner(timer=fake_timer()), max_batch=4) \
            .register("m", csr, measure_baseline=False).plan
        assert plan.tier == "kernel"
    tuner = KernelTuner(timer=fake_timer())
    if where == "tune":
        monkeypatch.setattr(tuner, "tune", boom)
    else:
        monkeypatch.setattr(T_ops, "prepare", boom)
    s = svc(tuner=tuner, max_batch=4)
    with pytest.raises(type(err)) as ei:
        s.register("m", csr, measure_baseline=False, plan=plan)
    assert ei.value is err and "m" not in s.entries


# ---------------------------------------------------------------------------
# the kernel tier on the CPU
# ---------------------------------------------------------------------------
def test_kernel_tier_runs_plain_versions_on_the_cpu(problem, rng):
    """With a tuner, every block of every product goes through its
    format's kernel-tier wrapper; given CPU tensors each wrapper runs its
    kernel's plain version, so nothing is launched and the result is the
    reference tier's."""
    dense, _, csr = problem
    s = svc(tuner=KernelTuner(timer=fake_timer()), max_batch=4)
    entry = s.register("m", csr, measure_baseline=False)
    for fn in (entry.fn, entry.spmm_fn):
        for f in entry.matrix.formats:
            impl = fn.impls[f]
            base = impl.func if isinstance(impl, functools.partial) else impl
            assert base.__module__ == T_ops.__name__, (f, base)
    TK.reset_launch_counts()
    x = rng.normal(size=140).astype(np.float32)
    X = rng.normal(size=(140, 4)).astype(np.float32)
    y, Y = s.spmv("m", x), s.spmm("m", X)
    assert sum(TK.launch_counts().values()) == 0
    g = s.stats()["m"]["guard"]
    assert g["spmv"]["served_by"]["tuned"] == 1
    assert g["spmm"]["served_by"]["tuned"] == 1
    ref = svc(max_batch=4)
    ref.register("m", csr, measure_baseline=False)
    np.testing.assert_allclose(y.numpy(), ref.spmv("m", x).numpy(),
                               **REF_TOL)
    np.testing.assert_allclose(Y.numpy(), ref.spmm("m", X).numpy(),
                               **REF_TOL)
    np.testing.assert_allclose(Y.numpy(), dense @ X, **TOL)
