"""Port vs reference: the sharded SpMV/SpMM tier on one device.

Every case of ``tests/test_sharded_spmv.py`` but its two 8-device
subprocess cases (the multi-rank ``shard_map`` executor:
``test_torch_shard_map.py``) runs through ``repro_torch.sharding`` and ``repro_torch.core.plan``
on the CPU beside the JAX package on the same numpy matrix: device-count
partitioning (the same boundaries), column slabs and ``shard_csr`` (the
same slabs, field by field), ``dispatch`` mode on every axis and strategy
(products within 2e-4 of the dense oracle and 1e-5 of the reference's),
``auto`` and ``single``, the ``ShardedPlan`` artifact (JSON key by key,
written by either package and loaded in the other; future schemas
refused; a mismatched matrix re-partitioned), telemetry, and the
service's sharded registration, plan cache and batch seeding.  An explicit
``shard_map`` in one process raises the reference's ``PlanError`` (one
process is one rank: fewer ranks than shards); the multi-rank executor is
held in ``test_torch_shard_map.py``.  The per-shard guards are held in
``test_torch_guard.py``.
"""
import json

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import plan as RPL
from repro.core.transform import csr_from_dense as r_csr_from_dense
from repro.partition import partition_for_devices as r_partition_for_devices
from repro.partition import slice_csr_cols as r_slice_csr_cols
from repro.serve.spmv_service import SpMVService as RService
from repro.sharding import build_sharded as r_build_sharded
from repro.sharding import shard_csr as r_shard_csr

import repro_torch
from repro_torch import obs
from repro_torch.core.autotune import TuningDB
from repro_torch.core.formats import to_numpy
from repro_torch.core.kernel_tune import KernelTuner
from repro_torch.core.plan import (SHARDED_SCHEMA_VERSION, PlanError,
                                   PlannedMatrix, PlanSchemaError, Planner,
                                   ShardedPlan)
from repro_torch.core.transform import csr_from_dense
from repro_torch.obs import FakeClock, InMemorySink, Telemetry
from repro_torch.partition import partition_for_devices, slice_csr_cols
from repro_torch.serve import SpMVService
from repro_torch.sharding import ShardedPlannedMatrix, build_sharded, shard_csr

STRATEGIES = ("fixed", "balanced_nnz", "variance")
#: a product against the dense oracle
TOL = dict(rtol=2e-4, atol=2e-4)
#: the port's product against the reference's on the same matrix
REF_TOL = dict(rtol=1e-5, atol=1e-5)


def random_dense(rng, n_rows, n_cols, density):
    d = (rng.random((n_rows, n_cols)) < density).astype(np.float32)
    return d * rng.normal(1.0, 1.0, size=d.shape).astype(np.float32)


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


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


@pytest.fixture(scope="module")
def problem(rng):
    dense = random_dense(rng, 220, 180, 0.06)
    dense[:4, :] = rng.normal(size=(4, 180)).astype(np.float32)  # heavy tail
    return (dense, csr_from_dense(dense, pad=8, device="cpu"),
            r_csr_from_dense(dense, pad=8))


def same_csr(r, t, path="csr"):
    name, arrs, meta = to_numpy(t)
    assert name == "csr" and tuple(meta["shape"]) == tuple(r.shape), path
    assert meta["nnz"] == r.nnz, path
    for f in ("data", "cols", "indptr"):
        np.testing.assert_array_equal(np.asarray(getattr(r, f)), arrs[f],
                                      err_msg=f"{path}.{f}")


def same_dict(a, b, path="plan"):
    """JSON-shaped values key by key; floats to 1e-12."""
    if isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12, nan_ok=True), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), \
            (path, sorted(a), sorted(b))
        for k in a:
            same_dict(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            same_dict(u, v, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def assert_parity(spm, dense, rng, batches=(1, 8), ref=None):
    for b in batches:
        x = rng.normal(size=dense.shape[1] if b == 1
                       else (dense.shape[1], b)).astype(np.float32)
        y = (spm @ x).numpy()
        np.testing.assert_allclose(y, dense @ x, **TOL)
        if ref is not None:
            np.testing.assert_allclose(y, np.asarray(ref @ x), **REF_TOL)


# ---------------------------------------------------------------------------
# partitioning at device-count granularity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("n_dev", (1, 3, 8))
def test_partition_for_devices_exact_count(problem, strategy, n_dev):
    _, csr, _ = problem
    lens = csr.row_lengths()
    b = partition_for_devices(lens, n_dev, strategy=strategy)
    assert b.shape[0] == n_dev + 1
    assert b[0] == 0 and b[-1] == lens.shape[0]
    assert np.all(np.diff(b) > 0)
    np.testing.assert_array_equal(
        b, r_partition_for_devices(lens, n_dev, strategy=strategy))


def test_partition_for_devices_rejects_bad_counts(problem):
    _, csr, _ = problem
    lens = csr.row_lengths()
    with pytest.raises(ValueError):
        partition_for_devices(lens, 0)
    with pytest.raises(ValueError):
        partition_for_devices(lens, lens.shape[0] + 1)
    with pytest.raises(KeyError):
        partition_for_devices(lens, 2, strategy="nope")


def test_partition_for_devices_skewed_splits():
    # one row holds almost all the nnz: balanced_nnz must still cut 4 slabs
    lens = np.ones(64, dtype=np.int64)
    lens[0] = 10_000
    b = partition_for_devices(lens, 4, strategy="balanced_nnz")
    assert b.shape[0] == 5 and np.all(np.diff(b) > 0)
    np.testing.assert_array_equal(
        b, r_partition_for_devices(lens, 4, strategy="balanced_nnz"))


def test_slice_csr_cols_matches_dense(problem):
    dense, csr, rcsr = problem
    sub = slice_csr_cols(csr, 40, 120)
    assert sub.shape == (dense.shape[0], 80)
    np.testing.assert_array_equal(sub.todense(), dense[:, 40:120])
    same_csr(r_slice_csr_cols(rcsr, 40, 120), sub)


@pytest.mark.parametrize("axis", ("row", "col"))
def test_shard_csr_covers_matrix(problem, axis):
    dense, csr, rcsr = problem
    b, subs = shard_csr(csr, 4, axis=axis)
    rb, rsubs = r_shard_csr(rcsr, 4, axis=axis)
    np.testing.assert_array_equal(b, rb)
    assert len(subs) == 4 and sum(m.nnz for m in subs) == csr.nnz
    assert b[-1] == dense.shape[0 if axis == "row" else 1]
    for i, (r, t) in enumerate(zip(rsubs, subs)):
        same_csr(r, t, f"slab {i}")
    if axis == "row":
        np.testing.assert_array_equal(
            np.concatenate([m.todense() for m in subs]), dense)


# ---------------------------------------------------------------------------
# dispatch mode (one device, many shards)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", ("row", "col"))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_dispatch_mode_parity(problem, rng, axis, strategy):
    dense, csr, rcsr = problem
    spm = build_sharded(csr, n_shards=4, axis=axis, strategy=strategy,
                        mode="dispatch", device="cpu")
    ref = r_build_sharded(rcsr, n_shards=4, axis=axis, strategy=strategy,
                          mode="dispatch")
    assert spm.mode == "dispatch" and spm.n_shards == 4
    np.testing.assert_array_equal(spm.boundaries, ref.boundaries)
    assert spm.plan.shard_formats() == ref.plan.shard_formats()
    assert spm.report() == ref.report()
    assert_parity(spm, dense, rng, ref=ref)
    assert len(spm.guard_report()) == 4


def test_auto_mode_falls_back_to_dispatch_on_one_device(problem, rng):
    dense, csr, _ = problem
    spm = build_sharded(csr, n_shards=4, device="cpu")
    assert spm.mode == "dispatch"
    assert spm.devices == [torch.device("cpu")] * 4
    assert_parity(spm, dense, rng, batches=(1,))


def test_single_shard_degenerates_to_planned_matrix(problem, rng):
    dense, csr, _ = problem
    spm = build_sharded(csr, n_shards=1, device="cpu")
    assert spm.mode == "single" and spm.n_shards == 1
    assert isinstance(spm.planned[0], PlannedMatrix)
    assert spm.shard_guards == []
    assert_parity(spm, dense, rng)


def test_single_mode_refuses_a_plan_of_many_shards(problem, rng):
    """A reference quirk the port does not keep: ``mode="single"`` with
    4 shards serves shard 0's slab alone there (a product of shard 0's
    rows); the port refuses the bind."""
    dense, csr, rcsr = problem
    ref = r_build_sharded(rcsr, n_shards=4, mode="single")
    x = rng.normal(size=dense.shape[1]).astype(np.float32)
    assert np.asarray(ref @ x).shape[0] == int(ref.boundaries[1]) \
        < dense.shape[0]
    with pytest.raises(PlanError, match="single"):
        build_sharded(csr, n_shards=4, mode="single", device="cpu")


def test_shard_map_mode_requires_devices(problem):
    _, csr, rcsr = problem
    with pytest.raises(PlanError, match="needs >= 4 devices") as te:
        build_sharded(csr, n_shards=4, mode="shard_map", device="cpu")
    with pytest.raises(RPL.PlanError, match="needs >= 4 devices"):
        r_build_sharded(rcsr, n_shards=4, mode="shard_map")
    assert "have 1" in str(te.value)
    # one process is one rank: devices= picks the rank's device, it adds
    # no ranks (the multi-rank executor: test_torch_shard_map.py)
    with pytest.raises(PlanError, match="needs >= 2 devices.*have 1"):
        build_sharded(csr, n_shards=2, mode="shard_map",
                      devices=["cpu", "cpu"])
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_sharded(csr, n_shards=2, mode="shard_map", device="cpu",
                      mesh=object())
    with pytest.raises(PlanError, match="unknown mode"):
        build_sharded(csr, n_shards=2, mode="nope", device="cpu")


# ---------------------------------------------------------------------------
# the ShardedPlan artifact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("axis", ("row", "col"))
def test_sharded_plan_roundtrip(problem, rng, tmp_path, axis):
    dense, csr, rcsr = problem
    plan = Planner(device="cpu").plan_sharded(
        csr, n_shards=4, axis=axis, strategy="balanced_nnz")
    rplan = RPL.Planner().plan_sharded(rcsr, n_shards=4, axis=axis,
                                       strategy="balanced_nnz")
    same_dict(rplan.to_dict(), plan.to_dict())
    assert plan.n_shards == 4
    assert plan.schema_version == SHARDED_SCHEMA_VERSION
    assert plan.boundaries()[-1] == dense.shape[0 if axis == "row" else 1]
    p = tmp_path / "sharded.json"
    plan.save(str(p))
    plan2 = ShardedPlan.load(str(p))
    assert plan2.to_dict() == plan.to_dict()
    assert plan2.shard_formats() == plan.shard_formats()
    assert plan2.matches(csr)
    # either package's file loads in the other
    assert RPL.ShardedPlan.load(str(p)).to_dict() == plan.to_dict()
    rp = tmp_path / "ref.json"
    rplan.save(str(rp))
    from_ref = ShardedPlan.load(str(rp))
    assert from_ref.to_dict() == rplan.to_dict()
    for spm in (plan2.bind(csr, mode="dispatch", device="cpu"),
                from_ref.bind(csr, mode="dispatch", device="cpu")):
        assert spm.fingerprint_matched
        assert_parity(spm, dense, rng)


def test_sharded_plan_rejects_future_schema(problem):
    _, csr, _ = problem
    plan = Planner(device="cpu").plan_sharded(csr, n_shards=2)
    d = plan.to_dict()
    d["schema_version"] = SHARDED_SCHEMA_VERSION + 1
    with pytest.raises(PlanSchemaError):
        ShardedPlan.from_dict(d)
    with pytest.raises(PlanError):
        ShardedPlan.from_json("not json{")
    with pytest.raises(PlanError):
        ShardedPlan(shards=[], axis="row")
    with pytest.raises(PlanError, match="axis"):
        ShardedPlan(shards=plan.shards, axis="diag")
    with pytest.raises(PlanError, match="malformed"):
        ShardedPlan.from_dict({"schema_version": SHARDED_SCHEMA_VERSION})


def test_sharded_plan_mismatch_rebinds(problem, rng):
    _, csr, _ = problem
    plan = Planner(device="cpu").plan_sharded(csr, n_shards=4, axis="row")
    other = random_dense(rng, 150, 150, 0.1)
    csr2 = csr_from_dense(other, pad=8, device="cpu")
    spm = plan.bind(csr2, mode="dispatch", device="cpu")
    assert not spm.fingerprint_matched
    # the recipe survives: same shard count, recomputed slabs on the new
    # matrix's row space
    assert spm.n_shards == 4
    assert spm.boundaries[-1] == 150
    assert [r["rows"][1] for r in spm.report()][-1] == 150
    x = rng.normal(size=150).astype(np.float32)
    np.testing.assert_allclose((spm @ x).numpy(), other @ x, **TOL)


def test_col_axis_plan_partitions_column_space(problem):
    dense, csr, _ = problem
    plan = Planner(device="cpu").plan_sharded(csr, n_shards=3, axis="col")
    assert plan.axis == "col"
    assert plan.boundaries()[-1] == dense.shape[1]


def test_sharded_telemetry_spans_and_gauge(problem, rng):
    dense, csr, _ = problem
    sink = InMemorySink()
    prev = obs.set_default(Telemetry(enabled=True, clock=FakeClock(),
                                     sinks=[sink]))
    try:
        spm = build_sharded(csr, n_shards=4, axis="col", mode="dispatch",
                            device="cpu")
        x = rng.normal(size=dense.shape[1]).astype(np.float32)
        spm @ x
        tel = obs.get()
        gauges = {name: m.value for kind, name, labels, m in tel.metrics()
                  if kind == "gauge"}
        assert gauges.get("sharded.load_imbalance", 0) >= 1.0
        names = {r["name"] for r in sink.spans()}
        assert {"plan.plan_sharded", "sharded.bind", "sharded.spmv",
                "shard.spmv", "shard.gather"} <= names
    finally:
        obs.set_default(prev)


# ---------------------------------------------------------------------------
# public exports
# ---------------------------------------------------------------------------
def test_sharding_exports_the_executor():
    import repro_torch.sharding as sh
    for name in ("ShardedPlannedMatrix", "build_sharded", "shard_csr"):
        assert name in sh.__all__ and hasattr(sh, name), name


def test_api_exports_sharding_surface():
    from repro_torch import api
    for name in ("ShardedPlan", "ShardedPlannedMatrix", "build_sharded",
                 "SHARDED_SCHEMA_VERSION", "shard_csr"):
        assert name in api.__all__ and hasattr(api, name), name
    assert repro_torch.ShardedPlan is ShardedPlan
    assert repro_torch.ShardedPlannedMatrix is ShardedPlannedMatrix


# ---------------------------------------------------------------------------
# service integration: sharded registration, plan cache, batch seeding
# ---------------------------------------------------------------------------
def test_service_registers_sharded_plan(problem, rng):
    dense, csr, rcsr = problem
    svc, rsvc = SpMVService(device="cpu"), RService()
    plan = Planner(device="cpu").plan_sharded(csr, n_shards=4, axis="row")
    entry = svc.register("g", csr, plan=plan, measure_baseline=False,
                         mode="dispatch")
    rsvc.register("g", rcsr, plan=RPL.ShardedPlan.from_json(plan.to_json()),
                  measure_baseline=False, mode="dispatch")
    assert entry.from_plan
    assert isinstance(entry.matrix, ShardedPlannedMatrix)
    x = rng.normal(size=dense.shape[1]).astype(np.float32)
    y = svc.spmv("g", x).numpy()
    np.testing.assert_allclose(y, dense @ x, **TOL)
    np.testing.assert_allclose(y, np.asarray(rsvc.spmv("g", x)), **REF_TOL)
    X = rng.normal(size=(dense.shape[1], 4)).astype(np.float32)
    np.testing.assert_allclose(svc.spmm("g", X).numpy(), dense @ X, **TOL)
    fut = svc.submit("g", x)
    svc.flush()
    np.testing.assert_allclose(fut.result().numpy(), dense @ x, **TOL)
    st, rst = svc.stats()["g"], rsvc.stats()["g"]
    assert st["n_blocks"] == 4
    assert sum(st["formats"].values()) == 4
    assert st["formats"] == rst["formats"]
    assert st["bytes"] > 0
    assert st["plan"]["schema_version"] == SHARDED_SCHEMA_VERSION
    assert st["plan"] == rst["plan"]
    # the ladder drops the reference-format rung, as the reference's does
    assert set(st["guard"]["spmv"]["served_by"]) == {"tuned", "csr"}
    assert st["guard"]["spmv"]["served_by"]["tuned"] == 1
    assert st["guard"]["spmm"]["served_by"]["tuned"] == 2
    svc.evict("g")


def test_service_plan_cache_replays_across_keys_and_evicts(problem, rng):
    dense, csr, _ = problem
    timer = fake_timer()
    db = TuningDB(machine="pc", c=1.0, records=[], d_star={})
    svc = SpMVService(device="cpu", tuner=KernelTuner(db=db, timer=timer))
    e1 = svc.register("a", csr, measure_baseline=False)
    assert not e1.from_plan
    n_timed = len(timer.calls)
    assert n_timed > 0

    # same structure, different key: served from the plan cache, no tuning
    e2 = svc.register("b", csr, measure_baseline=False)
    assert e2.from_plan
    assert len(timer.calls) == n_timed

    # survives evict: the cache lives on the service, not the entry
    svc.evict("a")
    svc.evict("b")
    e3 = svc.register("c", csr, measure_baseline=False)
    assert e3.from_plan
    assert len(timer.calls) == n_timed
    x = rng.normal(size=dense.shape[1]).astype(np.float32)
    np.testing.assert_allclose(svc.spmv("c", x).numpy(), dense @ x, **TOL)

    pc = svc.stats()["plan_cache"]
    assert pc["hits"] == 2 and pc["misses"] == 1 and pc["size"] == 1

    # different registration knobs miss (the key includes them)
    svc.register("d", csr, measure_baseline=False, expected_iterations=7)
    assert svc.stats()["plan_cache"]["misses"] == 2


def test_service_plan_cache_keyed_by_structure(problem, rng):
    _, csr, _ = problem
    svc = SpMVService(device="cpu")
    svc.register("a", csr, measure_baseline=False)
    other = csr_from_dense(random_dense(rng, 64, 64, 0.2), pad=8,
                           device="cpu")
    e = svc.register("b", other, measure_baseline=False)
    assert not e.from_plan
    assert svc.stats()["plan_cache"]["hits"] == 0


def test_plan_batch_seeds_entry_max_batch(problem, rng):
    dense, csr, _ = problem
    svc = SpMVService(device="cpu", max_batch=32)
    minted = svc.register("mint", csr, batch=2, measure_baseline=False)
    assert minted.max_batch is None          # no plan supplied: global width
    plan = minted.plan
    assert plan.batch == 2
    entry = svc.register("p", csr, plan=plan, measure_baseline=False)
    assert entry.max_batch == 2
    # two submits fill the plan-seeded panel and auto-flush — no explicit
    # flush(), no waiting for the global max_batch of 32
    x1 = rng.normal(size=dense.shape[1]).astype(np.float32)
    x2 = rng.normal(size=dense.shape[1]).astype(np.float32)
    f1, f2 = svc.submit("p", x1), svc.submit("p", x2)
    assert f1.done() and f2.done()
    np.testing.assert_allclose(f1.result().numpy(), dense @ x1, **TOL)
    np.testing.assert_allclose(f2.result().numpy(), dense @ x2, **TOL)


def test_sharded_plan_batch_seeds_entry_max_batch(problem, rng):
    dense, csr, _ = problem
    svc = SpMVService(device="cpu", max_batch=32)
    plan = Planner(device="cpu").plan_sharded(csr, n_shards=2, batch=4)
    entry = svc.register("s", csr, plan=plan, measure_baseline=False,
                         mode="dispatch")
    assert entry.max_batch == 4
    futs = [svc.submit("s", rng.normal(size=dense.shape[1]
                                       ).astype(np.float32))
            for _ in range(4)]
    assert all(f.done() for f in futs)


def test_sharded_plan_save_load_register_zero_retuning(problem, rng,
                                                       tmp_path):
    """The acceptance path: ShardedPlan save -> load -> register(plan=)
    serves with zero re-tuning, counted by the fake timer."""
    dense, csr, _ = problem
    timer = fake_timer()
    db = TuningDB(machine="zs", c=1.0, records=[], d_star={})
    planner = Planner(tuner=KernelTuner(db=db, timer=timer), device="cpu")
    plan = planner.plan_sharded(csr, n_shards=4, axis="row")
    n_timed = len(timer.calls)
    assert n_timed > 0                      # minting did tune
    assert all(bp.plan.tier == "kernel" for bp in plan.shards)

    p = tmp_path / "sharded.json"
    plan.save(str(p))
    loaded = ShardedPlan.load(str(p))
    svc = SpMVService(device="cpu",
                      tuner=KernelTuner(db=db, timer=timer))
    entry = svc.register("z", csr, plan=loaded, measure_baseline=False,
                         mode="dispatch")
    assert entry.from_plan
    assert len(timer.calls) == n_timed, \
        "register(plan=<ShardedPlan>) must not re-tune"
    assert all(t == "kernel" for pm in entry.matrix.planned
               for t in pm.tiers.values())
    x = rng.normal(size=dense.shape[1]).astype(np.float32)
    np.testing.assert_allclose(svc.spmv("z", x).numpy(), dense @ x, **TOL)
    # the minted plan passes the reference's lint and loads there
    json.loads(plan.to_json())
    assert RPL.ShardedPlan.load(str(p)).n_shards == 4
