"""Port vs reference: the crash-safe persistent plan store.

Mirrors ``tests/test_plan_store.py`` on ``repro_torch.core.plan_store``:
atomic checksummed round trips, quarantine-never-raise on every corruption
class, concurrency (racing writers, mid-race readers), and the
service/planner integration — a second service registers with zero tuner
invocations.  Then the interchange with the JAX package: a store directory
written by either package reads in the other (same key, same envelope
checksum, same quarantine of a corrupted entry), a reference-minted plan
passes the port's lint and binds, and the reference's lint on a
port-minted plan with 4-row tiles gives exactly the RPL002 errors its TPU
alignment rule predicts (a standing difference, ROADMAP.md Queue C).
"""
import hashlib
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro_torch.obs as obs
from repro.analyze import lint_plan as ref_lint_plan
from repro.core import plan as RPL
from repro.core import plan_store as RPS
from repro.core.kernel_tune import KernelTuner as RTuner
from repro.core.transform import csr_from_dense as r_csr_from_dense
from repro.serve.spmv_service import SpMVService as RService
from repro_torch.analyze import has_errors, lint_plan
from repro_torch.core.autotune import TuningDB
from repro_torch.core.kernel_tune import KernelTuner
from repro_torch.core.plan import ExecutionPlan, PlanFingerprint, Planner
from repro_torch.core.plan_store import BAD_DIR, PlanStore, fingerprint_key
from repro_torch.core.transform import csr_from_dense
from repro_torch.obs import FakeClock, InMemorySink, Telemetry
from repro_torch.serve import faults
from repro_torch.serve.spmv_service import SpMVService


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
    return np.random.default_rng(11)


@pytest.fixture(scope="module")
def problem(rng):
    d = (rng.random((60, 140)) < 0.12).astype(np.float32)
    dense = d * rng.normal(1.0, 1.0, size=d.shape).astype(np.float32)
    return dense, csr_from_dense(dense, pad=8, device="cpu")


@pytest.fixture(scope="module")
def ref_csr(problem):
    return r_csr_from_dense(problem[0], pad=8)


def same_plan(a, b, path="plan"):
    """Plan JSON key by key; floats to 1e-12 (the cost model's sums may
    round differently in the last bit)."""
    if isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            same_plan(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            same_plan(u, v, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def make_plan(csr, fmt="ell_row") -> ExecutionPlan:
    return ExecutionPlan(fmt=fmt, fingerprint=PlanFingerprint.of(csr))


def fake_timer(prefer_rows=32, run=True):
    calls = []

    def timer(thunk, g):
        if run:
            thunk()
        calls.append(g)
        if g is None:
            return 1.0
        return 0.5 + abs((g.block_rows or prefer_rows) - prefer_rows) * 1e-3

    timer.calls = calls
    return timer


def service(root=None, timer=None, **kw):
    tuner = None
    if timer is not None:
        db = TuningDB(machine="svc", c=1.0, records=[], d_star={})
        tuner = KernelTuner(db=db, timer=timer)
    return SpMVService(tuner=tuner, device="cpu",
                       plan_store=PlanStore(root) if root else None, **kw)


# ---------------------------------------------------------------------------
# round trips + keys
# ---------------------------------------------------------------------------
def test_round_trip(problem, tmp_path):
    _, csr = problem
    store = PlanStore(str(tmp_path / "plans"))
    plan = make_plan(csr)
    key = store.key_for(csr, batch=4)
    path = store.put(key, plan)
    assert os.path.exists(path)
    loaded = store.get(key)
    assert loaded is not None
    assert loaded.to_dict() == plan.to_dict()
    assert store.stats()["hits"] == 1 and store.stats()["writes"] == 1
    assert len(store) == 1


def test_keys_are_deterministic_and_knob_sensitive(problem, ref_csr):
    _, csr = problem
    fp = PlanFingerprint.of(csr)
    assert fingerprint_key(fp, batch=4) == fingerprint_key(fp, batch=4)
    assert fingerprint_key(fp, batch=4) != fingerprint_key(fp, batch=8)
    assert fingerprint_key(fp) != fingerprint_key(fp, strategy="variance")
    # the key is the JAX package's for the same matrix and knobs
    rfp = RPL.PlanFingerprint.of(ref_csr)
    for kw in ({}, {"batch": 4}, {"strategy": "variance", "batch": 8}):
        assert fingerprint_key(fp, **kw) == RPS.fingerprint_key(rfp, **kw)


def test_missing_key_is_a_miss_not_an_error(tmp_path):
    store = PlanStore(str(tmp_path))
    assert store.get("0" * 64) is None
    assert store.stats()["misses"] == 1


def test_fingerprint_mismatch_is_a_miss_not_quarantine(problem, rng,
                                                       tmp_path):
    _, csr = problem
    other = csr_from_dense(
        (rng.random((30, 140)) < 0.2).astype(np.float32), pad=8,
        device="cpu")
    store = PlanStore(str(tmp_path))
    key = store.key_for(csr)
    store.put(key, make_plan(csr))
    assert store.get(key, fingerprint=other) is None
    # the entry is valid for its own matrix: still on disk, not .bad
    assert store.get(key, fingerprint=csr) is not None
    assert store.stats()["quarantined"] == 0


def test_atomic_write_leaves_no_temp_files(problem, tmp_path):
    _, csr = problem
    store = PlanStore(str(tmp_path))
    for i in range(5):
        store.put(store.key_for(csr, i=i), make_plan(csr))
    leftovers = [n for n in os.listdir(str(tmp_path))
                 if n.startswith(".tmp-")]
    assert leftovers == []


# ---------------------------------------------------------------------------
# corruption -> quarantine, never raise
# ---------------------------------------------------------------------------
def corrupt_file(store, key, raw):
    with open(store.path_for(key), "w") as f:
        f.write(raw)


CORRUPTIONS = [
    ('{"store_version": 1, "sha256": "tru', "not_json"),       # torn write
    ('{"something": "else"}', "bad_envelope"),
    ('{"store_version": 99, "sha256": "x", "plan": {}}', "store_version"),
    ('{"store_version": 1, "sha256": "x", "plan": []}', "bad_payload"),
    ('{"store_version": 1, "sha256": "wrong", "plan": {"fmt": "csr"}}',
     "checksum"),
]


@pytest.mark.parametrize("raw,reason", CORRUPTIONS)
def test_each_corruption_class_quarantines(problem, tmp_path, raw, reason,
                                           tel):
    _, csr = problem
    store = PlanStore(str(tmp_path))
    key = store.key_for(csr)
    store.put(key, make_plan(csr))
    corrupt_file(store, key, raw)
    assert store.get(key) is None                 # never raises
    assert not os.path.exists(store.path_for(key))
    bad = os.listdir(os.path.join(str(tmp_path), BAD_DIR))
    assert len(bad) == 1 and reason in bad[0]
    assert store.stats()["quarantined"] == 1
    events = [e for e in tel.sinks[0].named("store.quarantine")
              if e["type"] == "event"]
    assert events and events[0]["attrs"]["reason"] == reason
    # the slot is reusable after quarantine
    store.put(key, make_plan(csr))
    assert store.get(key) is not None


def _resign(env):
    env["sha256"] = hashlib.sha256(json.dumps(
        env["plan"], sort_keys=True,
        separators=(",", ":")).encode()).hexdigest()
    return env


def test_schema_incompatible_payload_quarantines(problem, tmp_path):
    _, csr = problem
    store = PlanStore(str(tmp_path))
    key = store.key_for(csr)
    store.put(key, make_plan(csr))
    with open(store.path_for(key)) as f:
        env = json.load(f)
    env["plan"]["schema_version"] = 999           # a future writer
    corrupt_file(store, key, json.dumps(_resign(env)))
    assert store.get(key) is None
    bad = os.listdir(os.path.join(str(tmp_path), BAD_DIR))
    assert len(bad) == 1 and "schema" in bad[0]


def test_store_corrupt_fault_point_round_trip(problem, tmp_path):
    _, csr = problem
    store = PlanStore(str(tmp_path))
    key = store.key_for(csr)
    with faults.inject("store.corrupt", prob=1.0):
        store.put(key, make_plan(csr))
    assert store.get(key) is None                 # checksum catches it
    assert store.stats()["quarantined"] == 1
    store.put(key, make_plan(csr))                # clean rewrite recovers
    assert store.get(key) is not None


def test_sharded_entry_is_a_miss_left_on_disk(problem, ref_csr, rng,
                                              tmp_path, tel):
    """A sharded plan in the store — one the JAX package minted and wrote,
    and one the port minted — loads as a ``ShardedPlan`` (a hit, nothing
    quarantined) and replays: a service registers it with no tuning and
    serves the dense oracle.  (The name is kept from when the port read
    such an entry as a miss.)"""
    from repro_torch.core.plan import ShardedPlan
    dense, csr = problem
    ref_store = RPS.PlanStore(str(tmp_path))
    key = store_key = ref_store.key_for(ref_csr)
    ref_plan = RPL.Planner().plan_sharded(ref_csr, n_shards=3)
    ref_store.put(key, ref_plan)
    store = PlanStore(str(tmp_path))
    assert store.key_for(csr) == store_key
    got = store.get(key, fingerprint=csr)
    assert isinstance(got, ShardedPlan)
    assert got.to_dict() == ref_plan.to_dict()
    port_key = store.key_for(csr, batch=4)
    store.put(port_key, Planner(device="cpu").plan_sharded(
        csr, n_shards=2, axis="col", batch=4))
    assert isinstance(ref_store.get(port_key, fingerprint=ref_csr),
                      RPL.ShardedPlan)
    assert store.stats()["quarantined"] == 0
    assert store.stats()["hits"] == 1
    assert not tel.sinks[0].named("store.stale")

    def no_tuning(thunk, geometry):
        raise AssertionError("a replayed sharded plan tuned")

    svc = SpMVService(device="cpu",
                      tuner=KernelTuner(timer=no_tuning))
    x = rng.normal(size=dense.shape[1]).astype(np.float32)
    for k in (key, port_key):
        entry = svc.register(k, csr, plan=store.get(k, fingerprint=csr),
                             measure_baseline=False)
        assert entry.from_plan and entry.matrix.mode == "dispatch"
        np.testing.assert_allclose(svc.spmv(k, x).numpy(), dense @ x,
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# concurrency: racing writers, readers mid-race
# ---------------------------------------------------------------------------
def test_racing_same_key_writers_leave_one_intact_entry(problem, tmp_path):
    _, csr = problem
    root = str(tmp_path)
    key = PlanStore(root).key_for(csr)
    errors = []

    def writer(fmt):
        store = PlanStore(root)       # each thread: its own handle
        try:
            for _ in range(30):
                store.put(key, make_plan(csr, fmt=fmt))
        except Exception as e:        # pragma: no cover - the assertion
            errors.append(e)

    ts = [threading.Thread(target=writer, args=(f,))
          for f in ("ell_row", "coo_row")]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert errors == []
    final = PlanStore(root).get(key)
    assert final is not None and final.fmt in ("ell_row", "coo_row")
    assert PlanStore(root).stats()["quarantined"] == 0


def test_reader_never_sees_torn_json_mid_race(problem, tmp_path):
    _, csr = problem
    root = str(tmp_path)
    key = PlanStore(root).key_for(csr)
    PlanStore(root).put(key, make_plan(csr))      # ensure first read hits
    stop = threading.Event()
    tears = []

    def reader():
        store = PlanStore(root)
        while not stop.is_set():
            plan = store.get(key)
            if plan is None:          # a torn write would quarantine
                tears.append("miss")

    def writer():
        store = PlanStore(root)
        for i in range(60):
            store.put(key, make_plan(csr, fmt="ell_row" if i % 2
                                      else "coo_row"))

    rt = threading.Thread(target=reader)
    rt.start()
    writer()
    stop.set()
    rt.join()
    assert tears == []
    assert PlanStore(root).stats()["quarantined"] == 0


# ---------------------------------------------------------------------------
# planner + service integration
# ---------------------------------------------------------------------------
def test_planner_plan_or_load_round_trips(problem, ref_csr, tmp_path):
    _, csr = problem
    store = PlanStore(str(tmp_path))
    planner = Planner(device="cpu")
    p1 = planner.plan_or_load(csr, store)
    assert store.stats()["writes"] == 1
    p2 = planner.plan_or_load(csr, store)
    assert store.stats()["hits"] == 1
    assert p2.to_dict() == p1.to_dict()
    # the same call in the JAX package writes the same entry
    rstore = RPS.PlanStore(str(tmp_path / "ref"))
    r1 = RPL.Planner().plan_or_load(ref_csr, rstore)
    assert rstore.keys() == store.keys()
    same_plan(r1.to_dict(), p1.to_dict())


def test_plan_or_load_replays_with_zero_tuner_calls(problem, tmp_path):
    _, csr = problem
    store = PlanStore(str(tmp_path))
    t1 = fake_timer()
    p1 = Planner(tuner=KernelTuner(timer=t1), device="cpu").plan_or_load(
        csr, store, batch=8)
    assert len(t1.calls) > 0 and p1.tier == "kernel"
    t2 = fake_timer()
    p2 = Planner(tuner=KernelTuner(timer=t2), device="cpu").plan_or_load(
        csr, store, batch=8)
    assert t2.calls == [], "a store hit must skip tuning entirely"
    assert p2.to_dict() == p1.to_dict()
    x = np.ones(140, np.float32)
    np.testing.assert_allclose(
        p2.bind(csr, device="cpu") @ torch.from_numpy(x),
        problem[0] @ x, rtol=1e-4, atol=1e-4)


def test_second_service_registers_with_zero_tuner_invocations(problem,
                                                              tmp_path):
    _, csr = problem
    root = str(tmp_path / "fleet")
    t1 = fake_timer()
    svc1 = service(root, t1, max_batch=4)
    e1 = svc1.register("a", csr, measure_baseline=False)
    assert len(t1.calls) > 0 and not e1.from_plan
    assert svc1.plan_store.stats()["writes"] == 1

    # "another replica": fresh service, fresh tuner, same store directory
    t2 = fake_timer()
    svc2 = service(root, t2, max_batch=4)
    e2 = svc2.register("whatever", csr, measure_baseline=False)
    assert e2.from_plan
    assert len(t2.calls) == 0, "plan-store hit must skip tuning entirely"
    assert svc2.plan_store.stats()["hits"] == 1
    assert e2.matrix.formats == e1.matrix.formats
    assert "plan_store" in svc2.stats()


def test_service_survives_corrupted_store_entry(problem, rng, tmp_path,
                                                tel):
    dense, csr = problem
    root = str(tmp_path / "fleet")
    svc1 = service(root)
    svc1.register("a", csr, measure_baseline=False)
    store = PlanStore(root)
    key = store.keys()[0]
    corrupt_file(store, key, "garbage{{{")

    # never raises: the corrupt entry quarantines, the service re-tunes
    svc2 = service(root)
    e2 = svc2.register("b", csr, measure_baseline=False)
    assert not e2.from_plan
    assert svc2.plan_store.stats()["quarantined"] == 1
    x = rng.normal(size=140).astype(np.float32)
    np.testing.assert_allclose(svc2.spmv("b", x).numpy(), dense @ x,
                               rtol=2e-4, atol=2e-4)
    events = [e for e in tel.sinks[0].named("store.quarantine")
              if e["type"] == "event"]
    assert events
    # the re-tuned plan was written back over the quarantined slot
    assert PlanStore(root).get(key) is not None


def test_store_full_disk_does_not_fail_registration(problem, monkeypatch,
                                                    tmp_path, tel):
    _, csr = problem
    store = PlanStore(str(tmp_path))

    def full_disk(key, plan):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(store, "put", full_disk)
    svc = SpMVService(plan_store=store, device="cpu")
    entry = svc.register("a", csr, measure_baseline=False)
    assert entry is not None           # registration served from memory
    swallowed = [k for k in tel.snapshot()["counters"]
                 if k.startswith("service.swallowed_errors")
                 and "plan_store_put" in k]
    assert swallowed


# ---------------------------------------------------------------------------
# interchange with the JAX package
# ---------------------------------------------------------------------------
STORES = {"port": PlanStore, "reference": RPS.PlanStore}


@pytest.mark.parametrize("writer,reader", [("port", "reference"),
                                           ("reference", "port")])
def test_store_directory_reads_in_the_other_package(problem, ref_csr,
                                                    tmp_path, writer,
                                                    reader):
    """Same key, same envelope (checksum included), same plan back, and a
    corrupted entry quarantines under the same reason in either."""
    _, csr = problem
    root = str(tmp_path)
    plans = {"port": make_plan(csr, "sell"),
             "reference": RPL.ExecutionPlan(
                 fmt="sell", fingerprint=RPL.PlanFingerprint.of(ref_csr))}
    mats = {"port": csr, "reference": ref_csr}
    w, r = STORES[writer](root), STORES[reader](root)
    key = w.key_for(mats[writer], batch=4)
    assert key == r.key_for(mats[reader], batch=4)
    path = w.put(key, plans[writer])
    got = r.get(key, fingerprint=mats[reader])
    assert got is not None and got.to_dict() == plans[reader].to_dict()
    # the envelope each package writes for the plan is the same
    env_w = json.load(open(path))
    r.put(key, plans[reader])
    assert json.load(open(path)) == env_w
    # a corrupted entry (re-signed payload that fails only the lint) and a
    # torn one quarantine under the same reason in the reader
    for raw, reason in (('{"store_version": 1, "sha256": "tru', "not_json"),
                        (None, "lint")):
        w.put(key, plans[writer])
        if raw is None:
            env = json.load(open(path))
            env["plan"]["fingerprint"]["n"] = 0
            raw = json.dumps(_resign(env))
        with open(path, "w") as f:
            f.write(raw)
        assert r.get(key) is None
        assert any(n.startswith(os.path.basename(path) + "." + reason)
                   for n in os.listdir(os.path.join(root, BAD_DIR)))


def test_reference_minted_plan_passes_the_port_lint_and_binds(problem,
                                                              ref_csr):
    """A kernel-tier hybrid plan the JAX package's service mints (TPU
    tiles: 8-aligned) lints clean of errors in the port and serves
    through the port's service with zero re-tuning."""
    dense, csr = problem
    rdb = RPL.TuningDB(machine="svc", c=1.0, records=[], d_star={})
    rsvc = RService(tuner=RTuner(db=rdb, timer=fake_timer(run=False),
                                 interpret=True), max_batch=4)
    rplan = rsvc.register("a", ref_csr, measure_baseline=False).plan
    assert rplan.tier == "kernel" and rplan.blocks
    payload = rplan.to_dict()
    assert not has_errors(lint_plan(payload))
    t = fake_timer()
    svc = service(timer=t, max_batch=4)
    entry = svc.register("a", csr, plan=ExecutionPlan.from_dict(payload),
                         strict_lint=True, measure_baseline=False)
    assert entry.from_plan and t.calls == []
    assert entry.plan.to_dict() == payload
    x = np.linspace(-1, 1, 140, dtype=np.float32)
    X = np.stack([x, 2 * x, -x, x * x], axis=1)
    np.testing.assert_allclose(svc.spmv("a", x).numpy(),
                               np.asarray(rsvc.spmv("a", jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(svc.spmm("a", X).numpy(), dense @ X,
                               rtol=1e-4, atol=1e-4)


def _misaligned(d, where=""):
    """The (where, message) of each RPL002 error the JAX package's TPU
    alignment rule gives a plan payload: every knob off a multiple of 8,
    except a BCSR ``block_rows`` (a warning there)."""
    out = set()
    for op, gd in (d.get("geometry") or {}).items():
        for w, g in [(f"{where}geometry.{op}", gd)] + [
                (f"{where}geometry.{op}.buckets[{i}]", b[1])
                for i, b in enumerate(gd.get("buckets") or [])]:
            for k, v in g.items():
                if k in ("buckets", "slabs_per_block") or v % 8 == 0:
                    continue
                if d["fmt"] == "bcsr" and k == "block_rows":
                    continue
                out.add((w, f"{k}={v} is not 8-aligned"))
    for i, b in enumerate(d.get("blocks") or []):
        out |= _misaligned(b["plan"], f"{where}blocks[{i}].plan.")
    return out


def test_port_minted_small_tiles_fail_the_reference_lint(problem, ref_csr,
                                                         tmp_path):
    """Standing difference (ROADMAP.md Queue C): the port's tuner keeps
    tiles of 1, 2 and 4 rows, which won on the card; the JAX package's
    lint errors on each (its 8-alignment rule), so its PlanStore
    quarantines such an entry with reason ``lint``.  The port's lint
    passes it."""
    _, csr = problem
    svc = service(str(tmp_path), fake_timer(prefer_rows=4), max_batch=4)
    plan = svc.register("a", csr, measure_baseline=False).plan
    payload = plan.to_dict()
    expected = _misaligned(payload)
    assert any("block_rows=4" in m for _, m in expected), expected
    assert not has_errors(lint_plan(payload))
    got = {(f.where, f.message) for f in ref_lint_plan(payload)
           if f.rule == "RPL002" and f.severity == "error"}
    assert got == expected
    assert {f.rule for f in ref_lint_plan(payload)
            if f.severity == "error"} == {"RPL002"}
    rstore = RPS.PlanStore(str(tmp_path))
    key = rstore.keys()[0]
    assert rstore.get(key) is None and rstore.quarantined == 1
    assert os.listdir(os.path.join(str(tmp_path), BAD_DIR))[0] \
        .endswith(".lint")
