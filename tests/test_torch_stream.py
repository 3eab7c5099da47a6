"""Port vs reference: streaming updates on mutating matrices.

Every case of ``tests/test_stream.py`` — DeltaBatch JSON, incremental CSR
and SELL applies after randomized deltas, the exact drift sketch,
hysteresis and the paper-rule re-plan, the service's streaming keys, the
``delta.corrupt`` fault, capture -> replay -> ``offline_phase``, RPL010,
the plan store's LRU and the breaker-state gauge — run through
``repro_torch.stream`` on the CPU beside the JAX package's
``repro.stream`` on the same numpy inputs and the same deltas.  Held:

* containers after each delta equal the reference's field by field (CSR:
  data, cols, indptr, ``nnz_pad``; SELL: perm, row offsets, every
  bucket's data, cols and nnz), exactly;
* the same apply ``mode``, ``fallback_reason``, rows and lengths, the same
  sketch, ``DriftDecision`` and ``stream_plan`` JSON key by key (floats to
  1e-12);
* products within 2e-4 of the dense oracle of the current matrix
  (``CSR.todense``, which accumulates duplicate coordinates);
* DeltaBatch and trace JSON written by either package load in the other.

Then what the port adds: two updates of one entry keep the later value and
a twice-deleted entry goes once (torch's repeated-index stores are not
numpy's); a delta that lengthens a row of a bound SELL bucket past its
width leaves K1's extents fresh; an apply makes the same number of torch
ops for 4 changed rows as for 256, and reads back only delta-sized arrays.
"""
import dataclasses
import json

import numpy as np
import pytest
torch = pytest.importorskip("torch")
from torch.utils._python_dispatch import TorchDispatchMode

import repro.obs as r_obs
from repro.analyze.planlint import lint_plan as r_lint_plan
from repro.core.autotune import TuningDB as RTuningDB
from repro.core.plan import Planner as RPlanner
from repro.core.transform import csr_from_dense as r_csr_from_dense
from repro.serve import faults as r_faults
from repro.serve.spmv_service import SpMVService as RService
from repro.stream import capture as RC
from repro.stream import delta as RD
from repro.stream import drift as RDR
from repro.stream.replay import epochs_of as r_epochs_of

import repro_torch.obs as obs
from repro_torch.analyze.planlint import lint_plan
from repro_torch.core.autotune import TuningDB, decide_paper
from repro_torch.core.formats import (CSR, MatrixStats,
                                     MatrixValidationError, to_numpy,
                                     validate_container)
from repro_torch.core.plan import ExecutionPlan, Planner
from repro_torch.core.plan_store import PlanStore
from repro_torch.core.transform import csr_from_dense
from repro_torch.kernels import ops
from repro_torch.kernels.ell_spmv import ell_extent
from repro_torch.obs import FakeClock, InMemorySink, Telemetry
from repro_torch.obs.export import prometheus_text
from repro_torch.serve import faults
from repro_torch.serve.guard import CLOSED, OPEN, STATE_CODES
from repro_torch.serve.spmv_service import SpMVService
from repro_torch.stream import (INCREMENTAL_FORMATS, DeltaBatch,
                                DriftSketch, ReplanPolicy,
                                StreamingPlannedMatrix, TraceCapture,
                                apply_delta, epochs_of,
                                load_trace, random_delta, replay_file)

#: a product against the dense oracle of the current matrix
TOL = dict(rtol=2e-4, atol=2e-4)
#: the port's product against the reference's on the same matrix
REF_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture()
def tel():
    t = Telemetry(enabled=True, clock=FakeClock(), sinks=[InMemorySink()])
    prev = obs.set_default(t)
    yield t
    obs.set_default(prev)


@pytest.fixture(autouse=True)
def clean_faults():
    faults.clear()
    r_faults.clear()
    yield
    faults.clear()
    r_faults.clear()


def _dense(seed=7, shape=(40, 64), density=0.15):
    rng = np.random.default_rng(seed)
    d = (rng.random(shape) < density).astype(np.float32)
    return rng, d * rng.normal(1.0, 1.0, size=d.shape).astype(np.float32)


def _problem(seed=7, shape=(40, 64), density=0.15):
    """``(rng, reference CSR, port CSR)`` of one seeded matrix — the
    reference test's ``_problem`` in both packages."""
    rng, dense = _dense(seed, shape, density)
    return (rng, r_csr_from_dense(dense, pad=8),
            csr_from_dense(dense, pad=8, device="cpu"))


def _uniform(n_rows=32, n_cols=256, row_len=4, seed=3):
    """Every row exactly ``row_len`` nonzeros -> sigma = 0, D_mat = 0."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n_rows, n_cols), dtype=np.float32)
    for i in range(n_rows):
        cols = rng.choice(n_cols, size=row_len, replace=False)
        dense[i, cols] = rng.normal(size=row_len).astype(np.float32)
    return (r_csr_from_dense(dense, pad=8),
            csr_from_dense(dense, pad=8, device="cpu"))


def _copy(m: CSR) -> CSR:
    return CSR(data=m.data.clone(), cols=m.cols.clone(),
               indptr=m.indptr.clone(), shape=m.shape, nnz=m.nnz)


def same_container(r, t, path="container"):
    """A reference container and the port's, field by field, exactly."""
    name, arrs, meta = to_numpy(t)
    assert tuple(int(s) for s in r.shape) == tuple(meta["shape"]), path
    assert int(r.nnz) == int(meta["nnz"]), path
    if name == "csr":
        for f in ("data", "cols", "indptr"):
            want = np.asarray(getattr(r, f))
            assert want.shape == arrs[f].shape, (path, f)     # nnz_pad too
            np.testing.assert_array_equal(want, arrs[f], err_msg=f"{path}.{f}")
    elif name == "sell":
        np.testing.assert_array_equal(np.asarray(r.perm), arrs["perm"],
                                      err_msg=f"{path}.perm")
        assert tuple(r.row_offsets) == tuple(meta["row_offsets"]), path
        assert len(r.buckets) == len(arrs["buckets"]), path
        for i, (rb, tb, tm) in enumerate(zip(r.buckets, arrs["buckets"],
                                             meta["buckets"])):
            for f in ("data", "cols"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(rb, f)), tb[f],
                    err_msg=f"{path}.buckets[{i}].{f}")
            assert int(rb.nnz) == int(tm["nnz"]), (path, i)
    else:
        raise AssertionError(f"{path}: unexpected container {name}")


def same_dict(a, b, path="dict"):
    """JSON-shaped values key by key; floats to 1e-12."""
    if isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-12, nan_ok=True), path
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), \
            (path, sorted(a), sorted(b))
        for k in a:
            same_dict(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            same_dict(u, v, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def same_result(r, t, path="apply"):
    """Two ``DeltaApplyResult``s: what the apply did, and what it left."""
    assert (t.fmt, t.mode, t.fallback, t.fallback_reason,
            t.buckets_rebuilt) == (r.fmt, r.mode, r.fallback,
                                   r.fallback_reason, r.buckets_rebuilt), path
    for f in ("appended_lens", "changed_rows", "old_lens", "new_lens"):
        np.testing.assert_array_equal(np.asarray(getattr(r, f)),
                                      getattr(t, f), err_msg=f"{path}.{f}")
    same_container(r.csr, t.csr, f"{path}.csr")
    same_container(r.container, t.container, f"{path}.container")


def delta_pair(rng_seed, r_csr, t_csr, **kw):
    """The reference's ``random_delta`` and the port's from one seed: the
    same draws (held), handed to both packages."""
    rd = RD.random_delta(np.random.default_rng(rng_seed), r_csr, **kw)
    td = random_delta(np.random.default_rng(rng_seed), t_csr, **kw)
    assert td.to_dict() == rd.to_dict()
    return rd, td


def assert_parity(sm, rng, batch=1):
    n = sm.csr.n_cols
    x = rng.normal(size=(n, batch)).astype(np.float32) if batch > 1 \
        else rng.normal(size=n).astype(np.float32)
    np.testing.assert_allclose((sm @ x).numpy(), sm.csr.todense() @ x,
                               **TOL)


def streaming_pair(seed, fmt, shape=(40, 64), **kw):
    rng, rc, tc = _problem(seed=seed, shape=shape)
    r = RDR.StreamingPlannedMatrix(rc, RPlanner(), plan_kw={"fmt": fmt},
                                   **kw)
    t = StreamingPlannedMatrix(tc, Planner(device="cpu"),
                               plan_kw={"fmt": fmt}, **kw)
    return rng, r, t


# ---------------------------------------------------------------------------
# the DeltaBatch artifact
# ---------------------------------------------------------------------------
def test_delta_roundtrip_preserves_semantics():
    rng, rc, tc = _problem()
    rd, td = delta_pair(1, rc, tc, n_appends=2, n_updates=4, n_deletes=3)
    # JSON written by either package loads in the other
    back = DeltaBatch.from_dict(json.loads(json.dumps(rd.to_dict())))
    rback = RD.DeltaBatch.from_dict(json.loads(json.dumps(td.to_dict())))
    assert back.to_dict() == rd.to_dict() == rback.to_dict()
    a = apply_delta(tc, td, fmt="csr").csr.todense()
    _, _, tc2 = _problem()
    b = apply_delta(tc2, back, fmt="csr").csr.todense()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        a, RD.apply_delta(rc, rback, fmt="csr").csr.todense())


def test_delta_validate_rejects_malformed():
    cases = [
        (dict(n_cols=0), {}, "n_cols"),
        (dict(n_cols=4, append_cols=(np.asarray([0, 9]),),
              append_vals=(np.asarray([1.0, 2.0]),)), {}, "column out of"),
        (dict(n_cols=4, update_rows=np.asarray([10]),
              update_cols=np.asarray([0]), update_vals=np.asarray([1.0])),
         {"n_rows": 5}, "appended rows cannot"),
    ]
    for kw, vkw, match in cases:
        with pytest.raises(ValueError, match=match) as te:
            DeltaBatch(**kw).validate(**vkw)
        with pytest.raises(ValueError) as re_:
            RD.DeltaBatch(**kw).validate(**vkw)
        assert str(te.value) == str(re_.value)


# ---------------------------------------------------------------------------
# containers after randomized delta sequences
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", list(INCREMENTAL_FORMATS))
@pytest.mark.parametrize("batch", [1, 8])
def test_incremental_parity_randomized(fmt, batch):
    rng, r, t = streaming_pair(11, fmt)
    assert t.fmt == r.fmt == fmt
    same_dict(r.to_dict(), t.to_dict(), "stream_plan")
    modes = []
    for step in range(4):
        rd, td = delta_pair(100 + step, r.csr, t.csr,
                            n_appends=step % 2 + 1, n_updates=4,
                            n_deletes=3)
        rres, tres = r.apply(rd), t.apply(td)
        same_result(rres, tres, f"step {step}")
        assert not tres.fallback, tres.fallback_reason
        modes.append(tres.mode)
        same_container(r.bound.matrix, t.bound.matrix, f"bound {step}")
        same_dict(r.sketch.to_dict(), t.sketch.to_dict(), "sketch")
        same_dict(dataclasses.asdict(r.last_decision),
                  dataclasses.asdict(t.last_decision), "decision")
        x = rng.normal(size=(64, batch) if batch > 1 else 64).astype(
            np.float32)
        y = (t @ x).numpy()
        np.testing.assert_allclose(y, t.csr.todense() @ x, **TOL)
        np.testing.assert_allclose(y, np.asarray(r @ x), **REF_TOL)
    # the whole point: the container was edited, not re-transformed
    assert set(modes) & {"inplace", "append", "splice"}
    assert t.replans == 0 and t.fallbacks == 0
    same_dict(r.to_dict(), t.to_dict(), "stream_plan")


def test_sketch_tracks_row_length_stats_exactly():
    _, r, t = streaming_pair(23, "csr")
    for i in range(5):
        rd, td = delta_pair(200 + i, r.csr, t.csr, n_appends=2, n_updates=5,
                            n_deletes=4)
        r.apply(rd)
        t.apply(td)
    fresh = DriftSketch.of(t.csr)
    assert t.sketch.n == fresh.n
    assert t.sketch.nnz == fresh.nnz
    assert t.sketch.sum_sq == pytest.approx(fresh.sum_sq)
    np.testing.assert_array_equal(t.sketch.hist, fresh.hist)
    assert t.sketch.d_mat == pytest.approx(fresh.d_mat)
    same_dict(RDR.DriftSketch.of(r.csr).to_dict(), fresh.to_dict())
    same_dict(r.sketch.to_dict(), t.sketch.to_dict())


def test_duplicate_updates_and_double_deletes_match_the_reference():
    """Two updates of one stored entry keep the later value, two of one
    absent entry insert it twice, and an entry deleted twice goes once —
    as the reference's numpy stores and its delete loop have it, where a
    CUDA store of repeated indices would keep an arbitrary one."""
    for seed in range(6):
        rng, rc, tc = _problem(seed=40 + seed, shape=(50, 64), density=0.1)
        rs = RPlanner().plan(rc, fmt="sell").transform.apply(rc)
        ts = Planner(device="cpu").plan(tc, fmt="sell").transform.apply(tc)
        ip, cols = np.asarray(rc.indptr), np.asarray(rc.cols)
        k = int(rng.integers(0, rc.nnz))
        sr, sc = int(np.searchsorted(ip, k, side="right") - 1), int(cols[k])
        mr, mc = int(rng.integers(0, 50)), int(rng.integers(0, 64))
        wide = np.arange(12 + 4 * seed, dtype=np.int64)
        delta = dict(
            n_cols=64, append_cols=(wide,),
            append_vals=(np.ones(wide.shape[0], np.float32),),
            update_rows=np.asarray([sr, sr, mr, mr, sr], np.int64),
            update_cols=np.asarray([sc, sc, mc, mc, sc], np.int64),
            update_vals=np.asarray([1, 2, 3, 4, 5], np.float32),
            delete_rows=np.asarray([sr, sr, mr], np.int64),
            delete_cols=np.asarray([sc, sc, mc], np.int64))
        for fmt, rcont, tcont in (("csr", None, None), ("sell", rs, ts)):
            rres = RD.apply_delta(r_csr_from_dense(rc.todense(), pad=8)
                                  if fmt == "csr" else rc,
                                  RD.DeltaBatch(**delta), container=rcont,
                                  fmt=fmt)
            tres = apply_delta(_copy(tc) if fmt == "csr" else tc,
                               DeltaBatch(**delta), container=tcont, fmt=fmt)
            same_result(rres, tres, f"seed {seed} {fmt}")
            dense = tres.csr.todense()
            x = rng.normal(size=64).astype(np.float32)
            np.testing.assert_allclose(
                ops.spmv_sell(tres.container, torch.from_numpy(x)).numpy()
                if fmt == "sell" else tres.csr.todense() @ x, dense @ x,
                **TOL)


# ---------------------------------------------------------------------------
# drift: hysteresis and the paper-rule re-plan
# ---------------------------------------------------------------------------
def test_oscillation_near_boundary_never_replans():
    kw = dict(d_star=1.0, hysteresis=0.15, fmt="sell", min_deltas_between=0)
    pol, rpol = ReplanPolicy(**kw), RDR.ReplanPolicy(**kw)
    for i in range(20):
        d_mat = 1.1 if i % 2 else 0.9       # hops the boundary every step
        dec = pol.decide(d_mat, current_fmt="sell")
        same_dict(dataclasses.asdict(rpol.decide(d_mat, current_fmt="sell")),
                  dataclasses.asdict(dec))
        assert not dec.replan
        assert dec.reason in ("stable", "hysteresis")
    # outside the dead band the same crossing does fire
    assert pol.decide(1.5, current_fmt="sell").replan
    assert rpol.decide(1.5, current_fmt="sell").replan
    same_dict(rpol.to_dict(), pol.to_dict())


def test_streaming_matrix_oscillation_zero_replans(tel):
    rng, rc, tc = _problem(seed=5, shape=(80, 64))
    d0 = MatrixStats.of(tc).d_mat
    kw = dict(d_star=d0 / 1.05, hysteresis=0.15, fmt="sell",
              min_deltas_between=0)
    r = RDR.StreamingPlannedMatrix(rc, RPlanner(), plan_kw={"fmt": "sell"},
                                   policy=RDR.ReplanPolicy(**kw))
    t = StreamingPlannedMatrix(tc, Planner(device="cpu"),
                               plan_kw={"fmt": "sell"},
                               policy=ReplanPolicy(**kw))
    for i in range(4):
        rd, td = delta_pair(300 + i, r.csr, t.csr, n_updates=3, n_deletes=2)
        same_result(r.apply(rd), t.apply(td), f"step {i}")
        assert t.last_decision.reason in ("stable", "hysteresis")
        same_dict(dataclasses.asdict(r.last_decision),
                  dataclasses.asdict(t.last_decision))
        x = rng.normal(size=64).astype(np.float32)
        y = (t @ x).numpy()     # one query each: k̂ counts them
        np.testing.assert_allclose(y, t.csr.todense() @ x, **TOL)
        np.testing.assert_allclose(y, np.asarray(r @ x), **REF_TOL)
    assert t.replans == r.replans == 0
    assert not any(k.startswith("stream.replans")
                   for k in tel.snapshot()["counters"])


def test_drifted_matrix_replans_to_paper_pick(tel):
    db = TuningDB(machine="test", c=1.0, records=[], d_star={"sell": 1.0})
    rdb = RTuningDB(machine="test", c=1.0, records=[], d_star={"sell": 1.0})
    rc, tc = _uniform()
    t = StreamingPlannedMatrix(
        tc, Planner(db=db, rule="paper", device="cpu"),
        plan_kw={"formats": ("sell",)},
        policy=ReplanPolicy(db=db, fmt="sell", min_deltas_between=1))
    r = RDR.StreamingPlannedMatrix(
        rc, RPlanner(db=rdb, rule="paper"), plan_kw={"formats": ("sell",)},
        policy=RDR.ReplanPolicy(db=rdb, fmt="sell", min_deltas_between=1))
    assert t.fmt == r.fmt == "sell" and t.d_mat == 0.0
    # one 200-nnz row against uniform 4-nnz rows: D_mat jumps past D*
    cols = np.arange(200, dtype=np.int64)
    kw = dict(n_cols=tc.n_cols, append_cols=(cols,),
              append_vals=(np.ones(200, dtype=np.float32),))
    r.apply(RD.DeltaBatch(**kw))
    t.apply(DeltaBatch(**kw))
    assert t.replans == r.replans == 1
    scratch = decide_paper(db, MatrixStats.of(t.csr), fmt="sell")
    assert t.fmt == scratch.fmt == r.fmt == "csr"
    same_dict(r.to_dict(), t.to_dict(), "stream_plan")
    assert_parity(t, np.random.default_rng(0))
    assert any(k.startswith("stream.replans")
               for k in tel.snapshot()["counters"])


# ---------------------------------------------------------------------------
# the serving integration
# ---------------------------------------------------------------------------
def test_service_streaming_parity_and_breaker_survival():
    rng, rc, tc = _problem(seed=13)
    t, r = SpMVService(device="cpu", max_batch=4), RService(max_batch=4)
    t.register("m", tc, measure_baseline=False, streaming=True,
               plan=Planner(device="cpu").plan(tc, fmt="sell"))
    r.register("m", rc, measure_baseline=False, streaming=True,
               plan=RPlanner().plan(rc, fmt="sell"))
    br0 = t._breaker("m", "sell", "spmv")
    for i in range(4):
        rd, td = delta_pair(400 + i, r.entries["m"].source,
                            t.entries["m"].source, n_appends=1, n_updates=4,
                            n_deletes=2)
        rres, tres = r.apply_delta("m", rd), t.apply_delta("m", td)
        assert not tres.fallback
        same_result(rres, tres, f"delta {i}")
        entry = t.entries["m"]
        same_container(r.entries["m"].matrix.blocks[0],
                       entry.matrix.blocks[0], f"served {i}")
        x = rng.normal(size=64).astype(np.float32)
        y = t.spmv("m", x).numpy()
        np.testing.assert_allclose(y, entry.source.todense() @ x, **TOL)
        np.testing.assert_allclose(y, np.asarray(r.spmv("m", x)), **REF_TOL)
    entry = t.entries["m"]
    assert entry.deltas == 4 and entry.replans == 0
    st, rst = t.stats()["m"]["streaming"], r.stats()["m"]["streaming"]
    same_dict(rst, st, "stats.streaming")
    assert st["deltas"] == 4 and st["replans"] == 0 and "d_mat" in st
    # breakers are service-owned: same object all along
    assert t._breaker("m", "sell", "spmv") is br0


def test_service_nonleaf_operator_rebuilds(tel):
    rng, rc, tc = _problem(seed=17)
    t, r = SpMVService(device="cpu"), RService()
    # not incrementally updatable
    t.register("m", tc, measure_baseline=False, streaming=True,
               plan=Planner(device="cpu").plan(tc, fmt="ell_row"))
    r.register("m", rc, measure_baseline=False, streaming=True,
               plan=RPlanner().plan(rc, fmt="ell_row"))
    rd, td = delta_pair(500, rc, tc, n_appends=1, n_updates=3)
    rres, tres = r.apply_delta("m", rd), t.apply_delta("m", td)
    assert tres.fallback and tres.mode == "rebuild"
    assert (tres.fallback_reason, tres.mode) == (rres.fallback_reason,
                                                 rres.mode)
    entry = t.entries["m"]
    same_container(r.entries["m"].source, entry.source, "source")
    x = rng.normal(size=64).astype(np.float32)
    np.testing.assert_allclose(t.spmv("m", x).numpy(),
                               entry.source.todense() @ x, **TOL)
    # the rebuild re-derives the sketch exactly (no double counting)
    fresh = DriftSketch.of(entry.source)
    assert entry.sketch.n == fresh.n and entry.sketch.nnz == fresh.nnz
    same_dict(r.entries["m"].sketch.to_dict(), entry.sketch.to_dict())


def test_service_apply_delta_requires_streaming():
    _, _, tc = _problem()
    svc = SpMVService(device="cpu")
    svc.register("m", tc, measure_baseline=False)
    with pytest.raises(ValueError, match="streaming=True"):
        svc.apply_delta("m", DeltaBatch(n_cols=tc.n_cols))


def test_service_streaming_rejects_sharded_plans():
    _, rc, tc = _problem()
    with pytest.raises(ValueError, match="sharded") as te:
        SpMVService(device="cpu").register(
            "m", tc, measure_baseline=False, streaming=True,
            plan=Planner(device="cpu").plan_sharded(tc, n_shards=2))
    with pytest.raises(ValueError) as re_:
        RService().register("m", rc, measure_baseline=False, streaming=True,
                            plan=RPlanner().plan_sharded(rc, n_shards=2))
    assert str(te.value) == str(re_.value)


# ---------------------------------------------------------------------------
# chaos: a corrupted delta apply degrades to a clean full re-transform
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", list(INCREMENTAL_FORMATS))
def test_delta_corrupt_fault_degrades_to_rebuild(fmt, tel):
    rng, r, t = streaming_pair(29, fmt)
    rd, td = delta_pair(600, r.csr, t.csr, n_appends=1, n_updates=3,
                        n_deletes=2)
    before = t.bound.matrix
    with faults.inject("delta.corrupt", prob=1.0):
        tres = t.apply(td)
    with r_faults.inject("delta.corrupt", prob=1.0):
        rres = r.apply(rd)
    assert tres.fallback and tres.fallback_reason == "corrupt"
    assert tres.mode == "rebuild"
    same_result(rres, tres)
    validate_container(before)    # copy-on-write: the old one is intact
    assert_parity(t, rng)          # costs time, never correctness
    fb = [k for k in tel.snapshot()["counters"]
          if k.startswith("stream.fallbacks")]
    assert fb


def test_validate_on_the_device_catches_every_poison():
    """``validate`` checks a container with device reductions; each poison
    of the ``delta.corrupt`` fault fails it with the host check's own
    message."""
    from repro_torch.stream.delta import _poison
    _, _, tc = _problem()
    sell = Planner(device="cpu").plan(tc, fmt="sell").transform.apply(tc)
    ell = Planner(device="cpu").plan(tc, fmt="ell_row").transform.apply(tc)
    for m in (_copy(tc), sell, ell):
        validate_container(m)
        _poison(m)
        with pytest.raises(MatrixValidationError, match="indptr|perm|column"):
            validate_container(m)


# ---------------------------------------------------------------------------
# capture -> replay -> offline_phase round trip (FakeClock, deterministic)
# ---------------------------------------------------------------------------
def test_capture_replay_roundtrip(tmp_path):
    rng, _, base = _problem(seed=31)
    path = str(tmp_path / "trace.jsonl")
    cap = TraceCapture(path, clock=FakeClock(tick=1.0))
    sm = StreamingPlannedMatrix(base, Planner(device="cpu"),
                                plan_kw={"fmt": "csr"}, capture=cap,
                                key="web")
    deltas = []
    for n_q in (3, 2, 1):
        for _ in range(n_q):
            sm @ rng.normal(size=base.n_cols).astype(np.float32)
        d = random_delta(rng, sm.csr, n_appends=1, n_updates=3, n_deletes=2)
        deltas.append(d)
        sm.apply(d)
    sm @ rng.normal(size=(base.n_cols, 2)).astype(np.float32)
    cap.close()

    trace = load_trace(path)
    ts = [rec["t"] for rec in trace]
    assert ts == sorted(ts) and len(set(ts)) == len(ts)   # FakeClock ticks
    assert trace[0]["kind"] == "stream.base"
    assert sum(rec["kind"] == "stream.delta" for rec in trace) == 3
    assert trace == RC.load_trace(path)    # the reference reads it as is

    # epochs reconstruct the exact matrix history (fresh base: the live
    # streaming matrix mutated its tensors in place), in both packages
    _, rbase, base2 = _problem(seed=31)
    epochs, stats = epochs_of(trace, base2)
    r_epochs, r_stats = r_epochs_of(trace, rbase)
    assert stats.n_queries == 7 and stats.n_deltas == 3
    assert stats.n_epochs == 4 and stats.k_hat == pytest.approx(7 / 4)
    assert stats.batches == r_stats.batches == {1: 6, 2: 1}
    for (name, m, q), (r_name, rm, rq) in zip(epochs, r_epochs):
        assert (name, q) == (r_name, rq)
        same_container(rm, m, name)
    np.testing.assert_array_equal(epochs[-1][1].todense(), sm.csr.todense())

    # the replayed epochs are a real offline_phase measurement suite
    _, _, base3 = _problem(seed=31)
    db, rstats = replay_file(path, base3, formats=("sell",), iters=1,
                             machine="trace", device="cpu")
    assert rstats.n_epochs == 4 and rstats.batch == 1
    assert "sell" in db.d_star and db.machine == "trace"
    assert [r.name for r in db.records] == [e[0] for e in epochs]


def test_reference_trace_replays_in_the_port(tmp_path):
    rng, rbase, _ = _problem(seed=33)
    path = str(tmp_path / "ref.jsonl")
    cap = RC.TraceCapture(path, clock=r_obs.FakeClock(tick=1.0))
    sm = RDR.StreamingPlannedMatrix(rbase, RPlanner(), plan_kw={"fmt": "csr"},
                                    capture=cap, key="ref")
    for _ in range(2):
        sm @ rng.normal(size=64).astype(np.float32)
        sm.apply(RD.random_delta(rng, sm.csr, n_appends=1, n_updates=2,
                                 n_deletes=1))
    sm @ rng.normal(size=64).astype(np.float32)
    cap.close()
    _, _, base = _problem(seed=33)
    epochs, stats = epochs_of(load_trace(path), base)
    assert stats.n_epochs == 3 and stats.key == "ref"
    same_container(sm.csr, epochs[-1][1], "last epoch")


# ---------------------------------------------------------------------------
# RPL010: stream artifacts are linted like any other plan JSON
# ---------------------------------------------------------------------------
def test_rpl010_clean_artifacts_pass():
    rng, _, tc = _problem(seed=37)
    delta = random_delta(rng, tc, n_appends=1, n_updates=2, n_deletes=1)
    assert lint_plan(delta.to_dict()) == []
    assert r_lint_plan(delta.to_dict()) == []
    sm = StreamingPlannedMatrix(tc, Planner(device="cpu"),
                                plan_kw={"fmt": "csr"})
    sm.apply(delta)
    for lint in (lint_plan, r_lint_plan):
        findings = lint(sm.to_dict())
        assert not [f for f in findings if f.severity == "error"]


def test_rpl010_flags_malformed_artifacts():
    rng, _, tc = _problem(seed=37)
    bad = DeltaBatch(n_cols=tc.n_cols).to_dict()
    bad["n_cols"] = 0
    errs = [f for f in lint_plan(bad) if f.severity == "error"]
    assert errs and all(f.rule == "RPL010" for f in errs)

    bad2 = random_delta(rng, tc, n_updates=2).to_dict()
    bad2["updates"]["cols"] = [tc.n_cols + 5] * 2
    assert any(f.rule == "RPL010" and f.severity == "error"
               for f in lint_plan(bad2))

    sm = StreamingPlannedMatrix(tc, Planner(device="cpu"),
                                plan_kw={"fmt": "csr"})
    sp = sm.to_dict()
    sp["policy"]["hysteresis"] = 1.5
    sp["sketch"]["hist"] = [1] + sp["sketch"]["hist"][1:]
    rules = {(f.rule, f.severity) for f in lint_plan(sp)}
    assert ("RPL010", "error") in rules
    assert rules == {(f.rule, f.severity) for f in r_lint_plan(sp)}


# ---------------------------------------------------------------------------
# satellites of the reference's streaming tests
# ---------------------------------------------------------------------------
def test_plan_store_lru_eviction(tmp_path, tel):
    import os
    store = PlanStore(str(tmp_path / "plans"), max_entries=3)
    for i, k in enumerate(("a", "b", "c")):
        store.put(k, ExecutionPlan(fmt="csr"))
        os.utime(store.path_for(k), (1000.0 + i, 1000.0 + i))
    assert store.get("a") is not None       # hit refreshes recency to now
    store.put("d", ExecutionPlan(fmt="csr"))
    assert set(store.keys()) == {"a", "c", "d"}   # "b" was coldest
    assert store.evictions == 1
    assert store.stats()["max_entries"] == 3
    assert any(k.startswith("store.evict")
               for k in tel.snapshot()["counters"])
    with pytest.raises(ValueError, match="max_entries"):
        PlanStore(str(tmp_path / "p2"), max_entries=0)


def test_breaker_state_gauge_exports(tel):
    rng, _, tc = _problem(seed=41, shape=(80, 64))
    clk = FakeClock()
    svc = SpMVService(device="cpu", clock=clk, breaker_failures=2,
                      breaker_cooldown_s=10.0)
    svc.register("m", tc, measure_baseline=False)
    x = rng.normal(size=64).astype(np.float32)
    with faults.inject("kernel.raise", prob=1.0):
        for _ in range(2):
            svc.spmv("m", x)

    def gauge_values():
        return {k: v for k, v in tel.snapshot()["gauges"].items()
                if k.startswith("service.breaker_state") and "op=spmv" in k}

    vals = gauge_values()
    assert vals and set(vals.values()) == {float(STATE_CODES[OPEN])}
    g = svc.stats()["m"]["guard"]["spmv"]["breaker"]
    assert g["state_code"] == STATE_CODES[OPEN]
    assert "service_breaker_state" in prometheus_text(tel)

    clk.advance(10.0)
    svc.spmv("m", x)                        # clean half-open probe closes it
    assert set(gauge_values().values()) == {float(STATE_CODES[CLOSED])}


# ---------------------------------------------------------------------------
# what the port adds: K1's extents, launches a bucket, delta-sized reads
# ---------------------------------------------------------------------------
def _bound_sell(seed=51, n_rows=300):
    """A SELL plan bound at the kernel tier (each kernel's plain version
    on the CPU, extents prepared as on the card), on a matrix of rows 2-12
    long: several buckets, the widest 16 wide."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n_rows, 128), np.float32)
    for i in range(n_rows):
        ln = int(rng.integers(2, 13))
        dense[i, rng.choice(128, ln, replace=False)] = rng.normal(size=ln)
    tc = csr_from_dense(dense, pad=8, device="cpu")
    rc = r_csr_from_dense(dense, pad=8)
    planner = Planner(tier="kernel", device="cpu")
    t = StreamingPlannedMatrix(tc, planner, plan_kw={"fmt": "sell"})
    r = RDR.StreamingPlannedMatrix(rc, RPlanner(), plan_kw={"fmt": "sell"})
    return rng, r, t


def _extents_fresh(sell):
    for b in sell.buckets:
        got = ops.ell_extent_of(b)
        assert got is not None, "a bucket was not prepared"
        np.testing.assert_array_equal(got.numpy(),
                                      ell_extent(b.data, b.cols).numpy())


def test_a_delta_widening_a_bound_sell_bucket_keeps_k1_extents_fresh():
    rng, r, t = _bound_sell()
    assert t.bound.tiers["spmv"] == "kernel"
    sell = t.bound.matrix
    widths = sell.widths
    _extents_fresh(sell)
    # a row of the narrowest bucket lengthened past its width (moves to a
    # wider bucket), and a row lengthened past the widest (widens it)
    perm = sell.perm.numpy()
    narrow = int(perm[sell.row_offsets[-1]])
    wide = int(perm[0])
    upd_r, upd_c = [], []
    for row, extra in ((narrow, widths[-1] + 2), (wide, widths[0] + 5)):
        have = set(t.csr.cols[int(t.csr.indptr[row]):
                              int(t.csr.indptr[row + 1])].tolist())
        new = [c for c in range(128) if c not in have][:extra]
        upd_r += [row] * len(new)
        upd_c += new
    kw = dict(n_cols=128, update_rows=np.asarray(upd_r, np.int64),
              update_cols=np.asarray(upd_c, np.int64),
              update_vals=np.ones(len(upd_r), np.float32))
    tres, rres = t.apply(DeltaBatch(**kw)), r.apply(RD.DeltaBatch(**kw))
    same_result(rres, tres)
    assert not tres.fallback and tres.buckets_rebuilt >= 2
    after = t.bound.matrix
    assert after.widths[0] > widths[0]
    _extents_fresh(after)
    x = rng.normal(size=128).astype(np.float32)
    np.testing.assert_allclose((t @ x).numpy(), t.csr.todense() @ x, **TOL)
    # and a value-only delta edits the buckets in place: fresh extents too
    rd, td = delta_pair(700, r.csr, t.csr, n_updates=40)
    same_result(r.apply(rd), t.apply(td))
    _extents_fresh(t.bound.matrix)
    np.testing.assert_allclose((t @ x).numpy(), t.csr.todense() @ x, **TOL)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _stored_updates(csr: CSR, rows):
    """Updates of stored entries (hits) of ``rows``: the first entry of
    each row, given a new value."""
    ip = csr.indptr.numpy()
    cols = csr.cols.numpy()
    rows = np.asarray(rows, np.int64)
    return DeltaBatch(n_cols=csr.n_cols, update_rows=rows,
                      update_cols=cols[ip[rows]].astype(np.int64),
                      update_vals=np.full(rows.shape[0], 0.5, np.float32))


@pytest.mark.parametrize("fmt", list(INCREMENTAL_FORMATS))
def test_an_apply_makes_as_many_ops_for_4_rows_as_for_256(fmt):
    """The edits are batched: the torch ops an apply issues (each a launch
    or more on the card) do not grow with the rows it changes."""
    counts = []
    for n_rows in (4, 256):
        rng, _, t = _bound_sell(seed=53, n_rows=600)
        t = StreamingPlannedMatrix(t.csr, Planner(tier="kernel",
                                                  device="cpu"),
                                   plan_kw={"fmt": fmt})
        # rows of the widest bucket only, so both touch the same buckets
        perm = t.bound.matrix.perm.numpy() if fmt == "sell" \
            else np.arange(t.csr.n_rows)
        delta = _stored_updates(t.csr, np.sort(perm[:n_rows]))
        with _CountOps() as c:
            res = t.apply(delta)
        assert res.mode == "inplace" and not res.fallback
        counts.append(c.n)
        x = rng.normal(size=128).astype(np.float32)
        np.testing.assert_allclose((t @ x).numpy(), t.csr.todense() @ x,
                                   **TOL)
    assert counts[0] == counts[1], counts


def test_an_apply_reads_back_only_delta_sized_arrays(monkeypatch):
    """A delta never brings the matrix to the host: every tensor an apply
    reads back (``.cpu()``, ``.numpy()``) is the size of the delta (the
    edited rows' bounds, probe results, a few flags), for CSR and SELL."""
    rng, _, tc = _problem(seed=61, shape=(2000, 512), density=0.03)
    seen = []
    real_cpu, real_numpy = torch.Tensor.cpu, torch.Tensor.numpy

    def cpu(self, *a, **kw):
        seen.append(self.numel())
        return real_cpu(self, *a, **kw)

    def numpy(self, *a, **kw):
        seen.append(self.numel())
        return real_numpy(self, *a, **kw)

    for fmt in INCREMENTAL_FORMATS:
        sm = StreamingPlannedMatrix(_copy(tc), Planner(tier="kernel",
                                                       device="cpu"),
                                    plan_kw={"fmt": fmt})
        delta = random_delta(rng, sm.csr, n_appends=4, n_updates=16,
                             n_deletes=8)
        seen.clear()
        monkeypatch.setattr(torch.Tensor, "cpu", cpu)
        monkeypatch.setattr(torch.Tensor, "numpy", numpy)
        res = sm.apply(delta)
        monkeypatch.undo()
        assert not res.fallback
        assert seen and max(seen) <= 2 * delta.nnz_delta, (fmt, max(seen))
        assert max(seen) < sm.csr.nnz // 100
