"""Port vs reference: the auto-tuning method, plans, and the whole main path.

Decisions, TuningDB JSON and ExecutionPlan JSON are compared key by key
between ``repro`` (JAX) and ``repro_torch`` (PyTorch, on the CPU here); a
plan or db written by either package loads in the other; and
``Planner(...).plan(csr).bind(csr) @ x`` of both packages is held against
``dense @ x``.
"""
import dataclasses
import json
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import autotune as RA
from repro.core import formats as RF
from repro.core import plan as RPL
from repro.core import suite as RS
from repro.core import transform as RT
from repro.core.kernel_tune import GeometryRecord as RGeoRec
from repro.core.kernel_tune import TileGeometry as RTile
from repro.core.kernel_tune import _structure_sig as r_structure_sig
from repro_torch import api as T_api
from repro_torch import obs as T_obs
from repro_torch.core import autotune as TA
from repro_torch.core import formats as TF
from repro_torch.core import kernel_tune as TKT
from repro_torch.core import plan as TPL
from repro_torch.core import suite as TS
from repro_torch.core import transform as TT

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "plan_good.json"
FORMATS = ("csr", "coo_row", "coo_col", "ell_row", "ell_col", "sell", "ccs",
           "bcsr")
TOL = dict(rtol=2e-4, atol=2e-4)
SPEC_NAMES = [s.name for s in RS.TABLE1]


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def random_dense(rng, n_rows, n_cols, density):
    d = (rng.random((n_rows, n_cols)) < density).astype(np.float32)
    return d * rng.normal(1.0, 1.0, size=d.shape).astype(np.float32)


def same_float(a, b):
    return (a == b) or (isinstance(a, float) and isinstance(b, float)
                        and math.isnan(a) and math.isnan(b))


def assert_decisions_equal(p, r):
    dp, dr = dataclasses.asdict(p), dataclasses.asdict(r)
    assert dp.keys() == dr.keys()
    for k in dp:
        assert same_float(dp[k], dr[k]), (k, dp[k], dr[k])


# ---------------------------------------------------------------------------
# a deterministic "machine": the same fake timings in both packages
# ---------------------------------------------------------------------------
_SPEED = {"CSR": 1.0, "COO": 1.6, "ELL": 0.55, "BucketedELL": 0.7}


def fake_time_fn(fn, m, x, iters=5, **_):
    """Seconds per SpMV as a function of the container's type and stored
    size only — never calls ``fn``."""
    kind = type(m).__name__
    if kind == "ELL":
        stored = int(np.prod(m.data.shape))
    elif kind == "BucketedELL":
        stored = m.padded_nnz()
    else:
        stored = m.nnz
    return 1e-9 * _SPEED[kind] * (stored + 50)


def make_fake_time_host(transforms):
    cost = {"coo_row": 0.2, "coo_col": 2.0, "ell_row": 0.5, "ell_col": 0.8,
            "sell": 1.5, "csr": 0.0}

    def fake_time_host(fn, csr, iters=3):
        name = next(k for k, v in transforms.items() if v is fn)
        return 1e-9 * cost[name] * (csr.nnz + 10)
    return fake_time_host


@pytest.fixture(scope="module")
def both_dbs():
    """offline_phase of both packages on the same suite under the same
    injected timer."""
    names = ["chem_master1", "torso2", "xenon2", "torso3", "poisson3Db",
             "epb2", "viscoplastic2", "memplus"]
    fmts = ("ell_row", "ell_col", "coo_row", "coo_col", "sell")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(RA, "time_fn", fake_time_fn)
        mp.setattr(RA, "time_host", make_fake_time_host(RT.TRANSFORMS_HOST))
        mp.setattr(TA, "time_fn", fake_time_fn)
        mp.setattr(TA, "time_host", make_fake_time_host(TT.TRANSFORMS_HOST))
        ref = RA.offline_phase(RS.paper_suite(scale=0.01, include=names),
                               formats=fmts, c=0.5, machine="fake")
        port = TA.offline_phase(TS.paper_suite(scale=0.01, include=names, device="cpu"),
                                formats=fmts, c=0.5, machine="fake",
                                device="cpu")
    finally:
        mp.undo()
    return ref, port


def test_offline_phase_learns_the_same_d_star(both_dbs):
    ref, port = both_dbs
    assert port.d_star == ref.d_star
    assert any(v > 0 for v in port.d_star.values())
    assert json.loads(port.to_json()) == json.loads(ref.to_json())
    for f in port.d_star:
        assert port.graph(f) == ref.graph(f)


def test_tuning_db_json_loads_in_the_other_package(both_dbs, tmp_path):
    ref, port = both_dbs
    geo = dict(fmt="csr", op="spmv", batch=1, n=100, nnz=900, d_mat=0.3,
               t_best=1e-5, t_default=2e-5, sig=7)
    ref.geometries.append(RGeoRec(
        geometry=RTile(block_rows=64, block_nnz=1024, slabs_per_block=3),
        **geo))
    try:
        in_port = TA.TuningDB.from_json(ref.to_json())
        assert json.loads(in_port.to_json()) == json.loads(ref.to_json())
        back = RA.TuningDB.from_json(in_port.to_json())
        assert json.loads(back.to_json()) == json.loads(ref.to_json())
        g = in_port.best_geometry("csr", 0.25)
        assert g == TKT.TileGeometry(block_rows=64, block_nnz=1024)
        assert g.to_dict() == ref.best_geometry("csr", 0.25).to_dict()
        assert in_port.best_geometry("ell_row", 0.25) is None
    finally:
        ref.geometries.pop()
    path = tmp_path / "db.json"
    port.save(str(path))
    assert json.loads(RA.TuningDB.load(str(path)).to_json()) == \
        json.loads(port.to_json())
    assert TA.TuningDB.load(str(path)).d_star == port.d_star


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_decisions_equal_on_the_same_db_for_every_suite_matrix(both_dbs,
                                                               name):
    ref_db, port_db = both_dbs
    port_db = TA.TuningDB.from_json(ref_db.to_json())   # literally the same
    rspec = next(s for s in RS.TABLE1 if s.name == name)
    tspec = next(s for s in TS.TABLE1 if s.name == name)
    rs = RF.MatrixStats.of(RS.synthesize(rspec, scale=0.02))
    ts = TF.MatrixStats.of(TS.synthesize(tspec, scale=0.02, device="cpu"))
    assert dataclasses.asdict(ts) == dataclasses.asdict(rs)
    for fmt in ("ell_row", "sell", "coo_row"):
        assert_decisions_equal(TA.decide_paper(port_db, ts, fmt=fmt),
                               RA.decide_paper(ref_db, rs, fmt=fmt))
    for kw in ({}, {"expected_iterations": 1}, {"expected_iterations": 10 ** 6},
               {"batch": 8}, {"memory_budget_ratio": 1.5},
               {"formats": ("ell_row", "coo_row")}):
        assert_decisions_equal(TA.decide_generalized(port_db, ts, **kw),
                               RA.decide_generalized(ref_db, rs, **kw))
    consts = dict(stream_bw=2.0e12, gather_bw=1.5e11, val_bytes=4,
                  idx_bytes=4, segment_penalty=2.5)
    for kw in ({}, {"expected_iterations": 3}, {"batch": 16},
               {"formats": ("ell_row", "ell_col", "sell", "coo_row")}):
        assert_decisions_equal(
            TA.decide_cost_model(TA.MachineModel(**consts), ts, **kw),
            RA.decide_cost_model(RA.MachineModel(**consts), rs, **kw))


def test_predict_matches_reference(both_dbs):
    ref, port = both_dbs
    for f in port.d_star:
        for d in (0.01, 0.2, 1.0, 4.0):
            for b in (None, 1, 8):
                assert port.predict(f, d, batch=b) == ref.predict(f, d,
                                                                  batch=b)
    assert port.predict("nope", 0.3) == ref.predict("nope", 0.3)


def test_machine_model_defaults_are_the_h100_data_sheet():
    m = TA.MachineModel()
    assert m.stream_bw == 3.35e12 and m.gather_bw == 3.35e12 / 8
    assert (m.val_bytes, m.idx_bytes, m.segment_penalty) == (4, 4, 3.0)
    st = TF.MatrixStats(n=1000, nnz=9000, mu=9.0, sigma=2.0, d_mat=2 / 9,
                        max_row=14, min_row=3)
    assert m.t_trans("ell_row", st) == 2.0 * m.t_spmv("ell_row", st)
    with pytest.raises(KeyError):
        m.t_spmv("nope", st)


def test_time_fn_and_time_host_on_the_cpu():
    x = torch.ones(1000)
    calls = []

    def fn(v):
        calls.append(1)
        return v * 2

    t = TA.time_fn(fn, x, iters=3, warmup=2)
    assert t > 0 and len(calls) == 5
    assert TA.time_fn(fn, x, iters=1, warmup=0) > 0
    assert TA.time_host(lambda: sum(range(100)), iters=2) > 0


def test_offline_phase_runs_real_timers_with_kernel_impls_on_cpu():
    from repro_torch.kernels import ops
    suite = TS.paper_suite(scale=0.01, include=["wang3", "memplus"], device="cpu")
    db = TA.offline_phase(suite, formats=("ell_row", "sell"), iters=1,
                          spmv_impls=ops.KERNEL_SPMV_IMPLS,
                          machine="kernel-cpu", device="cpu")
    assert set(db.d_star) == {"ell_row", "sell"}
    assert all(set(r.formats) == {"ell_row", "sell"} for r in db.records)
    assert all(m.t_spmv > 0 and m.mem_ratio > 0
               for r in db.records for m in r.formats.values())
    with pytest.raises(ValueError):
        TA.offline_phase(suite, batch=4, spmv_impls={"csr": None},
                         device="cpu")
    with pytest.raises(RuntimeError):
        if not torch.cuda.is_available():
            TA.offline_phase(suite)            # device=None -> the card
        else:
            raise RuntimeError("card present")


# ---------------------------------------------------------------------------
# plans: the fixture, both directions, key by key
# ---------------------------------------------------------------------------
def test_plan_fixture_loads_and_round_trips_like_reference():
    text = FIXTURE.read_text()
    port = TPL.ExecutionPlan.from_json(text)
    ref = RPL.ExecutionPlan.from_json(text)
    raw = json.loads(text)
    assert port.to_dict() == ref.to_dict()
    assert {k: v for k, v in raw.items() if k != "blocks"} == port.to_dict()
    assert port.geometry["spmm"] == TKT.TileGeometry(
        block_rows=256, block_nnz=2048, slabs_per_block=4, block_k=8)
    assert port.fingerprint.sig == 123456789 and port.blocks is None
    assert TPL.ExecutionPlan.from_json(port.to_json()).to_dict() == \
        port.to_dict()
    assert TPL.SCHEMA_VERSION == RPL.SCHEMA_VERSION == 1


def test_tile_geometry_has_exactly_the_reference_fields():
    assert [f.name for f in dataclasses.fields(TKT.TileGeometry)] == \
        [f.name for f in dataclasses.fields(RTile)]
    assert TKT.TileGeometry._KNOBS == RTile._KNOBS
    g = dict(block_rows=8, block_nnz=64, buckets=[[16, {"block_rows": 32}]])
    assert TKT.TileGeometry.from_dict(g).to_dict() == \
        RTile.from_dict(g).to_dict() == g
    with pytest.raises(TypeError):
        TKT.TileGeometry.from_dict({"num_warps": 4})
    with pytest.raises(TypeError):
        RTile.from_dict({"num_warps": 4})


def test_plan_schema_and_payload_errors():
    good = json.loads(FIXTURE.read_text())
    with pytest.raises(TPL.PlanSchemaError):
        TPL.ExecutionPlan.from_dict({**good, "schema_version": 2})
    with pytest.raises(TPL.PlanError):
        TPL.ExecutionPlan.from_dict([1, 2])
    with pytest.raises(TPL.PlanError):
        TPL.ExecutionPlan.from_json("{not json")
    bad = dict(good)
    del bad["fmt"]
    with pytest.raises(TPL.PlanError):
        TPL.ExecutionPlan.from_dict(bad)
    with pytest.raises(TPL.PlanError):
        TPL.apply_transform("nope", None)


@pytest.fixture(scope="module")
def matrix():
    rng = np.random.default_rng(17)
    dense = random_dense(rng, 160, 120, 0.08)
    dense[7, :] = rng.normal(size=120)            # one long row
    x = rng.normal(size=120).astype(np.float32)
    return dense, RT.csr_from_dense(dense, pad=8), \
        TT.csr_from_dense(dense, pad=8, device="cpu"), x


def test_fingerprint_and_structure_sig_match_reference(matrix):
    _, rcsr, tcsr, _ = matrix
    assert TKT._structure_sig(tcsr) == r_structure_sig(rcsr) != 0
    assert TKT._structure_sig(object()) == 0
    assert dataclasses.asdict(TPL.PlanFingerprint.of(tcsr)) == \
        dataclasses.asdict(RPL.PlanFingerprint.of(rcsr))
    fp = TPL.PlanFingerprint.of(tcsr)
    assert fp.matches(tcsr) and fp.matches(fp)
    other = TT.csr_from_dense(np.eye(160, 120, dtype=np.float32), pad=8, device="cpu")
    assert not fp.matches(other)


def plan_kwargs(case):
    return {
        "paper": dict(rule="paper"),
        "paper_sell": dict(rule="paper", formats=("sell",)),
        "generalized": dict(rule="generalized", expected_iterations=10 ** 6),
        "generalized_b8": dict(rule="generalized", batch=8),
        "cost_model": dict(rule="cost_model"),
        **{f"fixed_{f}": dict(fmt=f) for f in FORMATS},
    }[case]


PLAN_CASES = ["paper", "paper_sell", "generalized", "generalized_b8",
              "cost_model"] + [f"fixed_{f}" for f in FORMATS]


@pytest.mark.parametrize("tier", ["reference", "kernel"])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_plans_are_equal_and_bind_in_either_package(both_dbs, matrix, case,
                                                    tier, tmp_path):
    """The main path as a whole, both packages, same inputs."""
    ref_db, port_db = both_dbs
    dense, rcsr, tcsr, x = matrix
    consts = dict(stream_bw=2.0e12, gather_bw=2.5e11)
    kw = plan_kwargs(case)
    rplan = RPL.Planner(db=ref_db, model=RA.MachineModel(**consts),
                        tier=tier).plan(rcsr, **kw)
    tplan = TPL.Planner(db=port_db, model=TA.MachineModel(**consts),
                        tier=tier, device="cpu").plan(tcsr, **kw)
    assert tplan.to_dict() == rplan.to_dict()          # key by key
    assert tplan.tier == tier

    # each package serves its own plan
    P_t = tplan.bind(tcsr, db=port_db, device="cpu")
    P_r = rplan.bind(rcsr, db=ref_db)
    # both ops resolve to the same tier with the same bound geometry
    assert P_t.tiers == P_r.tiers == {"spmv": tier, "spmm": tier}
    assert P_t.fingerprint_matched and P_r.fingerprint_matched
    for op in ("spmv", "spmm"):
        g_t, g_r = P_t.tunings[op], P_r.tunings[op]
        assert (g_t.to_dict() if g_t is not None else None) == \
            (g_r.to_dict() if g_r is not None else None)
    np.testing.assert_allclose(f32(P_t @ torch.from_numpy(x)), dense @ x,
                               **TOL)
    np.testing.assert_allclose(f32(P_r @ jnp.asarray(x)), dense @ x, **TOL)
    np.testing.assert_allclose(f32(P_t @ torch.from_numpy(x)),
                               f32(P_r @ jnp.asarray(x)), **TOL)

    # a plan saved by the reference binds in the port, and the other way
    rpath, tpath = tmp_path / "ref.json", tmp_path / "port.json"
    rplan.save(str(rpath))
    tplan.save(str(tpath))
    from_ref = TPL.ExecutionPlan.load(str(rpath))
    from_port = RPL.ExecutionPlan.load(str(tpath))
    assert from_ref.to_dict() == from_port.to_dict() == rplan.to_dict()
    y1 = from_ref.bind(tcsr, device="cpu") @ torch.from_numpy(x)
    y2 = from_port.bind(rcsr) @ jnp.asarray(x)
    np.testing.assert_allclose(f32(y1), dense @ x, **TOL)
    np.testing.assert_allclose(f32(y2), dense @ x, **TOL)


def test_planned_matrix_serves_spmm_takes_numpy_and_ignores_jit(matrix):
    dense, _, tcsr, x = matrix
    X = np.random.default_rng(5).normal(size=(120, 4)).astype(np.float32)
    for jit in (True, False):
        P = TPL.Planner(tier="kernel", device="cpu").plan(
            tcsr, fmt="ell_col").bind(tcsr, device="cpu", jit=jit)
        assert P.tiers == {"spmv": "kernel", "spmm": "kernel"}
        assert P.fmt == "ell_col" and P.shape == (160, 120)
        assert (P.n_rows, P.n_cols) == (160, 120)
        assert P.device.type == "cpu" and "ell_col" in repr(P)
        np.testing.assert_allclose(f32(P @ x), dense @ x, **TOL)
        np.testing.assert_allclose(f32(P(torch.from_numpy(X))), dense @ X,
                                   **TOL)
        np.testing.assert_allclose(f32(P.spmm(X)), dense @ X, **TOL)
    with pytest.raises(ValueError):
        P.spmv(X)
    with pytest.raises(ValueError):
        P.spmm(x)


def test_build_is_plan_then_bind_on_the_planners_device(matrix):
    dense, _, tcsr, x = matrix
    P = TPL.Planner(rule="cost_model", device="cpu").build(tcsr)
    assert P.plan.rule == "cost_model" and P.plan.machine == "cost_model"
    assert P.tiers["spmv"] == "reference"          # tier="auto", no geometry
    np.testing.assert_allclose(f32(P @ x), dense @ x, **TOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            TPL.Planner(rule="cost_model").build(tcsr)   # device=None


def test_bind_validates_the_source_matrix(matrix):
    _, _, tcsr, _ = matrix
    plan = TPL.Planner(device="cpu").plan(tcsr, fmt="csr")
    bad = dataclasses.replace(tcsr, cols=tcsr.cols.clone())
    bad.cols[0] = 10 ** 6
    with pytest.raises(TF.MatrixValidationError):
        plan.bind(bad, device="cpu")


class FakeTuner:
    """Stands in for the launch-geometry tuner (duck-typed)."""

    def __init__(self, mk_tile, mk_rec):
        self.mk_tile, self.mk_rec = mk_tile, mk_rec
        self.records, self.calls = [], []

    def tune(self, obj, op="spmv", batch=1, impl=None, x=None, stats=None):
        if op == "spmm":
            raise KeyError("no spmm grid")
        self.calls.append((type(obj).__name__, op, batch))
        rec = self.mk_rec(fmt="x", op=op, batch=batch, n=stats.n,
                          nnz=stats.nnz, d_mat=stats.d_mat,
                          geometry=self.mk_tile(block_rows=16, block_nnz=512),
                          t_best=1.0, t_default=2.0)
        self.records.append(rec)
        return rec


def test_planner_uses_a_duck_typed_tuner_like_reference(both_dbs, matrix):
    ref_db, port_db = both_dbs
    dense, rcsr, tcsr, x = matrix
    rt, tt = FakeTuner(RTile, RGeoRec), FakeTuner(TKT.TileGeometry,
                                                  TKT.GeometryRecord)
    rplan = RPL.Planner(db=ref_db, tuner=rt).plan(rcsr, fmt="csr", batch=4)
    tplan = TPL.Planner(db=port_db, tuner=tt, device="cpu").plan(
        tcsr, fmt="csr", batch=4)
    assert tplan.tier == rplan.tier == "kernel"        # tier="auto" + tuner
    assert tplan.to_dict() == rplan.to_dict()
    assert tt.calls == rt.calls == [("CSR", "spmv", 1)]
    assert tplan._mat_cache[0] is tcsr
    P_t = tplan.bind(tcsr, device="cpu")
    P_r = rplan.bind(rcsr)
    assert "_mat_cache" not in tplan.__dict__          # consumed once
    assert P_t.tunings["spmv"].to_dict() == P_r.tunings["spmv"].to_dict()
    assert P_t.tunings["spmv"].block_rows == 16
    assert P_t.tunings["spmv"].slabs_per_block >= 1
    np.testing.assert_allclose(f32(P_t @ x), dense @ x, **TOL)


def test_offline_phase_with_a_tuner_ships_its_records():
    suite = TS.paper_suite(scale=0.01, include=["wang3"], device="cpu")
    from repro_torch.kernels import ops
    tuner = FakeTuner(TKT.TileGeometry, TKT.GeometryRecord)
    db = TA.offline_phase(suite, formats=("ell_row",), iters=1, tuner=tuner,
                          spmv_impls=ops.KERNEL_SPMV_IMPLS, device="cpu")
    assert [c[0] for c in tuner.calls] == ["CSR", "ELL"]
    assert len(db.geometries) == 2
    again = TA.TuningDB.from_json(db.to_json())
    assert again.geometries[0].geometry == tuner.records[0].geometry


def test_bind_on_another_matrix_re_resolves_geometry_like_reference(matrix):
    dense, rcsr, tcsr, x = matrix
    geo = dict(fmt="csr", op="spmv", batch=1, n=50, nnz=400, d_mat=0.4,
               t_best=1e-5, t_default=2e-5, sig=5)
    rdb = RA.TuningDB(machine="m", c=1.0, records=[], d_star={},
                      geometries=[RGeoRec(geometry=RTile(
                          block_rows=32, block_nnz=256, slabs_per_block=9),
                          **geo)])
    tdb = TA.TuningDB.from_json(rdb.to_json())
    rplan = RPL.Planner(db=rdb).plan(rcsr, fmt="csr")
    tplan = TPL.Planner(db=tdb, device="cpu").plan(tcsr, fmt="csr")
    assert tplan.to_dict() == rplan.to_dict()
    assert tplan.geometry["spmv"].block_rows == 32
    other = random_dense(np.random.default_rng(3), 90, 120, 0.1)
    for db_r, db_t in ((rdb, tdb), (None, None)):
        P_r = rplan.bind(RT.csr_from_dense(other, pad=8), db=db_r)
        P_t = tplan.bind(TT.csr_from_dense(other, pad=8, device="cpu"), db=db_t,
                         device="cpu")
        assert not P_t.fingerprint_matched and not P_r.fingerprint_matched
        assert P_t.tunings["spmv"].to_dict() == P_r.tunings["spmv"].to_dict()
        np.testing.assert_allclose(f32(P_t @ x), other @ x, **TOL)


def test_what_is_not_ported_yet_raises_plan_error(matrix):
    """The static plan lint (A12), refused before it was ported, is now on
    by default, as in the reference; hybrid plans, refused before the
    partition subsystem was ported, now plan and bind."""
    dense, rcsr, tcsr, x = matrix
    assert TPL.Planner(lint=True).lint is True
    planner = TPL.Planner(device="cpu")
    assert planner.lint is True
    forced = planner.plan(tcsr, fmt="hybrid")
    assert forced.is_hybrid and forced.fmt == "hybrid"
    assert forced.to_dict() == \
        RPL.Planner().plan(rcsr, fmt="hybrid").to_dict()
    for plan in (planner.plan(tcsr, partition="variance"), forced):
        P = plan.bind(tcsr, device="cpu")
        assert P.fmt == "hybrid" and P.report is not None
        np.testing.assert_allclose(f32(P @ torch.from_numpy(x)), dense @ x,
                                   **TOL)
    with pytest.raises(TPL.PlanError, match="partition"):
        planner.plan(tcsr, max_blocks=4)               # leaf + partition kw
    with pytest.raises(TPL.PlanError):
        planner.plan(tcsr, rule="paper")               # no db
    with pytest.raises(TPL.PlanError):
        planner.plan(tcsr, rule="nope")
    with pytest.raises(TPL.PlanError):
        TPL.Planner(tier="warp", device="cpu").plan(tcsr)


def test_hybrid_plan_round_trips_but_does_not_bind(matrix):
    """A hybrid plan written by the reference round-trips key by key and
    now binds in the port, to the reference's blocks and product."""
    dense, rcsr, tcsr, x = matrix
    rplan = RPL.Planner().plan(rcsr, partition="variance")
    assert rplan.is_hybrid and rplan.blocks
    tplan = TPL.ExecutionPlan.from_json(rplan.to_json())
    assert tplan.to_dict() == rplan.to_dict()
    assert tplan.block_formats() == rplan.block_formats()
    assert {op: {f: g.to_dict() for f, g in per.items()}
            for op, per in tplan.tunings_by_format().items()} == \
        {op: {f: g.to_dict() for f, g in per.items()}
         for op, per in rplan.tunings_by_format().items()}
    P_t = tplan.bind(tcsr, device="cpu")
    P_r = rplan.bind(rcsr)
    assert P_t.fingerprint_matched and P_r.fingerprint_matched
    assert P_t.matrix.formats == P_r.matrix.formats
    assert P_t.matrix.row_offsets == P_r.matrix.row_offsets
    np.testing.assert_array_equal(P_t.matrix.perm.numpy(),
                                  np.asarray(P_r.matrix.perm))
    y_t = f32(P_t @ torch.from_numpy(x))
    np.testing.assert_allclose(y_t, dense @ x, **TOL)
    np.testing.assert_allclose(y_t, f32(P_r @ jnp.asarray(x)), **TOL)


def test_leaf_plan_matches_reference(matrix):
    _, rcsr, tcsr, _ = matrix
    rp = RPL.leaf_plan(rcsr, RF.MatrixStats.of(rcsr), "sell", "paper",
                       batch=2, machine="m", tier="kernel", d_star=0.4)
    tp = TPL.leaf_plan(tcsr, TF.MatrixStats.of(tcsr), "sell", "paper",
                       batch=2, machine="m", tier="kernel", d_star=0.4)
    assert tp.to_dict() == rp.to_dict()
    assert tp.transform.params == {"slice_rows": 128, "width_quantum": 8}


# ---------------------------------------------------------------------------
# telemetry keeps its names; the public surface keeps its names
# ---------------------------------------------------------------------------
def test_telemetry_names_match_reference(both_dbs, matrix):
    from repro import obs as R_obs
    ref_db, port_db = both_dbs
    _, rcsr, tcsr, _ = matrix
    names = {}
    for key, obs_mod, run in (
            ("ref", R_obs, lambda: RPL.Planner(db=ref_db).plan(
                rcsr, rule="paper").bind(rcsr)),
            ("port", T_obs, lambda: TPL.Planner(
                db=port_db, device="cpu").plan(tcsr, rule="paper").bind(
                tcsr, device="cpu"))):
        sink = obs_mod.InMemorySink()
        tel = obs_mod.Telemetry(enabled=True)
        tel.sinks.append(sink)
        prev = obs_mod.set_default(tel)
        try:
            run()
            RT.host_csr_to_ell(rcsr) if key == "ref" else \
                TT.host_csr_to_ell(tcsr)
        finally:
            obs_mod.set_default(prev)
        names[key] = sorted({(r.get("type"), r.get("name"))
                             for r in sink.records})
        assert ("span", "plan.plan") in names[key]
    assert names["port"] == names["ref"]


def test_api_reexports_under_the_reference_names():
    from repro import api as R_api
    assert set(T_api.__all__) - set(R_api.__all__) == {
        "from_numpy", "to_numpy", "default_device"}
    for name in T_api.__all__:
        assert hasattr(T_api, name), name
    import repro_torch
    assert repro_torch.Planner is TPL.Planner
    assert repro_torch.obs is T_obs
    with pytest.raises(AttributeError):
        repro_torch.nope


# ---------------------------------------------------------------------------
# hybrid (partitioned) plans: minted, bound and served like the reference's
# ---------------------------------------------------------------------------
HYBRID_SWEEP = {"fixed_256": ("fixed", {"block_rows": 256}),
                "fixed_1024": ("fixed", {"block_rows": 1024}),
                "balanced_8": ("balanced_nnz", {"n_blocks": 8}),
                "variance_16": ("variance", {"max_blocks": 16,
                                             "min_rows": 64})}


@pytest.fixture(scope="module")
def skewed():
    """A 600-row power-law matrix (heavy rows among short ones) in both
    packages, and its dense form."""
    rm = RS.synthesize_power_law(n=600, alpha=1.5, seed=4,
                                 random_values=True)
    tm = TS.synthesize_power_law(n=600, alpha=1.5, seed=4,
                                 random_values=True, device="cpu")
    return f32(rm.todense()), rm, tm


def rel_err(got, dense, x):
    want = dense.astype(np.float64) @ x.astype(np.float64)
    scale = np.abs(dense.astype(np.float64)) @ np.abs(x.astype(np.float64))
    return float((np.abs(f32(got) - want) / (scale + 1e-30)).max())


@pytest.mark.parametrize("tier", ["reference", "kernel"])
@pytest.mark.parametrize("sweep", sorted(HYBRID_SWEEP))
def test_hybrid_plans_are_equal_and_bind_in_either_package(skewed, sweep,
                                                           tier, tmp_path):
    dense, rm, tm = skewed
    strategy, kw = HYBRID_SWEEP[sweep]
    rplan = RPL.Planner(tier=tier).plan(rm, partition=strategy, **kw)
    tplan = TPL.Planner(tier=tier, device="cpu").plan(tm, partition=strategy,
                                                      **kw)
    assert tplan.to_dict() == rplan.to_dict()
    assert tplan.is_hybrid and tplan.fmt == "hybrid"
    assert tplan.transform.params == {"strategy": strategy,
                                      "sort_rows": strategy == "variance",
                                      **kw}
    rng = np.random.default_rng(3)
    x = rng.normal(size=600).astype(np.float32)
    X = rng.normal(size=(600, 3)).astype(np.float32)
    y_jax = np.asarray(RPL.ExecutionPlan.from_json(tplan.to_json()).bind(
        rm) @ jnp.asarray(x))
    for plan in (tplan, TPL.ExecutionPlan.from_json(rplan.to_json())):
        P = plan.bind(tm, device="cpu")
        assert P.tiers == {"spmv": tier, "spmm": tier}
        assert P.fingerprint_matched and P.matrix.n_blocks == \
            len(plan.blocks)
        assert P.report.n_blocks == len(plan.blocks)
        y = P @ torch.from_numpy(x)
        assert rel_err(y, dense, x) <= 1e-4
        scale = np.abs(dense) @ np.abs(x)
        assert float((np.abs(f32(y) - y_jax) / (scale + 1e-30)).max()) \
            <= 1e-4
        assert rel_err(P @ torch.from_numpy(X), dense, X) <= 1e-4
    path = tmp_path / "hyb.json"
    tplan.save(str(path))
    assert RPL.ExecutionPlan.load(str(path)).to_dict() == rplan.to_dict()


def test_materialize_matches_reference(skewed):
    dense, rm, tm = skewed
    for kw in ({"partition": "variance", "max_blocks": 6, "min_rows": 32},
               {"partition": "fixed", "block_rows": 200},
               {"fmt": "sell"}):
        rplan = RPL.Planner().plan(rm, **kw)
        tplan = TPL.Planner(device="cpu").plan(tm, **kw)
        rh, rrep = rplan.materialize(rm)
        th, trep = tplan.materialize(tm)
        assert th.formats == rh.formats and th.row_offsets == rh.row_offsets
        assert th.identity_perm == rh.identity_perm
        np.testing.assert_array_equal(th.perm.numpy(), np.asarray(rh.perm))
        assert (trep.strategy, trep.n_blocks) == (rrep.strategy,
                                                  rrep.n_blocks)
        assert [(d.fmt, d.rows, d.nnz, d.bytes) for d in trep.decisions] == \
            [(d.fmt, d.rows, d.nnz, d.bytes) for d in rrep.decisions]
        assert TF.memory_bytes(th) == RF.memory_bytes(rh)
        np.testing.assert_allclose(th.todense(), dense, rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(TPL.PlanError, match="re-plan"):
        TPL.Planner(device="cpu").plan(
            tm, partition="fixed", block_rows=100).materialize(
            TT.csr_from_dense(dense[:300], pad=8, device="cpu"))


def test_hybrid_bind_on_another_matrix_re_partitions_like_reference(skewed):
    dense, rm, tm = skewed
    rplan = RPL.Planner(tier="kernel").plan(rm, partition="variance",
                                            max_blocks=6, min_rows=32)
    tplan = TPL.Planner(tier="kernel", device="cpu").plan(
        tm, partition="variance", max_blocks=6, min_rows=32)
    assert tplan.to_dict() == rplan.to_dict()
    other = RS.synthesize_power_law(n=500, alpha=2.0, seed=9,
                                    random_values=True)
    other_t = TS.synthesize_power_law(n=500, alpha=2.0, seed=9,
                                      random_values=True, device="cpu")
    P_r, P_t = rplan.bind(other), tplan.bind(other_t, device="cpu")
    assert not P_t.fingerprint_matched and not P_r.fingerprint_matched
    assert P_t.matrix.formats == P_r.matrix.formats
    assert P_t.matrix.row_offsets == P_r.matrix.row_offsets
    assert P_t.report.n_blocks == P_r.report.n_blocks
    for op in ("spmv", "spmm"):
        g_t, g_r = P_t.tunings[op], P_r.tunings[op]
        assert ({f: g.to_dict() for f, g in g_t.items()} if g_t else None) \
            == ({f: g.to_dict() for f, g in g_r.items()} if g_r else None)
    x = np.random.default_rng(1).normal(size=500).astype(np.float32)
    assert rel_err(P_t @ torch.from_numpy(x), f32(other.todense()), x) \
        <= 1e-4


def test_hybrid_plan_formats_restriction_never_nests(skewed):
    dense, rm, tm = skewed
    kw = dict(partition="variance", formats=("sell", "hybrid"),
              max_blocks=4, min_rows=16)
    tplan = TPL.Planner(device="cpu").plan(tm, **kw)
    assert tplan.to_dict() == RPL.Planner().plan(rm, **kw).to_dict()
    assert set(tplan.block_formats()) <= {"sell", "csr"}
    assert tplan.transform.params["formats"] == ("sell",)
    x = np.random.default_rng(2).normal(size=600).astype(np.float32)
    assert rel_err(tplan.bind(tm, device="cpu") @ torch.from_numpy(x),
                   dense, x) <= 1e-4
    # the strict-JSON artifact: NaN d_star is written as null
    back = TPL.ExecutionPlan.from_json(tplan.to_json())
    assert np.isnan(back.d_star)


def test_hybrid_bind_honors_impls_override(skewed):
    dense, _, tm = skewed
    called = []

    def my_hybrid(m, x):
        called.append(type(m).__name__)
        from repro_torch.partition import spmv_hybrid
        return spmv_hybrid(m, x)

    plan = TPL.Planner(device="cpu").plan(tm, partition="variance",
                                          max_blocks=3, min_rows=16)
    P = plan.bind(tm, impls={"hybrid": my_hybrid}, device="cpu")
    assert P.tiers["spmv"] == "override"
    x = np.random.default_rng(4).normal(size=600).astype(np.float32)
    assert rel_err(P @ torch.from_numpy(x), dense, x) <= 1e-4
    assert called == ["HybridMatrix"]


def _geometry_dbs():
    """The same TuningDB (geometries for CSR, ELL, SELL and COO) in both
    packages."""
    recs = []
    for fmt, geo in (("csr", dict(block_rows=64, block_nnz=512,
                                  slabs_per_block=7)),
                     ("ell_row", dict(block_rows=16)),
                     ("sell", dict(block_rows=32)),
                     ("coo_row", dict(block_nnz=256))):
        for op, batch in (("spmv", 1), ("spmm", 4)):
            g = dict(geo, block_k=8) if op == "spmm" else geo
            recs.append(RGeoRec(geometry=RTile(**g), fmt=fmt, op=op,
                                batch=batch, n=300, nnz=3000, d_mat=0.5,
                                t_best=1e-5, t_default=2e-5, sig=3))
    rdb = RA.TuningDB(machine="geo", c=1.0, records=[], d_star={},
                      geometries=recs)
    return rdb, TA.TuningDB.from_json(rdb.to_json())


def test_tune_blocks_geometry_matches_reference_from_the_same_db(skewed):
    dense, rm, tm = skewed
    rdb, tdb = _geometry_dbs()
    kw = dict(partition="variance", batch=4, max_blocks=8, min_rows=32)
    rplan = RPL.Planner(db=rdb, rule="cost_model").plan(rm, **kw)
    tplan = TPL.Planner(db=tdb, rule="cost_model", device="cpu").plan(tm,
                                                                      **kw)
    assert tplan.tier == rplan.tier == "kernel"       # db with geometries
    assert tplan.to_dict() == rplan.to_dict()
    assert any(bp.plan.geometry for bp in tplan.blocks)
    for op in ("spmv", "spmm"):
        per_t = tplan.tunings_by_format().get(op, {})
        per_r = rplan.tunings_by_format().get(op, {})
        assert {f: g.to_dict() for f, g in per_t.items()} == \
            {f: g.to_dict() for f, g in per_r.items()}
    P_t, P_r = tplan.bind(tm, db=tdb, device="cpu"), rplan.bind(rm, db=rdb)
    for op in ("spmv", "spmm"):
        assert {f: g.to_dict() for f, g in P_t.tunings[op].items()} == \
            {f: g.to_dict() for f, g in P_r.tunings[op].items()}
    X = np.random.default_rng(5).normal(size=(600, 4)).astype(np.float32)
    assert rel_err(P_t @ torch.from_numpy(X), dense, X) <= 1e-4


class DeviceTuner(FakeTuner):
    """The duck-typed tuner, also recording where each block lay."""

    def __init__(self):
        super().__init__(TKT.TileGeometry, TKT.GeometryRecord)
        self.devices = []

    def tune(self, obj, op="spmv", batch=1, impl=None, x=None, stats=None):
        self.devices.append(obj.device.type)
        stats = stats or TF.MatrixStats(n=obj.n_rows, nnz=obj.nnz, mu=1.0,
                                        sigma=0.0, d_mat=0.0, max_row=1,
                                        min_row=1)
        return super().tune(obj, op=op, batch=batch, stats=stats)


def test_tune_blocks_tunes_the_biggest_block_of_each_format(skewed):
    dense, _, tm = skewed
    tuner = DeviceTuner()
    plan = TPL.Planner(tuner=tuner, device="cpu").plan(
        tm, partition="variance", max_blocks=8, min_rows=32)
    fmts = set(plan.block_formats())
    assert len(tuner.calls) == len(fmts)              # one search a format
    assert set(tuner.devices) == {"cpu"}
    assert all(bp.plan.geometry["spmv"].block_rows == 16
               for bp in plan.blocks)
    assert all(bp.plan.tier == "kernel" for bp in plan.blocks)
    x = np.random.default_rng(6).normal(size=600).astype(np.float32)
    P = plan.bind(tm, device="cpu")
    assert set(P.tunings["spmv"]) == fmts
    assert rel_err(P @ torch.from_numpy(x), dense, x) <= 1e-4


def test_the_generalized_rule_may_choose_hybrid_like_reference(skewed):
    """A TuningDB in which hybrid wins makes the generalized rule mint a
    hybrid plan under the Planner's strategy, in both packages."""
    dense, rm, tm = skewed
    fm = {f: dict(t_spmv=1e-5, t_trans=1e-4, sp=sp, tt=0.5, r=sp / 0.5,
                  mem_ratio=1.0)
          for f, sp in (("ell_row", 0.5), ("sell", 1.1), ("hybrid", 3.0))}
    recs = [dict(name="m", n=600, nnz=5000, mu=8.0, sigma=8.0 * d,
                 d_mat=d, t_crs=1e-5, batch=1, formats=fm)
            for d in (0.3, 1.0, 3.0)]
    text = json.dumps({"machine": "h", "c": 1.0, "records": recs,
                       "d_star": {"ell_row": 0.0, "sell": 3.0,
                                  "hybrid": 3.0}, "geometries": []})
    rdb, tdb = RA.TuningDB.from_json(text), TA.TuningDB.from_json(text)
    rplan = RPL.Planner(db=rdb, rule="generalized").plan(rm)
    tplan = TPL.Planner(db=tdb, rule="generalized", device="cpu").plan(tm)
    assert tplan.fmt == "hybrid" and tplan.blocks
    assert tplan.transform.params["strategy"] == "variance"
    assert tplan.to_dict() == rplan.to_dict()
    x = np.random.default_rng(7).normal(size=600).astype(np.float32)
    assert rel_err(tplan.bind(tm, db=tdb, device="cpu") @
                   torch.from_numpy(x), dense, x) <= 1e-4
    other = TPL.Planner(db=tdb, rule="generalized", strategy="fixed",
                        device="cpu").plan(tm)
    assert other.transform.params["strategy"] == "fixed"


# ---------------------------------------------------------------------------
# the deprecated AutoTunedSpMV shim
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def shim_db():
    return TA.offline_phase(
        TS.paper_suite(scale=0.004, include=["wang3", "memplus", "torso2"],
                       device="cpu"),
        formats=("ell_row", "sell", "coo_row"), iters=1, machine="test",
        device="cpu")


def test_autotuned_spmv_warns_and_matches_reference(matrix, shim_db):
    dense, rcsr, tcsr, x = matrix
    with pytest.warns(DeprecationWarning, match="Planner"):
        op = T_api.AutoTunedSpMV(tcsr, db=shim_db, rule="paper",
                                 device="cpu")
    np.testing.assert_allclose(f32(op(torch.from_numpy(x))), dense @ x,
                               **TOL)
    assert isinstance(op.plan, TPL.ExecutionPlan)
    assert op.decision.fmt == op.plan.fmt and op.decision.rule == "paper"
    assert op.matrix is op.bound.matrix and op.csr is tcsr
    assert dataclasses.asdict(op.stats) == dataclasses.asdict(
        TF.MatrixStats.of(tcsr))
    X = np.random.default_rng(8).normal(size=(120, 3)).astype(np.float32)
    np.testing.assert_allclose(f32(op(torch.from_numpy(X))), dense @ X,
                               **TOL)
    rdb = RA.TuningDB.from_json(shim_db.to_json())
    with pytest.warns(DeprecationWarning):
        rop = RA.AutoTunedSpMV(rcsr, db=rdb, rule="paper")
    assert op.plan.to_dict() == rop.plan.to_dict()


def test_autotuned_spmv_picks_up_tuned_geometry(matrix):
    import warnings
    dense, _, tcsr, x = matrix
    tuner = FakeTuner(TKT.TileGeometry, TKT.GeometryRecord)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        op = T_api.AutoTunedSpMV(tcsr, db=None, tuner=tuner, device="cpu")
    assert op.plan.tier == "kernel" and op.plan.rule == "cost_model"
    assert "spmv" in op.plan.geometry
    np.testing.assert_allclose(f32(op(torch.from_numpy(x))), dense @ x,
                               **TOL)


@pytest.mark.parametrize("rule", ["paper", "generalized", "none"])
def test_autotuned_spmv_end_to_end(shim_db, rule):
    import warnings
    rng = np.random.default_rng(12)
    dense = random_dense(rng, 96, 96, 0.1)
    m = TT.csr_from_dense(dense, pad=8, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        op = T_api.AutoTunedSpMV(m, db=None if rule == "none" else shim_db,
                                 rule=rule, device="cpu")
    assert op.plan.rule == {"none": "cost_model"}.get(rule, rule)
    x = rng.normal(size=96).astype(np.float32)
    np.testing.assert_allclose(f32(op(torch.from_numpy(x))), dense @ x,
                               **TOL)


def test_core_exports_like_reference():
    from repro import core as R_core
    from repro_torch import core as T_core
    for name in ("AutoTunedSpMV", "KernelTuner", "candidate_geometries"):
        assert hasattr(R_core, name) and hasattr(T_core, name), name
    assert T_core.AutoTunedSpMV is TA.AutoTunedSpMV is T_api.AutoTunedSpMV
    assert "AutoTunedSpMV" in T_api.__all__


def test_bind_after_plan_reuses_the_planners_hybrid_container(skewed):
    """``plan(csr)`` then ``bind(csr)`` on the same source object binds the
    container the planner built (no second partition and transform),
    once; another bind, or another source object, materializes anew."""
    dense, _, tm = skewed
    planner = TPL.Planner(device="cpu")
    plan = planner.plan(tm, partition="variance", max_blocks=6, min_rows=32)
    hyb, report = plan._mat_cache[1]
    P1 = plan.bind(tm, device="cpu")
    assert P1.report is report and "_mat_cache" not in plan.__dict__
    assert P1.matrix.perm is hyb.perm
    P2 = plan.bind(tm, device="cpu")
    assert P2.report is not report
    other = dataclasses.replace(tm, data=tm.data.clone())
    plan3 = planner.plan(tm, partition="variance", max_blocks=6,
                         min_rows=32)
    _, report3 = plan3._mat_cache[1]
    P3 = plan3.bind(other, device="cpu")
    assert P3.report is not report3 and "_mat_cache" not in plan3.__dict__
    x = np.random.default_rng(9).normal(size=600).astype(np.float32)
    for P in (P1, P2, P3):
        assert P.matrix.formats == P1.matrix.formats
        assert rel_err(P @ torch.from_numpy(x), dense, x) <= 1e-4
