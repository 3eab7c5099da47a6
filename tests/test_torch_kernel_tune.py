"""Port vs reference: the launch-geometry tuner (``KernelTuner``) — the
fake-timer cases of ``tests/test_kernel_tune.py`` for the formats the port
has kernels for, its records in the reference's ``TuningDB``, and the
planner handing the tuner the matrix on the planner's own device.

The candidate grids differ by design (the port searches CUDA launch knobs,
the reference TPU tiles); what must agree is the search's behaviour — memo,
forced re-tune, per-bucket SELL records — and the JSON the records make.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import autotune as RA
from repro.core import kernel_tune as RKT
from repro.kernels.csr_spmv import slabs_needed as ref_slabs_needed
from repro_torch import api as T_api
from repro_torch.core import autotune as TA
from repro_torch.core import dispatch as TD
from repro_torch.core import plan as TPL
from repro_torch.core import transform as TT
from repro_torch.core.formats import MatrixStats
from repro_torch.core.kernel_tune import (GPU_NNZ_TILES, GRID_FORMATS,
                                          GeometryRecord,
                                          KernelTuner, TileGeometry,
                                          candidate_geometries,
                                          nearest_geometry)
from repro_torch.kernels import _common as C

FORMATS = ("csr", "coo_row", "coo_col", "ell_row", "ell_col", "sell", "ccs",
           "bcsr")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    dense = ((rng.random((150, 120)) < 0.1) *
             rng.normal(size=(150, 120))).astype(np.float32)
    return dense, TT.csr_from_dense(dense, pad=8, device="cpu")


def fake_timer(prefer_rows=32, prefer_nnz=1024, prefer_k=8):
    """Deterministic cost model: still executes each candidate once (so the
    sweep validates every launch), but 'times' it by geometry alone."""
    calls = []

    def timer(thunk, g):
        thunk()
        calls.append(g)
        if g is None:
            return 1.0
        cost = 0.5
        cost += abs((g.block_rows or prefer_rows) - prefer_rows) * 1e-3
        cost += abs((g.block_nnz or prefer_nnz) - prefer_nnz) * 1e-6
        cost += abs((g.block_k or prefer_k) - prefer_k) * 1e-4
        return cost

    timer.calls = calls
    return timer


def empty_db(db_mod):
    return db_mod.TuningDB(machine="t", c=1.0, records=[], d_star={})


# ---------------------------------------------------------------------------
# candidate grids
# ---------------------------------------------------------------------------
def test_candidates_bounded_and_deduped():
    assert set(GRID_FORMATS) == set(FORMATS) == set(RKT.GRID_FORMATS)
    assert T_api.GRID_FORMATS is GRID_FORMATS
    for fmt in GRID_FORMATS:
        for op in ("spmv", "spmm"):
            cands = candidate_geometries(fmt, op, n_rows=150, width=20,
                                         nnz_pad=1800, batch=16)
            assert 0 < len(cands) <= 40, (fmt, op, len(cands))
            assert len(cands) == len(set(cands)), (fmt, op)
            for g in cands:
                assert g.block_w is None and g.slabs_per_block is None
                assert (g.block_k is not None) == (op == "spmm")
    # CCS SpMV searches columns per block in whole runs of two columns or
    # more for up to 8 warps (at most about the 150 columns), BCSR SpMV block
    # rows of
    # b = 8 rows
    # (whole warps: at least 4), BCSR SpMM block-row groups at the RHS
    # tile's lanes; a container without a kernel of its own has no grid
    def rows(fmt, op, **kw):
        return [g.block_rows for g in candidate_geometries(
            fmt, op, n_rows=150, nnz_pad=1800, **kw)]
    assert rows("ccs", "spmv") == [16, 32, 64, 128, 152]
    assert rows("bcsr", "spmv", width=8) == [4, 8, 16, 32, 64, 128]
    assert rows("bcsr", "spmv", width=16) == [2, 4, 8, 16, 32, 64]
    assert [(g.block_rows, g.block_k) for g in candidate_geometries(
        "bcsr", "spmm", n_rows=20, batch=16)] == [
            (4, 8), (8, 8), (16, 8), (20, 8),
            (2, 16), (4, 16), (8, 16), (16, 16), (20, 16)]
    assert candidate_geometries("ccs", "spmm", n_rows=150, nnz_pad=1800,
                                batch=16) == candidate_geometries(
        "csr", "spmm", n_rows=150, nnz_pad=1800, batch=16)
    assert candidate_geometries("hybrid", "spmv") == []
    assert candidate_geometries("hybrid", "spmm", batch=8) == []


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("op,batch", [("spmv", 1), ("spmm", 3),
                                      ("spmm", 128)])
def test_candidates_are_launches_a_wrapper_makes(fmt, op, batch):
    """Each candidate is what its launch takes: at most 1024 threads at the
    wrapper's lane count, at most the matrix's rows or entries, a column
    tile no wider than the batch."""
    n_rows, width, nnz_pad = 20, 150, 1800
    cands = candidate_geometries(fmt, op, n_rows=n_rows, width=width,
                                 nnz_pad=nnz_pad, batch=batch)
    for g in cands:
        if op == "spmm":
            kt, lanes, _ = C.rhs_tile(batch, g.block_k)
            assert g.block_k == kt <= batch
        else:
            lanes = {"ell_row": 32, "sell": 32}.get(fmt, 1)
        if fmt.startswith("coo") or (fmt, op) == ("csr", "spmv"):
            # entries per block: COO, and CSR SpMV's slices
            assert g.block_rows is None and g.block_nnz <= nnz_pad
        elif fmt == "ccs" and op == "spmv":
            # columns per block in whole runs a warp, about the column count
            threads, cols, _, _ = C.ccs_spmv_launch(n_rows, n_rows, nnz_pad,
                                                    g.block_rows)
            assert cols == g.block_rows and threads <= 1024
            assert g.block_rows < n_rows + threads // 32
        elif fmt == "bcsr" and op == "spmv":
            # a thread per scalar row, ``width`` the block size b
            threads, rows = C.bcsr_spmv_launch(width, g.block_rows)
            assert rows == g.block_rows <= n_rows
            assert g.block_rows * width <= threads <= 1024
        elif (fmt, op) == ("bcsr", "spmm") and C.bcsr_spmm_mma(
                batch, width, g.block_k):
            # block rows a tensor-core block owns, a warp each
            assert_bcsr_mma_candidate(g, batch, width, n_rows)
        elif (fmt, op) == ("csr", "spmm") and C.csr_spmm_window(
                batch, g.block_k):
            # rows a block owns beside its window of X rows, at most the
            # matrix's rows, walked by up to 256 threads
            _, _, _, threads, rows, window, _ = C.csr_spmm_launch(
                batch, n_rows, width, nnz_pad, g.block_rows, g.block_k)
            assert g.block_nnz is None and window > 0
            assert rows == g.block_rows <= n_rows and threads <= 256
        else:
            assert g.block_nnz is None
            assert g.block_rows * lanes == C.clamp_threads(
                g.block_rows * lanes) <= 1024
            assert g.block_rows * lanes <= max(32, n_rows * lanes + 31)


def assert_bcsr_mma_candidate(g, batch, block, n_rows):
    """A BCSR SpMM candidate of the tensor-core kernel: block rows a CUDA
    block owns, at most ``BCSR_MMA_ROWS`` and the block-row count, as
    ``bcsr_spmm_launch`` takes them."""
    assert g.block_nnz is None
    assert 1 <= g.block_rows <= min(C.BCSR_MMA_ROWS, n_rows)
    kt, threads, rows, _, _ = C.bcsr_spmm_launch(batch, block, g.block_rows,
                                                 g.block_k)
    assert rows == g.block_rows and kt == g.block_k
    assert threads == 32 * min(rows, C.BCSR_MMA_WARPS)


@pytest.mark.parametrize("n_rows", [3, 20])
@pytest.mark.parametrize("batch", [3, 32, 64, 128, 200])
@pytest.mark.parametrize("block", [3, 4, 8, 16])
def test_bcsr_spmm_candidates_follow_the_kernel_they_launch(block, batch,
                                                            n_rows):
    """BCSR SpMM candidates at tiles where the wrapper runs the tensor-core
    kernel are its block rows a CUDA block (up to ``BCSR_MMA_ROWS``, the
    default among them); at narrower tiles and other b, lane groups of
    whole warps, as for the first port's kernel."""
    cands = candidate_geometries("bcsr", "spmm", n_rows=n_rows, width=block,
                                 batch=batch)
    assert cands
    mma = [g for g in cands if C.bcsr_spmm_mma(batch, block, g.block_k)]
    for g in mma:
        assert_bcsr_mma_candidate(g, batch, block, n_rows)
    for g in cands:
        if g not in mma:
            kt, lanes, _ = C.rhs_tile(batch, g.block_k)
            assert g.block_k == kt <= batch
            assert g.block_rows * lanes == C.clamp_threads(
                g.block_rows * lanes) <= 1024
    if block in C.BCSR_MMA_BLOCKS and batch >= C.BCSR_MMA_MIN_COLS:
        assert min(C.BCSR_MMA_ROWS, n_rows) in {g.block_rows for g in mma}
    else:
        assert not mma


@pytest.mark.parametrize("fmt", ["coo_row", "coo_col"])
@pytest.mark.parametrize("op,batch", [("spmv", 1), ("spmm", 8),
                                      ("spmm", 128)])
def test_coo_candidates_are_distinct_launches_and_load_in_reference(
        problem, fmt, op, batch):
    """Each COO candidate is one launch of the wrapper's helper — threads,
    entries per block and entries per thread (SpMV) or per lane group
    (SpMM) — no two the same, and the tuner's COO records load in the
    reference's ``TuningDB``."""
    from repro_torch.kernels.coo_spmv import coo_spmm_launch
    _, m = problem
    obj = TT.TRANSFORMS_HOST[fmt](m)

    def launch(g):
        if op == "spmv":
            return C.coo_launch(g.block_nnz)
        return coo_spmm_launch(batch, g.block_nnz, g.block_k)

    for nnz_pad in (obj.nnz_pad, 10 ** 6):
        cands = candidate_geometries(fmt, op, n_rows=obj.n_rows,
                                     nnz_pad=nnz_pad, batch=batch)
        launches = [launch(g) for g in cands]
        assert len(set(launches)) == len(cands) > 0
        for g, shape in zip(cands, launches):
            bn = shape[1] if op == "spmv" else shape[4]
            assert bn == g.block_nnz <= nnz_pad
            if op == "spmm":
                assert shape[0] == g.block_k
    assert len(cands) == len(GPU_NNZ_TILES) * (1 if op == "spmv" else 3
                                               if batch > 8 else 1)
    db = empty_db(TA)
    rec = KernelTuner(db=db, timer=fake_timer()).tune(obj, op=op,
                                                      batch=batch)
    ref = RA.TuningDB.from_json(db.to_json())
    assert json.loads(ref.to_json()) == json.loads(db.to_json())
    got = ref.best_geometry(fmt, rec.d_mat, op=op, batch=batch)
    assert got.to_dict() == rec.geometry.to_dict()
    assert rec.geometry in candidate_geometries(
        fmt, op, n_rows=obj.n_rows, nnz_pad=obj.nnz_pad, batch=batch)


# ---------------------------------------------------------------------------
# deterministic tuning + memoization
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("op,batch", [("spmv", 1), ("spmm", 16)])
def test_tune_is_deterministic_with_fake_timer(problem, fmt, op, batch):
    _, m = problem
    obj = TT.TRANSFORMS_HOST[fmt](m)
    recs = [KernelTuner(timer=fake_timer(), interpret=True).tune(
        obj, op=op, batch=batch) for _ in range(2)]
    assert recs[0].fmt == fmt and recs[0].op == op
    assert recs[0].batch == batch
    assert recs[0].geometry == recs[1].geometry
    assert recs[0].t_best <= recs[0].t_default
    assert recs[0].speedup >= 1.0
    if op == "spmm" and fmt != "sell":
        assert recs[0].geometry.block_k == 8     # the timer's preference


def test_tune_memoizes_per_profile(problem):
    _, m = problem
    timer = fake_timer()
    tuner = KernelTuner(timer=timer)
    r1 = tuner.tune(m)
    n_timed = len(timer.calls)
    r2 = tuner.tune(m)
    assert r2 is r1 and len(timer.calls) == n_timed  # no re-timing
    assert tuner.best(m) == r1.geometry


def test_csr_winner_carries_the_reference_slab_bound(problem):
    """CSR SpMV tunes its slice (entries per block); the winner carries the
    reference's slab bound for that block_nnz and the reference's default
    rows per block."""
    _, m = problem
    rec = KernelTuner(timer=fake_timer()).tune(m)
    g = rec.geometry
    ip = m.indptr.numpy()
    assert g.block_rows is None and g.block_nnz is not None
    assert g.slabs_per_block == ref_slabs_needed(ip, 256, g.block_nnz)


def test_force_retune_replaces_record_in_place(problem):
    _, m = problem
    db = empty_db(TA)
    tuner = KernelTuner(db=db, timer=fake_timer(prefer_nnz=256))
    r1 = tuner.tune(m)
    assert r1.geometry.block_nnz == 256
    tuner._timer = fake_timer(prefer_nnz=1024)
    r2 = tuner.tune(m, force=True)
    assert r2.geometry.block_nnz == 1024
    assert len(db.geometries) == 1, "re-tune must not accumulate duplicates"
    db2 = TA.TuningDB.from_json(db.to_json())
    assert len(db2.geometries) == 1
    assert db2.geometries[0].geometry == r2.geometry
    assert nearest_geometry(db2.geometries, "csr", "spmv",
                            d_mat=r2.d_mat).block_nnz == 1024


def test_legacy_duplicate_records_healed_on_load():
    mk = lambda rows: GeometryRecord(
        fmt="csr", op="spmv", batch=1, n=100, nnz=1000, d_mat=1.0,
        geometry=TileGeometry(block_rows=rows), t_best=1.0, t_default=2.0,
        sig=7)
    db = TA.TuningDB(machine="t", c=1.0, records=[], d_star={},
                     geometries=[mk(64), mk(256)])   # stale loser first
    tuner = KernelTuner(db=db)
    assert len(db.geometries) == 1
    assert db.geometries[0].geometry.block_rows == 256
    assert tuner.best(fmt="csr", d_mat=1.0).block_rows == 256


# ---------------------------------------------------------------------------
# per-bucket SELL geometry
# ---------------------------------------------------------------------------
def sell_problem():
    """32 long rows (~60 nnz) + 64 short rows (~10 nnz): two SELL buckets
    of different widths and different row counts."""
    rng = np.random.default_rng(5)
    dense = np.zeros((96, 128), np.float32)
    for r in range(32):
        dense[r, rng.choice(128, size=60, replace=False)] = rng.normal(
            size=60)
    for r in range(32, 96):
        dense[r, rng.choice(128, size=10, replace=False)] = rng.normal(
            size=10)
    m = TT.csr_from_dense(dense, pad=8, device="cpu")
    return dense, TT.host_csr_to_sell(m, slice_rows=32, width_quantum=8)


def test_sell_buckets_record_distinct_geometries():
    """Each bucket gets its own sweep; a timer that prefers the most rows
    per block a launch allows must record each bucket's own row count,
    composed into the aggregate's table and persisted through the db."""
    from repro_torch.kernels import ops
    dense, sell = sell_problem()
    assert len(sell.buckets) >= 2
    db = empty_db(TA)
    tuner = KernelTuner(db=db, timer=lambda thunk, g: (
        thunk(), 1.0 if g is None else 0.5 - (g.block_rows or 0) * 1e-3)[1])
    rec = tuner.tune(sell)
    comps = {g.bucket_w: g for g in db.geometries
             if g.fmt == "sell" and g.bucket_w is not None}
    assert set(comps) == set(sell.widths)
    winners = {w: comps[w].geometry for w in comps}
    assert len(set(winners.values())) >= 2
    for b in sell.buckets:
        assert winners[b.width].block_rows == b.n_rows
    assert dict(rec.geometry.buckets) == winners
    nn = nearest_geometry(db.geometries, "sell", "spmv", d_mat=rec.d_mat)
    assert nn is not None and nn.buckets is not None
    db2 = TA.TuningDB.from_json(db.to_json())
    g2 = KernelTuner(db=db2).best(sell)
    assert g2 == rec.geometry
    x = np.random.default_rng(1).normal(size=128).astype(np.float32)
    got = ops.spmv_sell(sell, torch.from_numpy(x), tuning=g2)
    np.testing.assert_allclose(got.numpy(), dense @ x, rtol=2e-4, atol=2e-4)


def test_sell_tune_memoizes_per_bucket():
    _, sell = sell_problem()
    timer = fake_timer()
    tuner = KernelTuner(timer=timer)
    r1 = tuner.tune(sell, op="spmm", batch=4)
    n_timed = len(timer.calls)
    r2 = tuner.tune(sell, op="spmm", batch=4)
    assert r2 is r1 and len(timer.calls) == n_timed


# ---------------------------------------------------------------------------
# persistence: the port's records in both packages' TuningDB
# ---------------------------------------------------------------------------
def test_tuner_records_load_in_the_reference(problem):
    _, m = problem
    db = empty_db(TA)
    tuner = KernelTuner(db=db, timer=fake_timer())
    recs = [tuner.tune(m), tuner.tune(m, op="spmm", batch=16),
            tuner.tune(TT.host_csr_to_sell(m, slice_rows=32), op="spmm",
                       batch=16)]
    text = db.to_json()
    ref = RA.TuningDB.from_json(text)
    assert json.loads(ref.to_json()) == json.loads(text)
    assert len(ref.geometries) == len(db.geometries) > len(recs)
    for op, batch in (("spmv", 1), ("spmm", 16)):
        want = db.best_geometry("csr", recs[0].d_mat, op=op, batch=batch)
        got = ref.best_geometry("csr", recs[0].d_mat, op=op, batch=batch)
        assert got.to_dict() == want.to_dict()
    # a reference tuner seeded from that db answers from its memo
    assert RKT.KernelTuner(db=ref).best(fmt="csr", d_mat=recs[0].d_mat) \
        .to_dict() == recs[0].geometry.without_slab_bound().to_dict()
    back = TA.TuningDB.from_json(ref.to_json())
    assert KernelTuner(db=back).best(m) == recs[0].geometry


def test_tuningdb_json_backcompat():
    obj = json.loads(empty_db(TA).to_json())
    obj.pop("geometries")
    assert TA.TuningDB.from_json(json.dumps(obj)).geometries == []


def test_nearest_geometry_is_dmat_keyed_and_prefers_batch_match():
    mk = lambda d, rows, b=1, op="spmv": GeometryRecord(
        fmt="ell_row", op=op, batch=b, n=100, nnz=1000, d_mat=d,
        geometry=TileGeometry(block_rows=rows, slabs_per_block=7),
        t_best=1.0, t_default=2.0)
    recs = [mk(0.05, 8), mk(3.0, 256)]
    assert nearest_geometry(recs, "ell_row", "spmv", d_mat=0.08) \
        .block_rows == 8
    high = nearest_geometry(recs, "ell_row", "spmv", d_mat=2.0)
    assert high.block_rows == 256 and high.slabs_per_block is None
    assert nearest_geometry(recs, "coo_row", "spmv", d_mat=1.0) is None
    recs = [mk(1.0, 8, 8, "spmm"), mk(1.0, 256, 128, "spmm")]
    assert nearest_geometry(recs, "ell_row", "spmm", d_mat=1.0,
                            batch=128).block_rows == 256


# ---------------------------------------------------------------------------
# the tuner on the main path
# ---------------------------------------------------------------------------
def test_real_timer_times_host_launches_on_the_cpu(problem):
    _, m = problem
    rec = KernelTuner(iters=1, warmup=1, max_candidates=2).tune(
        TT.host_csr_to_coo_row(m), op="spmm", batch=4)
    assert 0 < rec.t_best <= rec.t_default < 10
    assert rec.geometry.block_k in (None, 4)


class _FakeEvent:
    """Stands in for ``torch.cuda.Event``: the start event counts as fired
    before the host is done enqueuing while the spin is under ``needed``."""
    needed = 0
    spin = 0

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def query(self):
        return _FakeEvent.spin < _FakeEvent.needed

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 6.0


@pytest.mark.parametrize("needed_spins", [1, 4, 10 ** 6])
def test_device_timer_spins_until_the_host_has_enqueued(monkeypatch,
                                                        needed_spins):
    """The head start doubles while the start event fires before the host
    has enqueued the timed call (the events would then time the host), up
    to its cap; the result is the events' time."""
    spins = []

    def sleep(cycles):
        spins.append(cycles)
        _FakeEvent.spin = cycles

    monkeypatch.setattr(torch.cuda, "_sleep", sleep)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "needed",
                        needed_spins * TA.HEAD_START_CYCLES)
    ran, before = [], []
    t = TA.time_device(lambda: ran.append(1),
                       before=lambda: before.append(1))
    assert spins[0] == TA.HEAD_START_CYCLES
    assert all(b == 2 * a for a, b in zip(spins, spins[1:]))
    assert spins[-1] == min(max(TA.HEAD_START_CYCLES,
                                _FakeEvent.needed),
                            TA.MAX_HEAD_START_CYCLES)
    assert len(before) == len(spins) == len(ran)
    assert t == pytest.approx(6e-3)


def test_dispatch_tuning_hint_reaches_the_kernel_tier(problem):
    dense, m = problem
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(120, 5)).astype(np.float32))
    g = TileGeometry(block_rows=64, block_nnz=1024, block_k=8)
    for tier in ("kernel", "reference"):
        got = TD.spmm(m, x, tier=tier, tuning=g)
        np.testing.assert_allclose(got.numpy(), dense @ x.numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("batch", [1, 8])
def test_offline_phase_records_geometries(problem, batch):
    from repro_torch.kernels import ops
    _, m = problem
    tuner = KernelTuner(timer=fake_timer())
    impls = ({"spmv_impls": ops.KERNEL_SPMV_IMPLS} if batch == 1
             else {"spmm_impls": ops.KERNEL_SPMM_IMPLS})
    db = TA.offline_phase([("m0", m)], formats=("ell_row",), iters=1,
                          tuner=tuner, machine="fake", batch=batch,
                          device="cpu", **impls)
    op = "spmv" if batch == 1 else "spmm"
    assert {(g.fmt, g.op, g.batch) for g in db.geometries} == \
        {("csr", op, batch), ("ell_row", op, batch)}
    assert db.best_geometry("ell_row", d_mat=1.0, op=op,
                            batch=batch) is not None


class DeviceSpy:
    """A tuner that records where (and in what type) it was handed the
    matrix."""

    def __init__(self):
        self.records, self.seen = [], []

    def tune(self, obj, op="spmv", batch=1, impl=None, x=None, stats=None):
        self.seen.append((op, obj.device, obj.data.dtype))
        raise KeyError("records nothing")


@pytest.mark.parametrize("fmt", ["csr", "ell_row", "coo_row"])
def test_planner_tunes_on_the_planners_device(problem, fmt):
    """The tuner gets the transformed matrix where the plan will serve
    (``meta`` stands in for the card here), not the host recipe's CPU
    tensors."""
    _, m = problem
    spy = DeviceSpy()
    plan = TPL.Planner(tuner=spy, device="meta").plan(m, fmt=fmt, batch=8)
    assert plan.geometry == {}
    assert spy.seen == [("spmv", torch.device("meta"), torch.float32),
                        ("spmm", torch.device("meta"), torch.float32)]
    assert plan._mat_cache[1].device == torch.device("meta")


@pytest.mark.parametrize("fmt", FORMATS)
def test_planner_with_a_kernel_tuner_serves_the_batched_path(problem, fmt):
    dense, m = problem
    db = empty_db(TA)
    tuner = T_api.KernelTuner(db, timer=fake_timer())
    plan = TPL.Planner(db=db, tuner=tuner, device="cpu").plan(
        m, fmt=fmt, batch=8)
    assert plan.tier == "kernel" and set(plan.geometry) == {"spmv", "spmm"}
    recs = {(r.op, r.batch): r for r in db.geometries
            if r.fmt == fmt and r.bucket_w is None}
    assert set(recs) == {("spmv", 1), ("spmm", 8)}
    P = plan.bind(m, db=db, device="cpu")
    assert P.tiers == {"spmv": "kernel", "spmm": "kernel"}
    for op, b in (("spmv", 1), ("spmm", 8)):
        assert P.tunings[op].without_slab_bound() == \
            recs[(op, b)].geometry.without_slab_bound()
    X = np.random.default_rng(2).normal(size=(120, 8)).astype(np.float32)
    np.testing.assert_allclose((P @ X).numpy(), dense @ X, rtol=2e-4,
                               atol=2e-4)
    # tuning again answers from the memo; the tuner's bind helper applies
    # a format's geometry to its impl
    stats = MatrixStats.of(m)
    assert tuner.tune(plan._mat_cache[1] if "_mat_cache" in plan.__dict__
                      else TT.TRANSFORMS_HOST[fmt](m), op="spmm", batch=8,
                      stats=stats) is recs[("spmm", 8)]
    bound = tuner.bind({fmt: TD.get_impl(fmt, "spmm", tier="kernel"),
                        "other": lambda mm, xx: xx},
                       {fmt: recs[("spmm", 8)].geometry})
    assert bound[fmt].keywords == {"tuning": recs[("spmm", 8)].geometry}
    assert not hasattr(bound["other"], "keywords")
