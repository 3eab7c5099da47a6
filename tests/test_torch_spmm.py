"""Port vs reference: the batched path (SpMM, ``X: (n_cols, B)``).

The same numpy inputs go through the JAX package (its Pallas SpMM kernels in
interpret mode on the CPU, as its own tests run them) and through the port,
whose kernel wrappers run each CUDA kernel's plain PyTorch version on the
CPU.  The sweeps are those of ``tests/test_spmm.py``: B in {1, 3, 128},
float32 and bfloat16, a matrix with heavy-tail and empty rows, and an
all-zero matrix.

Tolerances are relative to ``sum_k |a_rk * x_kb|`` of each output element,
the scale the summation error grows with: 1e-5 for float32 (1e-4 for COO,
whose atomics and scatter sum in another order), 2e-2 for bfloat16 (the
output is rounded to 8 bits).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import autotune as RA
from repro.core import dispatch as RD
from repro.core import plan as RPL
from repro.core import transform as RT
from repro.core.formats import BucketedELL as RSell
from repro.kernels import ops as R_ops
from repro_torch.core import autotune as TA
from repro_torch.core import dispatch as TD
from repro_torch.core import plan as TPL
from repro_torch.core import transform as TT
from repro_torch.core.suite import COO_ORDERS, coo_entries
from repro_torch.core.formats import BucketedELL as TSell
from repro_torch.kernels import coo_spmv as K3
from repro_torch.kernels import csr_spmv as K2
from repro_torch.kernels import ell_spmv as K1
from repro_torch.kernels import ops as T_ops

FORMATS = ("csr", "coo_row", "coo_col", "ell_row", "ell_col", "sell", "ccs",
           "bcsr")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rel_tol(dtype, fmt=""):
    if dtype == "bfloat16":
        return 2e-2
    return 1e-4 if "coo" in fmt or fmt in ("ccs", "bcsr") else 1e-5


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def t_(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        TDT[dtype] if np.issubdtype(np.asarray(a).dtype, np.floating)
        else torch.int32)


def as_dtype(a, dtype):
    """``a`` rounded to ``dtype`` and back to float32 (what both packages
    compute from)."""
    return np.asarray(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))


def assert_rel_close(got, want, mag, tol):
    """|got - want| <= tol * sum |a x| elementwise."""
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    err = np.abs(got.astype(np.float64) - want)
    bad = err > tol * np.asarray(mag, np.float64) + 1e-30
    assert not bad.any(), (float((err / (mag + 1e-30)).max()), tol)


def mixed_dense(rng):
    """Heavy-tail rows (one full row, one 3/4 row) among short random rows,
    with every fifth row empty."""
    dense = np.zeros((128, 200), np.float32)
    dense += (rng.random(dense.shape) < 0.02) * rng.normal(
        size=dense.shape).astype(np.float32)
    dense[5, :] = rng.normal(size=200)
    dense[70, :150] = rng.normal(size=150)
    dense[np.arange(128) % 5 == 2] = 0.0
    return dense.astype(np.float32)


MATS = {
    "mixed": mixed_dense,
    "all_zero": lambda rng: np.zeros((40, 30), np.float32),
}


def both(dense, dtype="float32", fmt="csr"):
    """The same matrix in both packages, values rounded to ``dtype``,
    transformed to ``fmt``."""
    rm = RT.csr_from_dense(dense, pad=8)
    tm = TT.csr_from_dense(dense, pad=8, device="cpu")
    rm = dataclasses.replace(rm, data=jnp.asarray(rm.data, JDT[dtype]))
    tm = dataclasses.replace(tm, data=tm.data.to(TDT[dtype]))
    if fmt == "csr_via_coo":
        fmt = "csr"
    return RT.TRANSFORMS_HOST[fmt](rm), TT.TRANSFORMS_HOST[fmt](tm)


# ---------------------------------------------------------------------------
# raw-array entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3, 128])
@pytest.mark.parametrize("n_rows,width,n_cols", [
    (100, 37, 61),       # ragged
    (64, 40, 100),       # width 40: not a power of two
])
def test_ell_spmm_raw_matches_reference(n_rows, width, n_cols, batch, dtype):
    rng = np.random.default_rng(n_rows + batch)
    mask = rng.random((n_rows, width)) < 0.7
    data = np.where(mask, rng.normal(size=(n_rows, width)), 0.0).astype(
        np.float32)
    cols = np.where(mask, rng.integers(0, n_cols, (n_rows, width)),
                    0).astype(np.int32)
    x = rng.normal(size=(n_cols, batch)).astype(np.float32)
    want = R_ops.ell_spmm_raw(jnp.asarray(data, JDT[dtype]),
                              jnp.asarray(cols), jnp.asarray(x, JDT[dtype]),
                              interpret=True)
    got = T_ops.ell_spmm_raw(t_(data, dtype), t_(cols), t_(x, dtype))
    assert got.dtype == TDT[dtype] and got.shape == (n_rows, batch)
    assert str(got.dtype).replace("torch.", "") == want.dtype.name
    d, xx = as_dtype(data, dtype), as_dtype(x, dtype)
    mag = (np.abs(d)[:, :, None] * np.abs(xx)[cols]).sum(axis=1)
    assert_rel_close(got, want, mag, rel_tol(dtype))
    # column-major storage, viewed transposed: the same product
    dt, ct = t_(data.T.copy(), dtype).t(), t_(cols.T.copy()).t()
    assert_rel_close(T_ops.ell_spmm_raw(dt, ct, t_(x, dtype)), want, mag,
                     rel_tol(dtype))


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_ell_pads_turn_nan_only_in_their_rows_unlike_the_reference(bad):
    """A non-finite ``X[0]`` meets every padded slot (value 0, column 0):
    ``0 * inf`` and ``0 * NaN`` are NaN.  In the port's plain versions (and
    its kernels, held to them on the card) exactly the rows whose band holds
    such a slot turn NaN — the sparse reading: a row with no entry at
    column 0 and no pad never reads ``X[0]``.  The reference pads the band
    to a multiple of 8 for the TPU's tile (``repro/kernels/ops.py``,
    ``ell_spmv_raw``/``ell_spmm_raw``), so at a width of 5 every row gains
    pad slots and every row turns NaN.  The port keeps the sparse reading;
    this pins both.  Exact: the checks are on NaN positions, and the finite
    rows equal the dense product within 1e-5 of sum |a x|."""
    n_rows, width, n_cols = 16, 5, 9
    rng = np.random.default_rng(37)
    cols = rng.integers(1, n_cols, (n_rows, width)).astype(np.int32)
    data = rng.normal(size=(n_rows, width)).astype(np.float32)
    cols[:8, 3:], data[:8, 3:] = 0, 0.0      # rows 0-7 end in pads
    X = rng.normal(size=(n_cols, 3)).astype(np.float32)
    X[0, 1] = bad
    nan_rows = np.arange(n_rows) < 8
    got = K1.ell_spmm_plain(t_(data), t_(cols), t_(X))
    np.testing.assert_array_equal(np.isnan(f32(got)),
                                  np.outer(nan_rows, [False, True, False]))
    got_v = K1.ell_spmv_plain(t_(data), t_(cols), t_(X[:, 1].copy()))
    np.testing.assert_array_equal(np.isnan(f32(got_v)), nan_rows)
    fin = ~nan_rows
    want = (data[:, :, None] * np.nan_to_num(X)[cols]).sum(axis=1)
    mag = (np.abs(data)[:, :, None] * np.abs(np.nan_to_num(X))[cols]).sum(
        axis=1)
    assert_rel_close(f32(got)[fin], want[fin], mag[fin], 1e-5)
    ref = np.asarray(R_ops.ell_spmm_raw(jnp.asarray(data), jnp.asarray(cols),
                                        jnp.asarray(X), interpret=True))
    assert width % 8 and np.isnan(ref[:, 1]).all()
    assert not np.isnan(ref[:, [0, 2]]).any()
    ref_v = np.asarray(R_ops.ell_spmv_raw(jnp.asarray(data),
                                          jnp.asarray(cols),
                                          jnp.asarray(X[:, 1].copy()),
                                          interpret=True))
    assert np.isnan(ref_v).all()


@pytest.mark.parametrize("batch", [3, 128])
@pytest.mark.parametrize("nnz,n_rows,n_cols,sort", [
    (4096, 128, 128, True),
    (1000, 64, 256, False),
    (9000, 333, 77, False),
])
def test_coo_spmm_raw_matches_reference(nnz, n_rows, n_cols, sort, batch):
    rng = np.random.default_rng(nnz + batch)
    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    if sort:
        rows = np.sort(rows)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    data = rng.normal(size=nnz).astype(np.float32)
    x = rng.normal(size=(n_cols, batch)).astype(np.float32)
    want = R_ops.coo_spmm_raw(jnp.asarray(data), jnp.asarray(rows),
                              jnp.asarray(cols), jnp.asarray(x), n_rows,
                              interpret=True)
    got = T_ops.coo_spmm_raw(t_(data), t_(rows), t_(cols), t_(x), n_rows)
    mag = np.zeros((n_rows, batch))
    np.add.at(mag, rows, np.abs(data)[:, None] * np.abs(x)[cols])
    assert_rel_close(got, want, mag, rel_tol("float32", "coo"))


@pytest.mark.parametrize("batch", [1, 3, 8, 32, 128])
@pytest.mark.parametrize("order", COO_ORDERS)
def test_coo_spmm_raw_matches_reference_on_adversarial_orders(order, batch):
    """Entry orders built to break a per-row flush (one row across every
    block, rows alternating every entry, pads at the end, ...) against the
    JAX package's kernel, at the batches the tests of the card run."""
    rng = np.random.default_rng(batch)
    n_rows, nnz, n_cols = 120, 3001, 90
    rows, cols, data, n_rows = coo_entries(
        np.sort(rng.integers(0, n_rows, nnz)).astype(np.int32),
        rng.integers(0, n_cols, nnz).astype(np.int32),
        rng.normal(size=nnz).astype(np.float32), n_rows, order, seed=batch)
    x = rng.normal(size=(n_cols, batch)).astype(np.float32)
    want = R_ops.coo_spmm_raw(jnp.asarray(data), jnp.asarray(rows),
                              jnp.asarray(cols), jnp.asarray(x), n_rows,
                              interpret=True)
    got = T_ops.coo_spmm_raw(t_(data), t_(rows), t_(cols), t_(x), n_rows)
    mag = np.zeros((n_rows, batch))
    np.add.at(mag, rows, np.abs(data)[:, None] * np.abs(x)[cols])
    assert_rel_close(got, want, mag, rel_tol("float32", "coo"))


# ---------------------------------------------------------------------------
# format-level wrappers, both packages, the sweeps of tests/test_spmm.py
# ---------------------------------------------------------------------------
WRAPPERS = FORMATS + ("csr_via_coo",)


def port_and_ref_spmm(fmt):
    if fmt == "csr_via_coo":
        return T_ops.spmm_csr_via_coo, R_ops.spmm_csr_via_coo
    fn, found = TD.resolve_impl(fmt, "spmm", tier="kernel")
    assert found == "kernel"
    return fn, RD.get_impl(fmt, "spmm", tier="kernel")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3, 128])
@pytest.mark.parametrize("mat", sorted(MATS))
@pytest.mark.parametrize("fmt", WRAPPERS)
def test_spmm_wrappers_match_reference(fmt, mat, batch, dtype):
    rng = np.random.default_rng(batch)
    dense = MATS[mat](np.random.default_rng(21))
    rf, tf = both(dense, dtype, fmt)
    x = rng.normal(size=(dense.shape[1], batch)).astype(np.float32)
    port, ref = port_and_ref_spmm(fmt)
    want = ref(rf, jnp.asarray(x, JDT[dtype]), interpret=True)
    got = port(tf, t_(x, dtype))
    assert got.shape == (dense.shape[0], batch)
    assert str(got.dtype).replace("torch.", "") == want.dtype.name
    d, xx = as_dtype(dense, dtype), as_dtype(x, dtype)
    mag = np.abs(d) @ np.abs(xx)
    assert_rel_close(got, want, mag, rel_tol(dtype, fmt))
    assert_rel_close(got, d.astype(np.float64) @ xx, mag,
                     rel_tol(dtype, fmt))


@pytest.mark.parametrize("fmt", FORMATS)
def test_spmm_at_b1_matches_spmv(fmt):
    rng = np.random.default_rng(4)
    dense = mixed_dense(rng)
    _, tf = both(dense, fmt=fmt)
    x = rng.normal(size=200).astype(np.float32)
    y = TD.spmv(tf, t_(x), tier="kernel")
    Y = TD.spmm(tf, t_(x[:, None]), tier="kernel")
    assert Y.shape == (128, 1)
    mag = np.abs(dense) @ np.abs(x)
    assert_rel_close(Y[:, 0], y, mag, rel_tol("float32", fmt))


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dd,xd", [("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
def test_spmm_output_dtype_is_the_reference_type(fmt, dd, xd):
    """``promote_types(data, x)`` everywhere but SELL, whose result takes
    x's dtype in the reference (ROADMAP Queue C), and so here."""
    rng = np.random.default_rng(9)
    dense = mixed_dense(rng)[:60, :45]
    rf, tf = both(dense, dd, fmt)
    x = rng.normal(size=(45, 3)).astype(np.float32)
    want = RD.get_impl(fmt, "spmm", tier="kernel")(
        rf, jnp.asarray(x, JDT[xd]), interpret=True)
    got = TD.spmm(tf, t_(x, xd), tier="kernel")
    promoted = jnp.dtype(jnp.result_type(JDT[dd], JDT[xd])).name
    assert want.dtype.name == (xd if fmt == "sell" else promoted)
    assert str(got.dtype).replace("torch.", "") == want.dtype.name
    mag = np.abs(dense) @ np.abs(x)
    assert_rel_close(got, want, mag, 5e-2)


def test_spmm_sell_all_zero_gives_typed_zeros():
    for dtype in ("float32", "bfloat16"):
        X = torch.ones((9, 4), dtype=TDT[dtype])
        empty = TSell(perm=torch.arange(12, dtype=torch.int32), buckets=(),
                      row_offsets=(), shape=(12, 9), nnz=0)
        r_empty = RSell(perm=np.arange(12, dtype=np.int32), buckets=(),
                        row_offsets=(), shape=(12, 9), nnz=0)
        _, tf = both(np.zeros((12, 9), np.float32), fmt="sell")
        want = R_ops.spmm_sell(r_empty, jnp.ones((9, 4), JDT[dtype]))
        for m in (empty, tf):
            Y = T_ops.spmm_sell(m, X)
            assert Y.dtype == X.dtype and Y.shape == (12, 4) == want.shape
            assert not Y.any()


def test_spmm_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    data, cols = torch.ones(4, 3), torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        K1.ell_spmm(data, cols, torch.ones(5))            # 1-D x
    with pytest.raises(TypeError):
        K1.ell_spmm(data.double(), cols, torch.ones(5, 2))
    flat, fc = torch.ones(6), torch.zeros(6, dtype=torch.int32)
    ip = torch.tensor([0, 2, 6], dtype=torch.int32)
    with pytest.raises(TypeError):
        K2.csr_spmm(flat, fc, ip.long(), torch.ones(4, 2))
    with pytest.raises(ValueError):
        K2.csr_spmm(flat, fc[:4], ip, torch.ones(4, 2))
    with pytest.raises(TypeError):
        K3.coo_spmm(flat, fc, fc, torch.ones(4, 2).half(), 2)
    with pytest.raises(ValueError):
        K3.coo_spmm(flat, fc, fc, torch.ones(4), 2)


def test_spmm_launch_shapes():
    from repro_torch.kernels import _common as C
    assert C.rhs_tile(1) == (1, 1, 1)
    assert C.rhs_tile(8) == (8, 8, 1)        # a warp spans 4 rows at B = 8
    assert C.rhs_tile(3) == (3, 4, 1)
    assert C.rhs_tile(40) == (40, 32, 2)
    assert C.rhs_tile(128) == (128, 32, 4)
    assert C.rhs_tile(1000) == (128, 32, 4)
    assert C.rhs_tile(128, block_k=8) == (8, 8, 1)
    assert C.rhs_tile(4, block_k=64) == (4, 4, 1)
    for b in (1, 3, 8, 40, 128, 1000):
        for bk in (None, 1, 8, 32, 128, 4096):
            for br in (None, 1, 7, 64, 1024, 10 ** 6):
                kt, lanes, per, rows = C.row_group_launch(b, br, bk)
                assert kt <= lanes * per and lanes <= 32
                assert 32 <= rows * lanes <= 1024 and rows * lanes % 32 == 0
    # (kt, lanes, per_lane, threads, block_nnz, entries per lane group)
    assert K3.coo_spmm_launch(128) == (128, 32, 4, 256, 1024, 128)
    assert K3.coo_spmm_launch(8, block_nnz=100) == (8, 8, 1, 128, 100, 7)
    assert K3.coo_spmm_launch(1, block_nnz=16384) == (1, 1, 1, 256, 16384,
                                                      64)
    for b in (1, 3, 8, 40, 128):
        for bn in (1, 7, 100, 256, 1024, 16384):
            _, lanes, _, threads, got_bn, run = K3.coo_spmm_launch(b, bn)
            assert got_bn == bn and 32 <= threads <= 1024
            assert run * (threads // lanes) >= bn > (run - 1) * (
                threads // lanes)
    with pytest.raises(ValueError):
        C.row_group_launch(65536 * 128 + 1)  # more tiles than grid.y holds


def test_plain_spmm_versions_chunk_their_temporaries(monkeypatch):
    """Walking the entries in chunks gives the same product."""
    from repro_torch.kernels import _common as C
    rng = np.random.default_rng(12)
    dense = mixed_dense(rng)
    _, tm = both(dense)
    coo = TT.host_csr_to_coo_col(tm)
    X = t_(rng.normal(size=(200, 5)).astype(np.float32))
    full_csr = K2.csr_spmm_plain(tm.data, tm.cols, tm.indptr, X)
    full_coo = K3.coo_spmm_plain(coo.data, coo.rows, coo.cols, X, 128)
    monkeypatch.setattr(C, "PLAIN_CHUNK_ELEMS", 64)
    monkeypatch.setattr(K2, "PLAIN_CHUNK_ELEMS", 64)
    monkeypatch.setattr(K3, "PLAIN_CHUNK_ELEMS", 64)
    np.testing.assert_allclose(
        f32(K2.csr_spmm_plain(tm.data, tm.cols, tm.indptr, X)),
        f32(full_csr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        f32(K3.coo_spmm_plain(coo.data, coo.rows, coo.cols, X, 128)),
        f32(full_coo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(full_csr), dense @ f32(X), rtol=1e-5,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the batched path as a whole: Planner().plan(csr, batch=8).bind(csr) @ X
# ---------------------------------------------------------------------------
def planner_dbs():
    """A TuningDB both packages load from one JSON: the paper's rule moves
    a matrix to ELL when its D_mat is under 10."""
    rdb = RA.TuningDB(machine="m", c=1.0, records=[],
                      d_star={"ell_row": 10.0, "sell": 10.0})
    return rdb, TA.TuningDB.from_json(rdb.to_json())


@pytest.mark.parametrize("case", ["paper", "paper_sell", "cost_model"]
                         + [f"fixed_{f}" for f in FORMATS])
def test_batched_planner_matches_reference(case, tmp_path):
    rng = np.random.default_rng(17)
    dense = mixed_dense(rng)
    rcsr, tcsr = both(dense)
    X = rng.normal(size=(200, 8)).astype(np.float32)
    rdb, tdb = planner_dbs()
    consts = dict(stream_bw=2.0e12, gather_bw=2.5e11)
    kw = {"paper": dict(rule="paper"),
          "paper_sell": dict(rule="paper", formats=("sell",)),
          "cost_model": dict(rule="cost_model")}.get(
              case, dict(fmt=case[len("fixed_"):]))
    rplan = RPL.Planner(db=rdb, model=RA.MachineModel(**consts),
                        tier="kernel").plan(rcsr, batch=8, **kw)
    tplan = TPL.Planner(db=tdb, model=TA.MachineModel(**consts),
                        tier="kernel", device="cpu").plan(tcsr, batch=8, **kw)
    assert tplan.to_dict() == rplan.to_dict()          # key by key
    assert tplan.batch == 8
    P_t = tplan.bind(tcsr, db=tdb, device="cpu")
    P_r = rplan.bind(rcsr, db=rdb)
    assert P_t.tiers == P_r.tiers == {"spmv": "kernel", "spmm": "kernel"}
    for op in ("spmv", "spmm"):
        g_t, g_r = P_t.tunings[op], P_r.tunings[op]
        assert (g_t.to_dict() if g_t is not None else None) == \
            (g_r.to_dict() if g_r is not None else None)
    Y_t, Y_r = P_t @ torch.from_numpy(X), P_r @ jnp.asarray(X)
    mag = np.abs(dense) @ np.abs(X)
    tol = rel_tol("float32", tplan.fmt)
    assert_rel_close(Y_t, Y_r, mag, tol)
    assert_rel_close(Y_t, dense.astype(np.float64) @ X, mag, tol)
    # the reference's plan binds in the port and serves the same product
    path = tmp_path / "plan.json"
    rplan.save(str(path))
    Y2 = TPL.ExecutionPlan.load(str(path)).bind(tcsr, device="cpu") @ X
    assert_rel_close(Y2, Y_r, mag, tol)


# ---------------------------------------------------------------------------
# K5 csr_spmm: the shared-memory window of X rows
# ---------------------------------------------------------------------------
def csr_arrays(kind, rng):
    """``(dense, order)``: a matrix and the within-row order of its CSR
    columns (``None``: sorted).  Banded rows of 0-20 entries about the
    diagonal; hash-scattered columns; a band with full rows and empty rows
    (heavy tail); and the band with each row's columns shuffled."""
    n, n_cols = 300, 260
    dense = np.zeros((n, n_cols), np.float32)
    for r in range(n):
        k = int(rng.integers(0, 21))
        if kind == "scattered":
            c = (r + np.arange(k) * 101) % n_cols
        else:
            c0 = min(max(r * n_cols // n - k // 2, 0), n_cols - k)
            c = np.arange(c0, c0 + k)
        dense[r, c] = rng.normal(size=k)
    if kind == "heavy_tail":
        dense[[7, 150], :] = rng.normal(size=(2, n_cols))
        dense[::9] = 0.0
    return dense, ("shuffle" if kind == "unsorted" else None)


def both_csr(dense, order, dtype, rng):
    """The matrix in both packages' CSR, values in ``dtype``, columns within
    each row in ``order``."""
    rm, tm = both(dense, dtype)
    if order == "shuffle":
        ip = tm.indptr.numpy()
        perm = np.arange(tm.nnz_pad)
        for r in range(tm.n_rows):
            perm[ip[r]:ip[r + 1]] = rng.permutation(
                np.arange(ip[r], ip[r + 1]))
        rm = dataclasses.replace(rm, data=rm.data[perm], cols=rm.cols[perm])
        tm = dataclasses.replace(tm, data=tm.data[perm].contiguous(),
                                 cols=tm.cols[perm].contiguous())
    return rm, tm


def np_windows(cols, ip, n_cols, rows, window, stage):
    """The windows of ``csrc/csr_spmm.cu``, block by block in numpy."""
    n_rows = ip.shape[0] - 1
    lo, held = [], []
    for r0 in range(0, n_rows, rows):
        rs = range(r0, min(r0 + rows, n_rows))
        fit = [r for r in rs if 1 <= ip[r + 1] - ip[r] <= window]
        if not fit:
            lo.append(0)
            held.append(0)
            continue
        start = min(min(int(cols[ip[r]]) for r in fit),
                    max(0, n_cols - window))
        rows_held = min(window, n_cols - start)
        first = ip[r0]
        last = min(ip[rs[-1] + 1], first + stage)
        hits = sum(0 <= int(c) - start < rows_held for c in cols[first:last])
        if hits == 0 or hits < rows_held:
            lo.append(0)
            held.append(0)
            continue
        lo.append(start)
        held.append(rows_held)
    return np.array(lo), np.array(held)


KINDS_K5 = ("banded", "scattered", "heavy_tail", "unsorted")


def test_csr_spmm_launch_keeps_a_window_from_a_warp_wide_tile():
    from repro_torch.kernels import _common as C
    # xenon2 at scale 4: 32 rows a block, a window of 32 + 2 * 25 X rows,
    # a stage of 5/4 of 32 mean rows' 25 entries
    assert C.csr_spmm_launch(128, 629856, 629856, 15466752) == (
        128, 32, 4, 256, 32, 82, 1024)
    assert C.csr_spmm_launch(128, 629856, 629856, 15466752,
                             x_size=2)[5] == 82
    # a tile under 64 columns: the window kernel only when asked for
    assert C.csr_spmm_launch(17, 100, 100, 800) == (17, 32, 1, 256, 8, 0, 0)
    assert C.csr_spmm_launch(17, 100, 100, 800, window=True) == (
        17, 32, 1, 256, 32, 48, 320)
    assert C.csr_spmm_launch(128, 100, 100, 800, window=False) == (
        128, 32, 4, 256, 8, 0, 0)
    # rows a block owns: the knob, at most the matrix's rows; up to 256
    # threads walk them
    assert C.csr_spmm_launch(32, 20, 50, 100, block_rows=1000,
                             window=True)[3:] == (256, 20, 50, 128)
    assert C.csr_spmm_launch(32, 5000, 5000, 50000, block_rows=1,
                             window=True)[3:] == (32, 1, 21, 32)
    # the window fits in shared memory beside the rows' IRP and the stage
    kt, lanes, _, threads, rows, window, stage = C.csr_spmm_launch(
        128, 10 ** 6, 10 ** 6, 10 ** 9, block_rows=512)
    assert stage == C.CSR_SPMM_STAGE_MAX
    assert (window * kt * 4 + 4 * (rows + 4) + 8 * stage
            + 4 * threads // lanes * kt) <= C.SMEM_BLOCK_MAX
    # a tile narrower than a warp: the first port's lane group a row
    assert C.csr_spmm_launch(8, 100, 100, 800) == (8, 8, 1, 256, 32, 0, 0)
    assert C.csr_spmm_launch(1, 100, 100, 800, block_rows=64) == (
        1, 1, 1, 64, 64, 0, 0)
    # a narrow tile in the window kernel: a row a lane group by default
    assert C.csr_spmm_launch(1, 1000, 1000, 8000, window=True)[3:5] == (
        256, 256)


@pytest.mark.parametrize("block_rows", [None, 1, 8, 37, 1000])
@pytest.mark.parametrize("batch", [17, 128])
@pytest.mark.parametrize("kind", KINDS_K5)
def test_csr_spmm_windows_and_misses_match_numpy(kind, batch, block_rows):
    rng = np.random.default_rng(41)
    dense, order = csr_arrays(kind, rng)
    _, tm = both_csr(dense, order, "float32", rng)
    ip, cols = tm.indptr.numpy(), tm.cols.numpy()
    _, _, _, _, rows, window, stage = _C().csr_spmm_launch(
        batch, tm.n_rows, tm.n_cols, tm.nnz_pad, block_rows, window=True)
    lo, held = K2.csr_spmm_windows(tm.cols, tm.indptr, tm.n_cols, rows,
                                   window, stage)
    want_lo, want_held = np_windows(cols, ip, tm.n_cols, rows, window,
                                    stage)
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(held.numpy(), want_held)
    assert (lo.numpy() + held.numpy() <= tm.n_cols).all()
    # the entries outside their block's window, one by one
    misses = 0
    for r in range(tm.n_rows):
        b = r // rows
        for k in range(ip[r], ip[r + 1]):
            misses += not 0 <= cols[k] - want_lo[b] < want_held[b]
    got = K2.csr_spmm_window_misses(tm.cols, tm.indptr, tm.n_cols, batch,
                                    block_rows=block_rows, window=True)
    assert got == {"rows": rows, "window": window,
                   "blocks": -(-tm.n_rows // rows),
                   "windowed": int((want_held > 0).sum()),
                   "window_x_rows": int(want_held.sum()),
                   "entries": tm.nnz, "misses": misses}
    if kind == "banded" and block_rows in (None, 37):
        # every block but a short last one keeps its window, which serves
        # all its entries
        last = ip[-1] - ip[(got["blocks"] - 1) * rows]
        assert got["windowed"] >= got["blocks"] - 1 and misses <= last
    if kind == "scattered" and block_rows is None:
        # a window serves few of a scattered block's entries
        assert misses > tm.nnz // 2


def _C():
    from repro_torch.kernels import _common as C
    return C


def test_csr_spmm_window_misses_without_the_window_kernel_are_every_entry():
    rng = np.random.default_rng(43)
    dense, _ = csr_arrays("banded", rng)
    _, tm = both(dense)
    for batch, window in ((8, None), (128, False)):
        got = K2.csr_spmm_window_misses(tm.cols, tm.indptr, tm.n_cols,
                                        batch, window=window)
        assert got["window"] == 0
        assert got["misses"] == got["entries"] == tm.nnz


@pytest.mark.parametrize("kind", KINDS_K5)
def test_csr_spmm_structure_picks_the_kernel(kind):
    """A bound CSR matrix takes the window kernel where it has heavy rows
    (at every B) or where its windows serve half its entries (from B = 64
    on); ``ops.prepare`` keeps what decides it beside the container."""
    from repro_torch.kernels import _common as C
    rng = np.random.default_rng(59)
    dense, order = csr_arrays(kind, rng)
    _, tm = both_csr(dense, order, "float32", rng)
    heavy, served = K2.csr_spmm_structure(tm.cols, tm.indptr, tm.n_cols)
    _, _, _, _, rows, window, _ = C.csr_spmm_launch(
        128, tm.n_rows, tm.n_cols, tm.nnz_pad, window=True)
    lens = np.diff(tm.indptr.numpy())
    assert heavy == bool(lens.max() > window)
    misses = K2.csr_spmm_window_misses(tm.cols, tm.indptr, tm.n_cols, 128,
                                       window=True)
    assert served == pytest.approx(1 - misses["misses"] / tm.nnz)
    assert heavy == (kind == "heavy_tail")
    if kind in ("banded", "unsorted"):
        assert served > 0.9
    assert T_ops.csr_window_of(tm, 128) is None      # not prepared
    T_ops.prepare(tm)
    for batch in (1, 8, 32, 64, 128):
        want = heavy or (batch >= 64 and served >= C.CSR_SPMM_MIN_SERVED)
        assert T_ops.csr_window_of(tm, batch) is want
    assert T_ops.csr_window_of(tm, 128, block_k=32) is (heavy or False)
    # the product is the same whichever kernel runs
    x = t_(rng.normal(size=(dense.shape[1], 40)).astype(np.float32))
    np.testing.assert_allclose(f32(T_ops.spmm_csr(tm, x)),
                               dense.astype(np.float64) @ f32(x),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3, 8, 17, 128])
@pytest.mark.parametrize("kind", KINDS_K5)
def test_csr_spmm_window_plain_matches_reference(kind, batch, dtype):
    """K5's windowed plain version (what the CPU wrapper runs, reading X
    through the kernel's windows) against the JAX package's CSR SpMM."""
    rng = np.random.default_rng(batch + 47)
    dense, order = csr_arrays(kind, rng)
    rm, tm = both_csr(dense, order, dtype, rng)
    x = rng.normal(size=(dense.shape[1], batch)).astype(np.float32)
    want = R_ops.spmm_csr(rm, jnp.asarray(x, JDT[dtype]), interpret=True)
    d, xx = as_dtype(dense, dtype), as_dtype(x, dtype)
    mag = np.abs(d) @ np.abs(xx)
    # the kernel the tile picks, and the window kernel at every tile
    for window in (None, True):
        got = K2.csr_spmm(tm.data, tm.cols, tm.indptr, t_(x, dtype),
                          window=window)
        plain = K2.csr_spmm_window_plain(tm.data, tm.cols, tm.indptr,
                                         t_(x, dtype), window=window)
        assert got.dtype == torch.float32 and got.shape == (300, batch)
        assert torch.equal(got, plain)
        assert_rel_close(got, want, mag, rel_tol(dtype))
        assert_rel_close(got, d.astype(np.float64) @ xx, mag,
                         rel_tol(dtype))


@pytest.mark.parametrize("block", [dict(), dict(block_rows=1),
                                   dict(block_rows=13, block_k=32),
                                   dict(block_rows=1000, block_k=40)],
                         ids=["default", "r1", "r13-k32", "r1000-k40"])
@pytest.mark.parametrize("kind", KINDS_K5)
def test_csr_spmm_window_plain_reads_inside_its_windows(kind, block):
    """Every launch shape of the window gives the product: the windows are
    built with NaN past the rows they hold, so a read outside would show."""
    rng = np.random.default_rng(53)
    dense, order = csr_arrays(kind, rng)
    _, tm = both_csr(dense, order, "float32", rng)
    x = rng.normal(size=(dense.shape[1], 128)).astype(np.float32)
    got = K2.csr_spmm_window_plain(tm.data, tm.cols, tm.indptr, t_(x),
                                   window=True, **block)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(
        f32(got), f32(K2.csr_spmm_plain(tm.data, tm.cols, tm.indptr, t_(x))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(got), dense.astype(np.float64) @ x,
                               rtol=1e-4, atol=1e-4)
