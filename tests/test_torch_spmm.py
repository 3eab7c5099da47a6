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
import torch

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
from repro_torch.core.formats import BucketedELL as TSell
from repro_torch.kernels import coo_spmv as K3
from repro_torch.kernels import csr_spmv as K2
from repro_torch.kernels import ell_spmv as K1
from repro_torch.kernels import ops as T_ops

FORMATS = ("csr", "coo_row", "coo_col", "ell_row", "ell_col", "sell")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rel_tol(dtype, fmt=""):
    if dtype == "bfloat16":
        return 2e-2
    return 1e-4 if "coo" in fmt else 1e-5


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
    assert K3.coo_spmm_launch(128) == (128, 32, 4, 256, 1024)
    assert K3.coo_spmm_launch(8, block_nnz=100) == (8, 8, 1, 128, 100)
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
