"""Port vs reference: reference-tier and kernel-tier SpMV.

The same numpy inputs go through the JAX package (its Pallas kernels run in
interpret mode on the CPU, as its own tests run them) and through the port.
On the CPU the port's kernel wrappers run each kernel's plain PyTorch
version — the code ``chip_smoke.py`` holds the CUDA kernels against on the
card — so these tests pin the wrappers' semantics: shapes, strides, padding,
dtype promotion, launch geometry, gradients.

Tolerances are the reference's own (``tests/test_kernels.py``): rtol/atol
2e-4 for float32 and 2e-2 for bfloat16, because the sums are taken in a
different order.  The tests that need the card are in ``test_torch_cuda.py``.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as RD
from repro.core import transform as RT
from repro.core.kernel_tune import TileGeometry as RTile
from repro.kernels import ops as R_ops
from repro.kernels import ref as R_ref
from repro_torch import kernels as TK
from repro_torch.core import dispatch as TD
from repro_torch.core import transform as TT
from repro_torch.core.kernel_tune import GPU_NNZ_TILES, TileGeometry
from repro_torch.core.suite import COO_ORDERS, coo_entries
from repro_torch.kernels import build as T_build
from repro_torch.kernels import coo_spmv as K3
from repro_torch.kernels import csr_spmv as K2
from repro_torch.kernels import ell_spmv as K1
from repro_torch.kernels import ops as T_ops

FORMATS = ("csr", "coo_row", "coo_col", "ell_row", "ell_col", "sell", "ccs",
           "bcsr")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


TOL = tol("float32")


def f32(a):
    """Result of either package as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def t_(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        TDT[dtype] if np.issubdtype(np.asarray(a).dtype, np.floating)
        else torch.int32)


def random_dense(rng, n_rows, n_cols, density):
    d = (rng.random((n_rows, n_cols)) < density).astype(np.float32)
    return d * rng.normal(1.0, 1.0, size=d.shape).astype(np.float32)


def heavy_tail_dense(rng):
    dense = np.zeros((128, 200), np.float32)
    dense[5, :] = rng.normal(size=200)
    dense[70, :150] = rng.normal(size=150)
    dense += (rng.random(dense.shape) < 0.01) * rng.normal(
        size=dense.shape).astype(np.float32)
    return dense.astype(np.float32)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


# ---------------------------------------------------------------------------
# ELL: aligned + ragged shapes (width 37, 40, 5), f32 + bf16
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rows,width,n_cols", [
    (256, 128, 512),     # wide band
    (8, 8, 16),          # minimum
    (100, 37, 61),       # ragged
    (64, 40, 100),       # width 40: not a power of two
    (1024, 5, 2048),     # skinny band
])
def test_ell_spmv_raw_matches_reference(rng, n_rows, width, n_cols, dtype):
    data = rng.normal(size=(n_rows, width)).astype(np.float32)
    mask = rng.random((n_rows, width)) < 0.7
    data = np.where(mask, data, 0.0).astype(np.float32)
    cols = np.where(mask, rng.integers(0, n_cols, (n_rows, width)),
                    0).astype(np.int32)
    x = rng.normal(size=(n_cols,)).astype(np.float32)
    jd, jc, jx = (jnp.asarray(data, JDT[dtype]), jnp.asarray(cols),
                  jnp.asarray(x, JDT[dtype]))
    want = R_ops.ell_spmv_raw(jd, jc, jx, interpret=True)
    oracle = R_ref.ell_spmv_ref(jd, jc, jx)
    got = T_ops.ell_spmv_raw(t_(data, dtype), t_(cols), t_(x, dtype))
    assert got.dtype == TDT[dtype] and got.shape == (n_rows,)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))
    np.testing.assert_allclose(f32(got), f32(oracle), **tol(dtype))


def test_ell_col_storage_is_viewed_not_copied(rng):
    dense = random_dense(rng, 90, 70, 0.1)
    m = TT.host_csr_to_ell(TT.csr_from_dense(dense, pad=8, device="cpu"), order="col")
    data, cols = T_ops._ell_arrays(m)
    assert data.shape == (90, m.width) and data.stride() == (1, 90)
    assert data.data_ptr() == m.data.data_ptr()
    assert cols.data_ptr() == m.cols.data_ptr()
    x = rng.normal(size=70).astype(np.float32)
    np.testing.assert_allclose(f32(T_ops.spmv_ell(m, t_(x))), dense @ x,
                               **TOL)


# ---------------------------------------------------------------------------
# COO: sorted + unsorted rows, duplicates allowed, pads at (0, 0, 0.0)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nnz,n_rows,n_cols,sort", [
    (4096, 128, 128, True),
    (1000, 64, 256, False),
    (8, 8, 8, True),
    (9000, 333, 77, False),
])
def test_coo_spmv_raw_matches_reference(rng, nnz, n_rows, n_cols, sort):
    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    if sort:
        rows = np.sort(rows)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    data = rng.normal(size=nnz).astype(np.float32)
    x = rng.normal(size=n_cols).astype(np.float32)
    want = R_ops.coo_spmv_raw(jnp.asarray(data), jnp.asarray(rows),
                              jnp.asarray(cols), jnp.asarray(x), n_rows,
                              interpret=True)
    got = T_ops.coo_spmv_raw(t_(data), t_(rows), t_(cols), t_(x), n_rows)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


def test_coo_pad_entries_leave_row_zero_alone(rng):
    data = np.array([2.0, 3.0, 0.0, 0.0], np.float32)
    rows = np.array([1, 2, 0, 0], np.int32)
    cols = np.array([0, 1, 0, 0], np.int32)
    x = np.array([5.0, 7.0], np.float32)
    got = T_ops.coo_spmv_raw(t_(data), t_(rows), t_(cols), t_(x), 3)
    np.testing.assert_array_equal(f32(got), [0.0, 10.0, 21.0])


def sorted_coo(rng, n_rows=120, nnz=3001, n_cols=90):
    """Row-sorted COO entries, ~25 a row (xenon2's mean), as numpy."""
    rows = np.sort(rng.integers(0, n_rows, nnz)).astype(np.int32)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    return rows, cols, rng.normal(size=nnz).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_nnz", GPU_NNZ_TILES)
@pytest.mark.parametrize("order", COO_ORDERS)
def test_coo_spmv_raw_matches_reference_on_adversarial_orders(order,
                                                              block_nnz,
                                                              dtype):
    """Entry orders built to break a per-row reduction (one row across every
    block, rows alternating every entry, pads at the end, ...), at each
    entries-per-block tile of the tuner's grid, against the JAX package's
    kernel run at the same tile."""
    rng = np.random.default_rng(block_nnz)
    rows, cols, data, n_rows = coo_entries(*sorted_coo(rng), 120, order,
                                           seed=block_nnz)
    x = rng.normal(size=90).astype(np.float32)
    want = R_ops.coo_spmv_raw(jnp.asarray(data, JDT[dtype]),
                              jnp.asarray(rows), jnp.asarray(cols),
                              jnp.asarray(x, JDT[dtype]), n_rows,
                              interpret=True,
                              tuning=RTile(block_nnz=block_nnz))
    got = T_ops.coo_spmv_raw(t_(data, dtype), t_(rows), t_(cols),
                             t_(x, dtype), n_rows,
                             TileGeometry(block_nnz=block_nnz))
    assert got.dtype == TDT[dtype] and got.shape == (n_rows,)
    np.testing.assert_allclose(f32(got), f32(want), **tol(dtype))


# ---------------------------------------------------------------------------
# CSR: shapes, heavy-tail rows, empty rows, launch geometry
# ---------------------------------------------------------------------------
def both_csr(dense):
    return RT.csr_from_dense(dense, pad=8), TT.csr_from_dense(dense, pad=8, device="cpu")


@pytest.mark.parametrize("n_rows,n_cols,density", [
    (256, 256, 0.05),    # aligned
    (100, 61, 0.2),      # ragged, denser
    (513, 37, 0.02),     # ragged rows, skinny
    (8, 8, 0.5),         # minimum
])
def test_csr_spmv_matches_reference_and_dense(rng, n_rows, n_cols, density):
    dense = random_dense(rng, n_rows, n_cols, density)
    rm, tm = both_csr(dense)
    x = rng.normal(size=n_cols).astype(np.float32)
    want = R_ops.spmv_csr(rm, jnp.asarray(x), interpret=True)
    got = T_ops.spmv_csr(tm, t_(x))
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(f32(got), dense @ x, **TOL)


@pytest.mark.parametrize("g", [
    dict(block_rows=8, block_nnz=1024),
    dict(block_rows=64, block_nnz=1024),
    dict(block_rows=512, block_nnz=8192),
    dict(block_rows=32, block_w=8, block_nnz=2048, block_k=8),
], ids=["r8", "r64", "r512-bn8192", "spmm-k8"])
def test_csr_geometry_sweep(rng, g):
    dense = random_dense(rng, 200, 120, 0.15)
    rm, tm = both_csr(dense)
    x = rng.normal(size=120).astype(np.float32)
    want = R_ops.spmv_csr(rm, jnp.asarray(x), interpret=True,
                          tuning=RTile(**g))
    got = T_ops.spmv_csr(tm, t_(x), tuning=TileGeometry(**g))
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(f32(got), dense @ x, **TOL)
    assert T_ops.exact_slab_bound(tm, TileGeometry(**g)) == \
        R_ops.exact_slab_bound(rm, RTile(**g))


def test_csr_heavy_tail_rows(rng):
    dense = heavy_tail_dense(rng)
    rm, tm = both_csr(dense)
    x = rng.normal(size=200).astype(np.float32)
    g = dict(block_rows=32, block_nnz=64)
    want = R_ops.spmv_csr(rm, jnp.asarray(x), interpret=True,
                          tuning=RTile(**g))
    got = T_ops.spmv_csr(tm, t_(x), tuning=TileGeometry(**g))
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(f32(got), dense @ x, **TOL)


def test_csr_big_matrix_geometry_on_tiny_matrix(rng):
    dense = random_dense(rng, 24, 16, 0.3)
    rm, tm = both_csr(dense)
    x = rng.normal(size=16).astype(np.float32)
    big = dict(block_rows=512, block_nnz=65536)
    got = T_ops.spmv_csr(tm, t_(x), tuning=TileGeometry(**big))
    np.testing.assert_allclose(f32(got), dense @ x, **TOL)
    assert T_ops.exact_slab_bound(tm, TileGeometry(**big)) == \
        R_ops.exact_slab_bound(rm, RTile(**big))


def test_csr_never_reads_past_the_last_pointer(rng):
    """Slots past IRP[-1] may hold anything in range: they add nothing."""
    dense = random_dense(rng, 40, 30, 0.2)
    tm = TT.csr_from_dense(dense, pad=64, device="cpu")
    assert tm.nnz_pad > tm.nnz
    tm.data[tm.nnz:] = 123.0
    tm.cols[tm.nnz:] = 29
    x = rng.normal(size=30).astype(np.float32)
    np.testing.assert_allclose(f32(T_ops.spmv_csr(tm, t_(x))), dense @ x,
                               **TOL)


def test_slabs_needed_matches_reference():
    from repro.kernels.csr_spmv import slabs_needed as ref_slabs
    indptr = np.array([0, 3, 3, 10, 64, 64, 64, 65, 130], np.int32)
    for br, bn in ((4, 64), (8, 64), (2, 8), (16, 1024)):
        assert K2.slabs_needed(indptr, br, bn) == ref_slabs(indptr, br, bn)
    assert K2.slabs_needed(np.array([0, 0], np.int32), 8, 64) == 1
    assert K2.slabs_needed(indptr, 4, 64) == 2


def test_csr_lane_group_follows_mean_row_length():
    """No lane group follows the mean segment length any more: ``csr_spmv``
    cuts its work by entries and ``ccs_spmv`` by runs of columns a warp.
    What follows the mean column length is K7's window: a warp's columns'
    rows plus a mean column on either side, as a power of two from 128 to
    256 rows, at most the matrix's rows (300 rows over 100 columns here:
    a 32-column run maps to 96 rows)."""
    from repro_torch.kernels._common import ccs_spmv_launch
    assert ccs_spmv_launch(300, 100, 100) == (256, 256, 32, 128)
    assert ccs_spmv_launch(300, 100, 700) == (256, 256, 32, 128)
    assert ccs_spmv_launch(300, 100, 1600) == (256, 256, 32, 128)
    assert ccs_spmv_launch(300, 100, 1700) == (256, 256, 32, 256)
    assert ccs_spmv_launch(300, 100, 2500) == (256, 256, 32, 256)
    assert ccs_spmv_launch(300, 100, 10 ** 6) == (256, 256, 32, 256)
    assert ccs_spmv_launch(100, 100, 10 ** 6) == (256, 256, 32, 100)
    assert ccs_spmv_launch(0, 0, 0) == (256, 256, 32, 1)


def test_spmv_launch_shapes_are_chosen_on_the_host():
    """The SpMV wrappers pick lanes and rows per block in Python, as the
    SpMM wrappers do, and the tuner's grid reads the same helpers."""
    from repro_torch.core.kernel_tune import candidate_geometries
    from repro_torch.kernels import _common as C
    assert C.ell_spmv_lanes(200, row_major=True) == 32
    assert C.ell_spmv_lanes(127, row_major=True) == 8
    assert C.ell_spmv_lanes(500, row_major=False) == 1
    assert C.rows_per_block(1) == 256 and C.rows_per_block(32) == 8
    assert C.rows_per_block(8, block_rows=5) == 8     # 40 -> 64 threads
    assert C.rows_per_block(32, block_rows=1024) == 32
    # a COO SpMV thread sums 4 consecutive entries (8 above 1024 a block)
    assert C.coo_launch() == (256, 1024, 4)
    assert C.coo_launch(100) == (32, 100, 4)
    assert C.coo_launch(4096) == (512, 4096, 8)
    assert C.coo_launch(16384) == (512, 16384, 8)    # four passes a block
    for fmt, width, lanes in (("ell_row", 40, 8), ("ell_row", 300, 32),
                              ("sell", 40, 8), ("ell_col", 300, 1),
                              ("ell_row", 1, 1)):
        rows = [g.block_rows for g in candidate_geometries(
            fmt, "spmv", n_rows=10 ** 6, width=width)]
        assert max(rows) * lanes == 1024 and min(rows) * lanes == 32
        assert rows == sorted(set(rows))


@pytest.mark.parametrize("block_nnz", (None,) + GPU_NNZ_TILES + (100, 5000))
@pytest.mark.parametrize("nnz_pad", [0, 1, 1003, 4096, 15466752])
def test_csr_spmv_slices_are_chosen_on_the_host(nnz_pad, block_nnz):
    """K2's launch: a slice of ``block_nnz`` entries a block (default
    ``CSR_DEFAULT_BLOCK_NNZ``), COO's threads and entries per thread for it,
    and slices that cover every stored slot (one for a matrix with no slot,
    so its rows are still written)."""
    from repro_torch.kernels import _common as C
    threads, bn, chunk, n_slices = C.csr_slices(nnz_pad, block_nnz)
    assert (threads, bn, chunk) == C.coo_launch(block_nnz or
                                                C.CSR_DEFAULT_BLOCK_NNZ)
    assert n_slices >= 1 and (n_slices - 1) * bn < max(nnz_pad, 1)
    assert n_slices * bn >= nnz_pad
    if (nnz_pad, block_nnz) == (15466752, None):   # xenon2@x4
        assert (threads, bn, chunk, n_slices) == (256, 2048, 8, 7553)


# ---------------------------------------------------------------------------
# every ported format, both tiers, vs the reference and vs dense
# ---------------------------------------------------------------------------
MATS = {
    "random": lambda rng: random_dense(rng, 200, 150, 0.08),
    "heavy_tail": heavy_tail_dense,
    "empty_rows": lambda rng: np.where(
        np.arange(90)[:, None] % 3 == 0, 0.0,
        random_dense(rng, 90, 70, 0.1)).astype(np.float32),
    "all_zero": lambda rng: np.zeros((40, 30), np.float32),
}


@pytest.mark.parametrize("mat", sorted(MATS))
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_tier_spmv_matches_reference(rng, fmt, mat):
    dense = MATS[mat](np.random.default_rng(21))
    rm, tm = both_csr(dense)
    rf, tf = RT.TRANSFORMS_HOST[fmt](rm), TT.TRANSFORMS_HOST[fmt](tm)
    x = rng.normal(size=dense.shape[1]).astype(np.float32)
    want = RD.get_impl(fmt, "spmv", tier="kernel")(rf, jnp.asarray(x),
                                                   interpret=True)
    fn, found = TD.resolve_impl(fmt, "spmv", tier="kernel")
    assert found == "kernel"
    got = fn(tf, t_(x))
    assert got.dtype == torch.float32 and got.shape == (dense.shape[0],)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(f32(got), dense @ x, **TOL)
    np.testing.assert_allclose(f32(TD.spmv(tf, t_(x), tier="kernel")),
                               dense @ x, **TOL)


@pytest.mark.parametrize("mat", sorted(MATS))
@pytest.mark.parametrize("fmt", FORMATS)
def test_reference_tier_spmv_and_spmm_match_reference(rng, fmt, mat):
    dense = MATS[mat](np.random.default_rng(22))
    rm, tm = both_csr(dense)
    rf, tf = RT.TRANSFORMS_HOST[fmt](rm), TT.TRANSFORMS_HOST[fmt](tm)
    x = rng.normal(size=dense.shape[1]).astype(np.float32)
    X = rng.normal(size=(dense.shape[1], 3)).astype(np.float32)
    assert TD.format_of(tf) == RD.format_of(rf) == fmt
    np.testing.assert_allclose(f32(TD.spmv(tf, t_(x))),
                               f32(RD.spmv(rf, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(f32(TD.spmv(tf, t_(x))), dense @ x, **TOL)
    np.testing.assert_allclose(f32(TD.spmm(tf, t_(X))),
                               f32(RD.spmm(rf, jnp.asarray(X))), **TOL)
    np.testing.assert_allclose(f32(TD.spmm(tf, t_(X))), dense @ X, **TOL)


def test_sell_all_zero_matrix_gives_typed_zeros():
    tm = TT.csr_from_dense(np.zeros((40, 30), np.float32), pad=8, device="cpu")
    sell = TT.host_csr_to_sell(tm)
    for dtype in (torch.float32, torch.bfloat16):
        y = T_ops.spmv_sell(sell, torch.ones(30, dtype=dtype))
        assert y.dtype == dtype and y.shape == (40,)
        assert not y.any()


def test_spmv_csr_via_coo_matches_native(rng):
    dense = heavy_tail_dense(rng)
    rm, tm = both_csr(dense)
    x = rng.normal(size=200).astype(np.float32)
    want = R_ops.spmv_csr_via_coo(rm, jnp.asarray(x), interpret=True)
    got = T_ops.spmv_csr_via_coo(tm, t_(x))
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(f32(got), f32(T_ops.spmv_csr(tm, t_(x))),
                               **TOL)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dd,xd", [("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
def test_output_dtype_is_the_promoted_type(rng, fmt, dd, xd):
    import dataclasses
    dense = random_dense(rng, 60, 45, 0.15)
    tm = TT.csr_from_dense(dense, pad=8, device="cpu")
    tm = dataclasses.replace(tm, data=tm.data.to(TDT[dd]))
    tf = TT.TRANSFORMS_HOST[fmt](tm)
    rm = RT.csr_from_dense(dense, pad=8)
    rm = dataclasses.replace(rm, data=jnp.asarray(rm.data, JDT[dd]))
    rf = RT.TRANSFORMS_HOST[fmt](rm)
    x = rng.normal(size=45).astype(np.float32)
    got = TD.spmv(tf, t_(x, xd), tier="kernel")
    want = RD.get_impl(fmt, "spmv", tier="kernel")(
        rf, jnp.asarray(x, JDT[xd]), interpret=True)
    # promote_types(data, x) everywhere but SELL, whose result takes x's
    # dtype in the reference (and so here)
    promoted = jnp.dtype(jnp.result_type(JDT[dd], JDT[xd])).name
    assert want.dtype.name == (xd if fmt == "sell" else promoted)
    assert str(got.dtype).replace("torch.", "") == want.dtype.name
    np.testing.assert_allclose(f32(got), f32(want), rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(f32(got), dense @ x, rtol=5e-2, atol=5e-2)


def test_sell_per_bucket_tunings_resolve_like_reference(rng):
    dense = heavy_tail_dense(rng)
    rm, tm = both_csr(dense)
    rs = RT.host_csr_to_sell(rm, slice_rows=16)
    ts = TT.host_csr_to_sell(tm, slice_rows=16)
    widths = ts.widths
    assert widths == rs.widths and len(widths) >= 2
    table = {widths[0]: dict(block_rows=8), widths[-1]: dict(block_rows=64)}
    for mk, ops_, m in ((RTile, R_ops, rs), (TileGeometry, T_ops, ts)):
        base = mk(block_rows=32,
                  buckets=tuple((w, mk(**g)) for w, g in table.items()))
        out = ops_._sell_tunings(m, base)
        assert [g.block_rows for g in out] == \
            [table.get(w, {"block_rows": 32})["block_rows"] for w in widths]
        assert ops_._sell_tunings(m, None) == (None,) * len(widths)
        assert ops_._sell_tunings(m, {widths[0]: mk(block_rows=8)})[1] is None
        with pytest.raises(ValueError):
            ops_._sell_tunings(m, [None])
    x = rng.normal(size=200).astype(np.float32)
    g = TileGeometry(block_rows=32, buckets=((widths[0],
                                              TileGeometry(block_rows=8)),))
    np.testing.assert_allclose(f32(T_ops.spmv_sell(ts, t_(x), tuning=g)),
                               dense @ x, **TOL)


# ---------------------------------------------------------------------------
# gradients through the differentiable ELL wrapper
# ---------------------------------------------------------------------------
def test_ell_spmv_ad_grads_match_jax_grad(rng):
    n_rows, width, n_cols = 32, 16, 48
    data = rng.normal(size=(n_rows, width)).astype(np.float32)
    cols = rng.integers(0, n_cols, (n_rows, width)).astype(np.int32)
    x = rng.normal(size=n_cols).astype(np.float32)
    jc = jnp.asarray(cols)

    def loss(dd, v):
        return jnp.sum(R_ops.ell_spmv_ad(dd, jc, v) ** 2)

    gd_ref, gx_ref = jax.grad(loss, argnums=(0, 1))(jnp.asarray(data),
                                                    jnp.asarray(x))
    td = t_(data).requires_grad_(True)
    tx = t_(x).requires_grad_(True)
    y = T_ops.ell_spmv_ad(td, t_(cols), tx)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(f32(td.grad), f32(gd_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(f32(tx.grad), f32(gx_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        f32(y), f32(R_ref.ell_spmv_ref(jnp.asarray(data), jc,
                                       jnp.asarray(x))), **TOL)


# ---------------------------------------------------------------------------
# the registry and the wrappers' contract
# ---------------------------------------------------------------------------
def test_kernel_tier_is_always_registered_for_spmv_only():
    """Both ops are registered at the kernel tier for every format (the
    name predates the SpMM kernels; spmv and spmm now resolve alike)."""
    registered = FORMATS + ("hybrid",)
    for op, table in (("spmv", T_ops.KERNEL_SPMV_IMPLS),
                      ("spmm", T_ops.KERNEL_SPMM_IMPLS)):
        assert set(TD.registered_formats(op, tier="kernel")) == \
            set(registered)
        assert set(table) == set(registered)
        assert table == TD.impl_table(op, "kernel")
        for fmt in registered:
            assert TD.resolve_impl(fmt, op, tier="kernel")[1] == "kernel"
            assert TD.resolve_impl(fmt, op, tier="kernel",
                                   fallback=False)[1] == "kernel"
            assert TD.get_impl(fmt, op, tier="kernel") is not \
                TD.get_impl(fmt, op, tier="reference")
    assert TD.get_impl("csr", "spmv", tier="kernel") is T_ops.spmv_csr
    assert TD.get_impl("ell_col", "spmv", tier="kernel") is T_ops.spmv_ell
    assert TD.get_impl("csr", "spmm", tier="kernel") is T_ops.spmm_csr
    assert TD.get_impl("sell", "spmm", tier="kernel") is T_ops.spmm_sell
    assert TD.get_impl("hybrid", "spmv", tier="kernel") is T_ops.spmv_hybrid
    with pytest.raises(KeyError):
        TD.register_impl("csr", "nope", lambda m, x: x)
    with pytest.raises(ValueError):
        TD.spmm(None, torch.ones(3))


def test_tuning_reaches_only_the_kernel_tier(rng):
    dense = random_dense(rng, 30, 20, 0.2)
    tm = TT.csr_from_dense(dense, pad=8, device="cpu")
    x = t_(rng.normal(size=20).astype(np.float32))
    g = TileGeometry(block_rows=16)
    np.testing.assert_allclose(
        f32(TD.dispatch(tm, x, tier="kernel", tuning=g)),
        f32(TD.dispatch(tm, x, tier="reference", tuning=g)), **TOL)
    X = t_(rng.normal(size=(20, 2)).astype(np.float32))
    gk = TileGeometry(block_rows=16, block_k=8)
    got = TD.dispatch(tm, X, op="spmm", tier="kernel", tuning=gk)
    assert got.shape == (30, 2)
    np.testing.assert_allclose(
        f32(got), f32(TD.dispatch(tm, X, op="spmm", tier="reference",
                                  tuning=gk)), **TOL)
    np.testing.assert_allclose(f32(got), dense @ f32(X), **TOL)


@pytest.mark.parametrize("bad", ["data_dtype", "cols_dtype", "cols_shape",
                                 "x_ndim", "data_ndim"])
def test_ell_wrapper_refuses_what_the_kernel_does_not_take(bad):
    data, cols, x = torch.ones(4, 3), torch.zeros(4, 3, dtype=torch.int32), \
        torch.ones(5)
    if bad == "data_dtype":
        data = data.double()
    elif bad == "cols_dtype":
        cols = cols.long()
    elif bad == "cols_shape":
        cols = cols[:, :2]
    elif bad == "x_ndim":
        x = torch.ones(5, 1)
    elif bad == "data_ndim":
        data, cols = data[0], cols[0]
    with pytest.raises((TypeError, ValueError)):
        K1.ell_spmv(data, cols, x)


def test_csr_and_coo_wrappers_refuse_bad_arguments():
    data, cols = torch.ones(6), torch.zeros(6, dtype=torch.int32)
    ip = torch.tensor([0, 2, 6], dtype=torch.int32)
    x = torch.ones(4)
    with pytest.raises(TypeError):
        K2.csr_spmv(data, cols, ip.long(), x)
    with pytest.raises(TypeError):
        K2.csr_spmv(data.double(), cols, ip, x)
    with pytest.raises(ValueError):
        K2.csr_spmv(data, cols[:4], ip, x)
    with pytest.raises(TypeError):
        K3.coo_spmv(data, cols.long(), cols, x, 2)
    with pytest.raises(ValueError):
        K3.coo_spmv(data, cols, cols[:3], x, 2)
    with pytest.raises(TypeError):
        K3.coo_spmv(data, cols, cols, x.half(), 2)


def test_cpu_calls_launch_no_kernel(rng):
    TK.reset_launch_counts()
    dense = random_dense(rng, 30, 20, 0.2)
    tm = TT.csr_from_dense(dense, pad=8, device="cpu")
    x = t_(rng.normal(size=20).astype(np.float32))
    X = torch.stack([x, 2 * x], dim=1)
    for fmt in FORMATS:
        TD.spmv(TT.TRANSFORMS_HOST[fmt](tm), x, tier="kernel")
        TD.spmm(TT.TRANSFORMS_HOST[fmt](tm), X, tier="kernel")
    assert TK.launch_counts() == {"ell_spmv": 0, "csr_spmv": 0,
                                  "coo_spmv": 0, "ell_spmm": 0,
                                  "csr_spmm": 0, "coo_spmm": 0,
                                  "ccs_spmv": 0, "ccs_spmm": 0,
                                  "bcsr_spmv": 0, "bcsr_spmm": 0,
                                  "decode_attention_int8": 0}


def test_build_is_keyed_by_source_hash_and_needs_nvcc(tmp_path, monkeypatch):
    assert T_build.build_dir().parts[-2:] == ("build", "repro_torch")
    for name in T_build.KERNELS:
        assert (T_build.CSRC / f"{name}.cu").is_file()
        h = T_build.source_hash(name)
        assert len(h) == 16 and h == T_build.source_hash(name)
        assert T_build.library_path(name) == \
            T_build.build_dir() / f"{name}-{h}.so"
        assert len(T_build.SIGNATURES[name]) >= 10
    assert len({T_build.source_hash(n) for n in T_build.KERNELS}) == \
        len(T_build.KERNELS) == 11
    with pytest.raises(RuntimeError):
        T_build.check_launch("ell_spmv", 9)
    T_build.check_launch("ell_spmv", 0)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert shutil.which("nvcc") is None
    with pytest.raises(T_build.KernelBuildError):
        T_build.find_nvcc()
    with pytest.raises(T_build.KernelBuildError):
        T_build.build_all(("ell_spmv",), force=True)
