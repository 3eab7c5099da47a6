"""Port vs reference: CCS and BCSR — containers, transforms, both tiers,
plan JSON and the tuner's records.

The same numpy inputs (made from a seed) go through ``repro`` (JAX, its
Pallas kernels in interpret mode on the CPU, as its own tests run them) and
``repro_torch`` (PyTorch on the CPU, whose kernel wrappers run each CUDA
kernel's plain version there).

Tolerances, relative to ``sum_k |a_rk * x_k|`` of each output element (the
scale the summation error grows with): 1e-4 for float32 (CCS scatters by
row and BCSR sums a block row's tiles in another order than the reference),
2e-2 for bfloat16 (the output is rounded to 8 bits).  Containers are
compared exactly: they are copies, and BCSR's summed duplicates are summed
in the same order.
"""
import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as RA
from repro.core import dispatch as RD
from repro.core import formats as RF
from repro.core import kernel_tune as RKT
from repro.core import plan as RPL
from repro.core import transform as RT
from repro.kernels import ops as R_ops
from repro_torch.core import autotune as TA
from repro_torch.core import dispatch as TD
from repro_torch.core import formats as TF
from repro_torch.core import kernel_tune as TKT
from repro_torch.core import plan as TPL
from repro_torch.core import transform as TT
from repro_torch.core.kernel_tune import KernelTuner, TileGeometry
from repro_torch.kernels import _common as C
from repro_torch.kernels import bcsr_spmv as K9
from repro_torch.kernels import ccs_spmv as K7
from repro_torch.kernels import ops as T_ops

# the modules (``core/__init__`` re-exports the function ``spmv`` over them)
RS = importlib.import_module("repro.core.spmv")
TS = importlib.import_module("repro_torch.core.spmv")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FMTS = ("ccs", "bcsr")


def rel_tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 1e-4


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def t_(a, dtype="float32"):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a).to(TDT[dtype] if np.issubdtype(
        a.dtype, np.floating) else torch.int32)


def as_dtype(a, dtype):
    return np.asarray(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))


def assert_rel_close(got, want, mag, tol):
    got, want = f32(got), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got.astype(np.float64) - want)
    bad = err > tol * np.asarray(mag, np.float64) + 1e-30
    assert not bad.any(), (float((err / (mag + 1e-30)).max()), tol)


def random_dense(rng, n_rows, n_cols, density):
    d = (rng.random((n_rows, n_cols)) < density).astype(np.float32)
    return d * rng.normal(1.0, 1.0, size=d.shape).astype(np.float32)


def columns_dense(rng):
    """A dense column, a 3/4 column, a run of empty columns and an empty
    last row among sparse ones (the transpose of the heavy-tail rows);
    neither side is a multiple of 8."""
    n_rows, n_cols = 203, 130
    dense = ((rng.random((n_rows, n_cols)) < 0.02) *
             rng.normal(size=(n_rows, n_cols))).astype(np.float32)
    dense[:, 5] = rng.normal(size=n_rows)
    dense[:150, 70] = rng.normal(size=150)
    dense[:, 30:40] = 0.0
    dense[-1] = 0.0
    return dense


MATS = {
    "columns": columns_dense,
    "all_zero": lambda rng: np.zeros((40, 30), np.float32),
}

#: the ragged shapes of the reference's own BCSR tests
SHAPES = [((32, 32), 0.2), ((65, 40), 0.1), ((16, 16), 0.9),
          ((100, 64), 0.05), ((100, 61), 0.2), ((80, 48), 0.3),
          ((256, 256), 0.05), ((40, 30), 0.0)]


def both_csr(dense, dtype="float32"):
    rm = RT.csr_from_dense(dense, pad=8)
    tm = TT.csr_from_dense(dense, pad=8, device="cpu")
    if dtype != "float32":
        rm = dataclasses.replace(rm, data=jnp.asarray(rm.data, JDT[dtype]))
        tm = dataclasses.replace(tm, data=tm.data.to(TDT[dtype]))
    return rm, tm


def both(dense, fmt, dtype="float32", **kw):
    rm, tm = both_csr(dense, dtype)
    if fmt == "bcsr":
        return RT.host_csr_to_bcsr(rm, **kw), TT.host_csr_to_bcsr(tm, **kw)
    return RT.host_csr_to_ccs(rm), TT.host_csr_to_ccs(tm)


def ref_arrays(m):
    """``(fmt_name, arrays, meta)`` of a reference CCS/BCSR container."""
    if isinstance(m, RF.BCSR):
        return ("bcsr", {"data": np.asarray(m.data),
                         "block_cols": np.asarray(m.block_cols),
                         "indptr": np.asarray(m.indptr)},
                {"shape": m.shape, "nnz": m.nnz, "block": m.block})
    return ("ccs", {"data": np.asarray(m.data), "rows": np.asarray(m.rows),
                    "indptr": np.asarray(m.indptr)},
            {"shape": m.shape, "nnz": m.nnz})


def assert_same(ref_m, port_m):
    """Reference container == port container, field by field and bit for
    bit (values compared as raw float32 or bfloat16 bits)."""
    rname, rarr, rmeta = ref_arrays(ref_m)
    pname, parr, pmeta = TF.to_numpy(port_m)
    assert pname == rname and pmeta == rmeta
    assert set(parr) == set(rarr)
    for k, want in rarr.items():
        got = parr[k]
        if want.dtype.name == "bfloat16":
            want = want.astype(np.float32)
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if np.issubdtype(want.dtype, np.floating):
            got, want = got.view(np.uint32), want.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=k)


# ---------------------------------------------------------------------------
# containers and transforms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,density", SHAPES)
def test_ccs_equals_reference_field_by_field(shape, density):
    dense = random_dense(np.random.default_rng(sum(shape)), *shape, density)
    rm, tm = both_csr(dense)
    port = TT.host_csr_to_ccs(tm)
    assert_same(RT.host_csr_to_ccs(rm), port)
    assert_same(RT.host_csr_to_ccs_paper(rm), TT.host_csr_to_ccs_paper(tm))
    assert_same(RT.host_csr_to_ccs_paper(rm), port)     # the paper's loop
    np.testing.assert_array_equal(port.todense(), dense)
    assert port.validate() is port


@pytest.mark.parametrize("block", [4, 8, 16])
@pytest.mark.parametrize("shape,density", SHAPES)
def test_bcsr_equals_reference_bit_for_bit(shape, density, block):
    dense = random_dense(np.random.default_rng(sum(shape) + block), *shape,
                         density)
    ref, port = both(dense, "bcsr", block=block)
    assert_same(ref, port)
    np.testing.assert_array_equal(port.todense(), dense)
    assert port.validate() is port
    assert TF.bcsr_fill_ratio(port) == RF.bcsr_fill_ratio(ref)
    assert TF.memory_bytes(port) == RF.memory_bytes(ref)


@pytest.mark.parametrize("block", [3, 8])
def test_bcsr_sums_duplicates_in_the_reference_order(block):
    """CSR may hold a (row, col) more than once: each cell's duplicates are
    summed in CSR order, as the reference's per-block loop sums them."""
    rng = np.random.default_rng(7)
    row_cols, row_vals = [], []
    for _ in range(37):
        c = rng.integers(0, 23, size=rng.integers(0, 9)).astype(np.int32)
        row_cols.append(np.concatenate([c, c[:2], c[:1]]))
        row_vals.append(rng.normal(size=row_cols[-1].shape[0]).astype(
            np.float32) * 10.0 ** rng.integers(-4, 5, row_cols[-1].shape[0]))
    rm = RT.csr_from_rows(row_cols, row_vals, n_cols=23, pad=4)
    tm = TT.csr_from_rows(row_cols, row_vals, n_cols=23, pad=4,
                          device="cpu")
    assert_same(RT.host_csr_to_bcsr(rm, block=block),
                TT.host_csr_to_bcsr(tm, block=block))


@pytest.mark.parametrize("fmt", FMTS)
def test_bfloat16_containers_equal_reference(fmt):
    dense = random_dense(np.random.default_rng(8), 100, 61, 0.2)
    ref, port = both(dense, fmt, "bfloat16")
    assert port.data.dtype == torch.bfloat16
    assert_same(ref, port)


@pytest.mark.parametrize("fmt", FMTS)
def test_from_numpy_to_numpy_carry_both_formats(fmt):
    dense = columns_dense(np.random.default_rng(9))
    ref, port = both(dense, fmt)
    name, arrays, meta = ref_arrays(ref)
    rebuilt = TF.from_numpy(name, arrays, meta, device="cpu")
    assert type(rebuilt) is type(port)
    assert_same(ref, rebuilt)
    name2, arrays2, meta2 = TF.to_numpy(rebuilt)
    again = TF.from_numpy(name2, arrays2, meta2, device="cpu")
    assert_same(ref, again)
    assert TD.format_of(again) == RD.format_of(ref) == fmt
    assert again.device == torch.device("cpu")
    assert again.to("cpu").validate() is not None


def test_transforms_host_and_formats_registered_like_reference():
    assert {"ccs", "bcsr", "hybrid"} <= set(TT.TRANSFORMS_HOST)
    assert list(TT.TRANSFORMS_HOST) == list(RT.TRANSFORMS_HOST)
    assert TF.FORMAT_NAMES == RF.FORMAT_NAMES
    assert "hybrid" in TF.FORMAT_NAMES
    assert TPL.DEFAULT_RECIPE_PARAMS == RPL.DEFAULT_RECIPE_PARAMS
    assert TPL._SLAB_FORMATS == RPL._SLAB_FORMATS


@pytest.mark.parametrize("mat", sorted(MATS))
def test_device_csr_to_ccs_matches_host_and_reference(mat):
    dense = MATS[mat](np.random.default_rng(10))
    rm, tm = both_csr(dense)
    dev = TT.device_csr_to_ccs(tm)
    host = TT.host_csr_to_ccs(tm)
    assert_same(RT.host_csr_to_ccs(rm), host)
    for k in ("data", "rows", "indptr"):
        got, want = getattr(dev, k), getattr(host, k)
        assert got.dtype == want.dtype, k
        assert torch.equal(got, want), k
    assert dev.validate() is dev
    rdev = RT.device_csr_to_ccs(rm)
    np.testing.assert_array_equal(dev.indptr.numpy(),
                                  np.asarray(rdev.indptr))


# ---------------------------------------------------------------------------
# validate(): the same corruptions refused with the same message
# ---------------------------------------------------------------------------
CCS_CORRUPTIONS = ["indptr_start", "indptr_decreasing", "indptr_tail",
                   "indptr_shape", "row_too_big", "row_negative",
                   "rows_shape", "float_rows", "nnz_over_pad"]
BCSR_CORRUPTIONS = ["bad_block", "tile_shape", "indptr_shape",
                    "indptr_start", "indptr_decreasing", "too_many_blocks",
                    "block_cols_shape", "nnz_too_big", "block_col_range",
                    "float_block_cols"]


def _parts(fmt):
    dense = random_dense(np.random.default_rng(12), 30, 21, 0.3)
    ref, _ = both(dense, fmt)
    name, arrays, meta = ref_arrays(ref)
    return name, {k: v.copy() for k, v in arrays.items()}, dict(meta)


@pytest.mark.parametrize("kind", CCS_CORRUPTIONS)
def test_ccs_validate_rejects_like_reference(kind):
    name, a, meta = _parts("ccs")
    nnz = meta["nnz"]
    if kind == "indptr_start":
        a["indptr"][0] = 1
    elif kind == "indptr_decreasing":
        a["indptr"][3] = a["indptr"][4] + 1
    elif kind == "indptr_tail":
        a["indptr"][-1] -= 1
    elif kind == "indptr_shape":
        a["indptr"] = a["indptr"][:-1]
    elif kind == "row_too_big":
        a["rows"][nnz - 1] = meta["shape"][0]
    elif kind == "row_negative":
        a["rows"][0] = -1
    elif kind == "rows_shape":
        a["rows"] = a["rows"][:-1]
    elif kind == "float_rows":
        a["rows"] = a["rows"].astype(np.float32)
    elif kind == "nnz_over_pad":
        meta["nnz"] = a["data"].shape[0] + 1
        a["indptr"][-1] = meta["nnz"]
    ref = RF.CCS(**a, **meta)
    port = TF.from_numpy(name, a, meta, device="cpu")
    with pytest.raises(RF.MatrixValidationError) as r:
        ref.validate()
    with pytest.raises(TF.MatrixValidationError) as p:
        port.validate()
    assert str(p.value) == str(r.value)


@pytest.mark.parametrize("kind", BCSR_CORRUPTIONS)
def test_bcsr_validate_rejects_like_reference(kind):
    name, a, meta = _parts("bcsr")
    nblocks = int(a["indptr"][-1])
    if kind == "bad_block":
        meta["block"] = 0
    elif kind == "tile_shape":
        a["data"] = a["data"][:, :, :-1]
    elif kind == "indptr_shape":
        a["indptr"] = a["indptr"][:-1]
    elif kind == "indptr_start":
        a["indptr"][0] = 1
    elif kind == "indptr_decreasing":
        a["indptr"][1] = a["indptr"][2] + 1
    elif kind == "too_many_blocks":
        a["indptr"][-1] = a["data"].shape[0] + 1
    elif kind == "block_cols_shape":
        a["block_cols"] = a["block_cols"][:-1]
    elif kind == "nnz_too_big":
        meta["nnz"] = nblocks * 64 + 1
    elif kind == "block_col_range":
        a["block_cols"][nblocks - 1] = 3
    elif kind == "float_block_cols":
        a["block_cols"] = a["block_cols"].astype(np.float32)
    ref = RF.BCSR(**a, **meta)
    port = TF.from_numpy(name, a, meta, device="cpu")
    with pytest.raises(RF.MatrixValidationError) as r:
        ref.validate()
    with pytest.raises(TF.MatrixValidationError) as p:
        port.validate()
    assert str(p.value) == str(r.value)


# ---------------------------------------------------------------------------
# products: the reference tier and the kernel tier's plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch", [None, 1, 3, 128])
@pytest.mark.parametrize("mat", sorted(MATS))
@pytest.mark.parametrize("fmt", FMTS)
def test_reference_tier_matches_reference(fmt, mat, batch):
    rng = np.random.default_rng(13)
    dense = MATS[mat](rng)
    ref, port = both(dense, fmt)
    shape = (dense.shape[1],) if batch is None else (dense.shape[1], batch)
    x = rng.normal(size=shape).astype(np.float32)
    op = "spmv" if batch is None else "spmm"
    got = getattr(TS, f"{op}_{fmt}")(port, t_(x))
    want = getattr(RS, f"{op}_{fmt}")(ref, jnp.asarray(x))
    assert TD.get_impl(fmt, op) is getattr(TS, f"{op}_{fmt}")
    mag = np.abs(dense) @ np.abs(x)
    assert_rel_close(got, f32(want), mag, rel_tol("float32"))
    assert_rel_close(got, dense.astype(np.float64) @ x, mag,
                     rel_tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [None, 1, 3, 128])
@pytest.mark.parametrize("mat", sorted(MATS))
@pytest.mark.parametrize("fmt", FMTS)
def test_kernel_tier_matches_reference_kernels(fmt, mat, batch, dtype):
    """The format-level wrappers against the reference's Pallas kernels in
    interpret mode: same inputs, same output dtype, same product."""
    rng = np.random.default_rng(14)
    dense = MATS[mat](rng)
    ref, port = both(dense, fmt, dtype)
    shape = (dense.shape[1],) if batch is None else (dense.shape[1], batch)
    x = rng.normal(size=shape).astype(np.float32)
    op = "spmv" if batch is None else "spmm"
    fn, found = TD.resolve_impl(fmt, op, tier="kernel")
    assert found == "kernel" and fn is getattr(T_ops, f"{op}_{fmt}")
    got = fn(port, t_(x, dtype))
    want = getattr(R_ops, f"{op}_{fmt}")(ref, jnp.asarray(x, JDT[dtype]),
                                         interpret=True)
    assert tuple(got.shape) == tuple(want.shape)
    assert str(got.dtype).replace("torch.", "") == want.dtype.name
    d, xx = as_dtype(dense, dtype), as_dtype(x, dtype)
    mag = np.abs(d) @ np.abs(xx)
    assert_rel_close(got, f32(want), mag, rel_tol(dtype))
    assert_rel_close(got, d.astype(np.float64) @ xx, mag, rel_tol(dtype))


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("dd,xd", [("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
def test_mixed_dtypes_give_the_reference_output_dtype(fmt, dd, xd):
    rng = np.random.default_rng(15)
    dense = columns_dense(rng)
    ref, port = both(dense, fmt, dd)
    x = rng.normal(size=(130, 3)).astype(np.float32)
    for op, xs in (("spmv", x[:, 0]), ("spmm", x)):
        got = getattr(T_ops, f"{op}_{fmt}")(port, t_(xs, xd))
        want = getattr(R_ops, f"{op}_{fmt}")(ref, jnp.asarray(xs, JDT[xd]),
                                             interpret=True)
        assert want.dtype.name == "float32"
        assert got.dtype == torch.float32
        mag = np.abs(dense) @ np.abs(xs)
        assert_rel_close(got, f32(want), mag, 2e-2)
        # the reference tier follows the reference's own types too
        rt = getattr(TS, f"{op}_{fmt}")(port, t_(xs, xd))
        rw = getattr(RS, f"{op}_{fmt}")(ref, jnp.asarray(xs, JDT[xd]))
        assert str(rt.dtype).replace("torch.", "") == rw.dtype.name


@pytest.mark.parametrize("block", [3, 4, 8, 16])
@pytest.mark.parametrize("batch", [None, 2])
def test_bcsr_plain_versions_at_every_block_size(block, batch):
    rng = np.random.default_rng(16 + block)
    dense = columns_dense(rng)
    ref, port = both(dense, "bcsr", block=block)
    shape = (130,) if batch is None else (130, batch)
    x = rng.normal(size=shape).astype(np.float32)
    fn = K9.bcsr_spmv if batch is None else K9.bcsr_spmm
    got = fn(port.data, port.block_cols, port.indptr, t_(x), port.n_rows)
    want = (R_ops.spmv_bcsr if batch is None else R_ops.spmm_bcsr)(
        ref, jnp.asarray(x), interpret=True)
    mag = np.abs(dense) @ np.abs(x)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert_rel_close(got, f32(want), mag, rel_tol("float32"))


def test_plain_spmm_versions_chunk_their_temporaries(monkeypatch):
    rng = np.random.default_rng(17)
    dense = columns_dense(rng)
    _, ccs = both(dense, "ccs")
    _, bcsr = both(dense, "bcsr")
    X = t_(rng.normal(size=(130, 5)).astype(np.float32))
    full = (K7.ccs_spmm_plain(ccs.data, ccs.rows, ccs.indptr, X, 203),
            K9.bcsr_spmm_plain(bcsr.data, bcsr.block_cols, bcsr.indptr, X,
                               203))
    for mod in (C, K7, K9):
        monkeypatch.setattr(mod, "PLAIN_CHUNK_ELEMS", 64)
    chunked = (K7.ccs_spmm_plain(ccs.data, ccs.rows, ccs.indptr, X, 203),
               K9.bcsr_spmm_plain(bcsr.data, bcsr.block_cols, bcsr.indptr,
                                  X, 203))
    for a, b in zip(full, chunked):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(f32(a), dense @ f32(X), rtol=1e-4,
                                   atol=1e-4)


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    data, rows = torch.ones(6), torch.zeros(6, dtype=torch.int32)
    ip = torch.tensor([0, 2, 6], dtype=torch.int32)
    with pytest.raises(TypeError):
        K7.ccs_spmv(data, rows, ip.long(), torch.ones(2), 3)
    with pytest.raises(ValueError):
        K7.ccs_spmv(data, rows, ip, torch.ones(3), 3)    # x of 3, 2 columns
    with pytest.raises(ValueError):
        K7.ccs_spmm(data, rows[:4], ip, torch.ones(2, 2), 3)
    with pytest.raises(TypeError):
        K7.ccs_spmm(data.double(), rows, ip, torch.ones(2, 2), 3)
    blocks = torch.ones(2, 4, 4)
    bc = torch.zeros(2, dtype=torch.int32)
    bip = torch.tensor([0, 1, 2], dtype=torch.int32)
    with pytest.raises(ValueError):
        K9.bcsr_spmv(torch.ones(2, 4, 3), bc, bip, torch.ones(4), 8)
    with pytest.raises(TypeError):
        K9.bcsr_spmv(blocks, bc, bip, torch.ones(4), 13)   # 4 block rows
    with pytest.raises(TypeError):
        K9.bcsr_spmm(blocks, bc.long(), bip, torch.ones(4, 2), 8)
    with pytest.raises(ValueError):
        K9.bcsr_spmm(blocks, bc, bip, torch.ones(4), 8)    # 1-D X
    np.testing.assert_allclose(
        f32(K9.bcsr_spmv(blocks, bc, bip, torch.ones(4), 7)),
        [4.0] * 7)


def test_cpu_tensors_launch_no_kernel():
    from repro_torch import kernels as TK
    TK.reset_launch_counts()
    dense = columns_dense(np.random.default_rng(18))
    for fmt in FMTS:
        _, port = both(dense, fmt)
        TD.spmv(port, torch.ones(130), tier="kernel")
        TD.spmm(port, torch.ones(130, 4), tier="kernel")
    assert not any(TK.launch_counts().values())
    assert {"ccs_spmv", "ccs_spmm", "bcsr_spmv", "bcsr_spmm"} <= \
        set(TK.launch_counts())


# ---------------------------------------------------------------------------
# the launch shapes and the reference's slab bound
# ---------------------------------------------------------------------------
def test_ccs_bcsr_launch_shapes_are_chosen_on_the_host():
    # CCS SpMV: 8 warps of 32 columns by default, a window of 128 rows
    # where a warp's columns and a mean column on either side fit (256 past)
    assert C.ccs_spmv_launch(629856, 629856, 15466752) == (256, 256, 32, 128)
    assert C.ccs_spmv_launch(116158, 116158, 8516500) == (256, 256, 32, 256)
    assert C.ccs_spmv_launch(100, 100, 5000, 1) == (32, 1, 1, 100)
    assert C.ccs_spmv_launch(10 ** 4, 10 ** 4, 10 ** 5, 12) == (256, 16, 2,
                                                                128)
    assert C.bcsr_spmv_launch(8) == (256, 32)
    assert C.bcsr_spmv_launch(8, 1) == (32, 4)     # a whole warp
    assert C.bcsr_spmv_launch(8, 1000) == (1024, 128)
    assert C.bcsr_spmv_launch(3, 10) == (32, 10)
    assert C.bcsr_spmv_launch(16, 4) == (64, 4)
    assert C.bcsr_spmv_launch(2048) == (256, 1)
    for b in (1, 3, 4, 8, 16, 48, 100):
        for r in (None, 1, 5, 64, 10 ** 6):
            threads, rows = C.bcsr_spmv_launch(b, r)
            assert 32 <= threads <= 1024 and threads % 32 == 0
            assert rows >= 1
            # a candidate carrying the block rows makes the same launch
            assert C.bcsr_spmv_launch(b, rows)[0] == threads or b > 32


@pytest.mark.parametrize("batch,block_rows,block_k", [
    (128, None, None), (128, 8, None), (128, 1024, None), (8, None, None),
    (1, None, None), (1, 1024, None), (130, None, 32), (3, 5, None)])
@pytest.mark.parametrize("shape", [(629856, 629856, 15466752),
                                   (524304, 524304, 6103216),
                                   (116158, 116158, 8516500), (100, 61, 856),
                                   (40, 30, 8), (7, 5000, 20000)])
def test_ccs_spmm_window_is_chosen_on_the_host(shape, batch, block_rows,
                                               block_k):
    """K8's launch: the column tile as before; the block's columns rounded
    as a row group is (so a tuner candidate is the launch).  A tile of a
    whole warp keeps a window: ``DEFAULT_THREADS`` threads, at least
    ``CCS_SPMM_COLS`` columns by default, rows covering those the columns map
    to plus a mean column, a power of two of rows a lane group (2 to
    ``CCS_ROWS_PER_GROUP_MAX``), within the matrix, under 48 KB of shared
    memory.  A narrower tile runs a lane group a column, no window."""
    n_rows, n_cols, nnz_pad = shape
    kt, lanes, per, threads, cols, window, rpg = C.ccs_spmm_launch(
        batch, n_rows, n_cols, nnz_pad, block_rows, block_k)
    assert (kt, lanes, per) == C.rhs_tile(batch, block_k)
    if lanes < 32:
        assert (window, rpg) == (0, 0) and per == 1
        assert cols == C.rows_per_block(lanes, block_rows)
        assert threads == cols * lanes == C.clamp_threads(threads)
        return
    assert threads == C.DEFAULT_THREADS
    assert cols == C.rows_per_block(lanes, block_rows or C.CCS_SPMM_COLS)
    groups = C.DEFAULT_THREADS // lanes
    need = -(-cols * n_rows // n_cols) + -(-nnz_pad // n_cols)
    assert rpg in (2, 4, 8, 16)
    assert rpg * groups >= need or rpg == C.CCS_ROWS_PER_GROUP_MAX
    assert rpg == 2 or (rpg // 2) * groups < need
    assert window == min(rpg * groups, n_rows)
    smem = 4 * (cols * lanes * per + cols + 1 + window
                + 5 * 4 * C.DEFAULT_THREADS)
    assert smem <= 48 * 1024
    if shape[0] == 629856 and (batch, block_rows, block_k) == (128, None,
                                                               None):
        # xenon2@x4 at B = 128: 32 columns, 8 warps of 8 rows: 64 rows
        assert (cols, window, rpg) == (32, 64, 8)
    for b in range(min(-(-n_cols // cols), 9)):
        base = C.ccs_window_base(b, cols, window, n_rows, n_cols)
        assert 0 <= base <= n_rows - window


@pytest.mark.parametrize("block_rows", [None] + list(TKT.GPU_ROW_TILES)
                         + [3, 12, 1000])
@pytest.mark.parametrize("shape", [(629856, 629856, 15466752),
                                   (524304, 524304, 6103216),
                                   (116158, 116158, 8516500), (100, 61, 856),
                                   (40, 30, 8), (7, 5000, 20000)])
def test_ccs_spmv_launch_is_the_tuners_candidate(shape, block_rows):
    """K7's launch: ``block_rows`` columns a block, rounded up to whole runs
    of columns for at most 8 warps — so the columns a tuner candidate
    carries give that candidate's launch again — and a window of a power of
    two of rows from 128 to 256 covering a warp's columns' rows plus a mean
    column either side, within the matrix, under 48 KB of shared memory.
    Each ``GPU_ROW_TILES`` entry that gives a warp two columns or more is a
    candidate of the grid."""
    n_rows, n_cols, nnz_pad = shape
    threads, cols, per_warp, window = C.ccs_spmv_launch(
        n_rows, n_cols, nnz_pad, block_rows)
    warps = threads // 32
    assert threads % 32 == 0 and 1 <= warps <= C.CCS_SPMV_WARPS
    assert cols == warps * per_warp >= (block_rows or 1)
    assert (per_warp - 1) * warps < (block_rows or cols)
    assert C.ccs_spmv_launch(n_rows, n_cols, nnz_pad, cols) == (
        threads, cols, per_warp, window)
    if block_rows is None:
        assert per_warp == C.CCS_SPMV_COLS_PER_WARP
    span = -(-per_warp * n_rows // n_cols) + 2 * -(-nnz_pad // n_cols)
    full = min(max(C.CCS_SPMV_WINDOW_MIN, span), C.CCS_SPMV_WINDOW_MAX)
    assert window == min(n_rows, 1 << (full - 1).bit_length())
    assert warps * window * (4 * 4 + 1) <= 48 * 1024   # four windows, a flag
    grid = [g.block_rows for g in TKT.candidate_geometries(
        "ccs", "spmv", n_rows=n_cols, nnz_pad=nnz_pad)]
    assert len(grid) == len(set(grid))
    for g in grid:
        assert C.ccs_spmv_launch(n_rows, n_cols, nnz_pad, g)[1] == g
    if block_rows in TKT.GPU_ROW_TILES and block_rows <= n_cols:
        assert (cols in grid) == (block_rows >= 2 * C.CCS_SPMV_WARPS)


def brute_flushes(rows, indptr, n_rows, cols, window):
    """The global atomics of K8, entry by entry: one per distinct window row
    a block touches, one per entry outside its window."""
    ip = indptr.numpy()
    n_cols = ip.shape[0] - 1
    touched, outside = set(), 0
    for c in range(n_cols):
        b = c // cols
        base = C.ccs_window_base(b, cols, window, n_rows, n_cols)
        for k in range(ip[c], ip[c + 1]):
            r = int(rows[k])
            if base <= r < base + window:
                touched.add((b, r))
            else:
                outside += 1
    return len(touched), outside


@pytest.mark.parametrize("batch,block_rows", [(128, None), (32, None),
                                              (8, None), (128, 3)])
@pytest.mark.parametrize("kind", ["band", "scattered", "shuffled"])
def test_ccs_spmm_flushes_counted_on_the_host(kind, batch, block_rows):
    """``ccs_spmm_flushes`` equals an entry-by-entry count; a band flushes
    few window rows and a scattered matrix almost only entries outside."""
    rng = np.random.default_rng(19)
    n = 300
    if kind == "scattered":
        dense = (rng.random((n, n)) < 0.03) * rng.normal(size=(n, n))
    else:
        i = np.arange(n)[:, None]
        dense = (np.abs(i - np.arange(n)[None, :]) <= 5) * rng.normal(
            size=(n, n))
    m = TT.host_csr_to_ccs(TT.csr_from_dense(dense.astype(np.float32),
                                             pad=8, device="cpu"))
    rows = m.rows.clone()
    if kind == "shuffled":
        ip = m.indptr.numpy()
        for a, b in zip(ip[:-1], ip[1:]):
            rows[a:b] = rows[a:b][torch.from_numpy(rng.permutation(b - a))]
    got = K7.ccs_spmm_flushes(rows, m.indptr, m.n_rows, batch, block_rows)
    _, _, _, _, cols, window, _ = C.ccs_spmm_launch(
        batch, m.n_rows, m.n_cols, rows.shape[0], block_rows)
    if window:
        flushed, outside = brute_flushes(rows, m.indptr, m.n_rows, cols,
                                         window)
    else:                     # a narrow tile: every entry straight to Y
        flushed, outside = 0, m.nnz
    assert got == {"cols": cols, "window": window, "flushed": flushed,
                   "outside": outside,
                   "atomics": (flushed + outside) * batch}
    if kind != "scattered" and block_rows is None and batch > 16:
        assert outside == 0 and flushed < m.nnz / 3


def ccs_spmv_case(kind, rng):
    """``(rows, indptr, n_rows)`` of a K7 flush-count case: ``band``,
    ``scattered``, ``duplicates`` (columns holding one row many times),
    ``empty`` (runs of empty columns) and ``edges`` (entries in the first
    and last rows, where the windows are clamped to the matrix)."""
    n = 700
    lists = []
    for c in range(n):
        if kind == "band":
            r = np.arange(max(0, c - 9), min(n, c + 10))
        elif kind == "scattered":
            r = np.sort(rng.choice(n, 5, replace=False))
        elif kind == "duplicates":
            r = np.concatenate([np.full(7, c), rng.integers(0, n, 3)])
        elif kind == "empty":
            r = (np.arange(c, min(n, c + 4)) if c % 90 < 40
                 else np.array([], np.int64))
        else:
            r = np.array([0, 1, n - 2, n - 1, c])
        lists.append(np.asarray(r, np.int64))
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in lists])])
    rows = np.concatenate(lists + [np.zeros(5)]).astype(np.int32)  # pads
    return torch.from_numpy(rows), torch.from_numpy(
        indptr.astype(np.int32)), n


@pytest.mark.parametrize("block_rows", [None, 1, 16, 1024])
@pytest.mark.parametrize("kind", ["band", "scattered", "duplicates",
                                  "empty", "edges"])
def test_ccs_spmv_flushes_counted_on_the_host(kind, block_rows):
    """``ccs_spmv_flushes`` equals an entry-by-entry count over each warp's
    run of columns and its window; a band flushes few window rows."""
    rows, indptr, n = ccs_spmv_case(kind, np.random.default_rng(29))
    got = K7.ccs_spmv_flushes(rows, indptr, n, block_rows)
    _, _, per_warp, window = C.ccs_spmv_launch(n, n, rows.shape[0],
                                               block_rows)
    flushed, outside = brute_flushes(rows, indptr, n, per_warp, window)
    assert got == {"cols": per_warp, "window": window, "flushed": flushed,
                   "outside": outside, "atomics": flushed + outside}
    if kind == "band" and block_rows is None:
        assert outside == 0 and flushed < int(indptr[-1]) / 8
    if kind == "edges":
        # the first and last warps' windows hold the matrix's first and
        # last rows
        assert C.ccs_window_base(0, per_warp, window, n, n) == 0
        last = -(-n // per_warp) - 1
        assert C.ccs_window_base(last, per_warp, window, n, n) == n - window


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["duplicates", "shuffled"])
def test_ccs_spmv_plain_matches_reference_on_repeated_and_shuffled_rows(
        kind, dtype):
    """``ccs_spmv_plain`` against the reference's CCS kernel (interpret
    mode) on columns that hold one row several times (``CCS.validate``
    allows it) and on columns whose rows are in random order; tolerance
    ``rel_tol(dtype)`` of sum |a x|."""
    rng = np.random.default_rng(30)
    if kind == "duplicates":
        rows, indptr, n = ccs_spmv_case("duplicates", rng)
    else:
        rows, indptr, n = ccs_spmv_case("band", rng)
        ip = indptr.numpy()
        rows = rows.clone()
        for a, b in zip(ip[:-1], ip[1:]):
            rows[a:b] = rows[a:b][torch.from_numpy(rng.permutation(b - a))]
    data = rng.normal(size=rows.shape[0]).astype(np.float32)
    x = rng.normal(size=n).astype(np.float32)
    nnz = int(indptr[-1])
    ref = RF.CCS(data=jnp.asarray(data, JDT[dtype]),
                 rows=jnp.asarray(rows.numpy()),
                 indptr=jnp.asarray(indptr.numpy()), shape=(n, n), nnz=nnz)
    ref.validate()
    want = R_ops.spmv_ccs(ref, jnp.asarray(x))
    got = K7.ccs_spmv_plain(t_(data, dtype), rows, indptr, t_(x), n)
    dense = np.zeros((n, n), np.float64)
    cols = np.repeat(np.arange(n), np.diff(indptr.numpy()))
    np.add.at(dense, (rows.numpy()[:nnz], cols),
              np.abs(as_dtype(data, dtype)[:nnz]))
    mag = dense @ np.abs(x)
    assert_rel_close(got, f32(want), mag, rel_tol(dtype))
    assert_rel_close(got, np.asarray(ref.todense(), np.float64) @ x, mag,
                     rel_tol(dtype))


@pytest.mark.parametrize("g", [None, dict(block_rows=8, block_nnz=64),
                               dict(block_rows=3), dict(block_nnz=4096),
                               dict(block_rows=1000, block_nnz=8,
                                    slabs_per_block=99)])
@pytest.mark.parametrize("fmt", FMTS)
def test_exact_slab_bound_matches_reference(fmt, g):
    dense = columns_dense(np.random.default_rng(19))
    ref, port = both(dense, fmt)
    tg = TileGeometry(**g) if g else None
    rg = RKT.TileGeometry(**g) if g else None
    assert T_ops.exact_slab_bound(port, tg) == \
        R_ops.exact_slab_bound(ref, rg)
    if fmt == "bcsr":
        assert T_ops._bcsr_geometry(port, tg) == \
            R_ops._bcsr_geometry(ref, rg)
    with pytest.raises(TypeError):
        T_ops.exact_slab_bound(TT.host_csr_to_coo_row(both_csr(dense)[1]))


def tall_dense():
    """Many rows, few columns: CSR's row blocks each span fewer slabs than
    CCS's single column block, so the two bounds differ."""
    return random_dense(np.random.default_rng(20), 600, 20, 0.5)


@pytest.mark.parametrize("fmt", FMTS)
def test_bound_slab_bound_is_the_bound_matrix_s(fmt):
    """The bound recorded at bind is the reference's bound of the matrix
    the plan binds (CCS: over the column pointer; BCSR: over the block
    IRP), not the source CSR's; it fails with the CSR's bound."""
    dense = tall_dense()
    rm, tm = both_csr(dense)
    tplan = TPL.Planner(tier="kernel", device="cpu").plan(tm, fmt=fmt)
    rplan = RPL.Planner(tier="kernel").plan(rm, fmt=fmt)
    P_t = tplan.bind(tm, device="cpu")
    P_r = rplan.bind(rm)
    mat = TT.TRANSFORMS_HOST[fmt](tm)
    for op in ("spmv", "spmm"):
        spb = P_t.tunings[op].slabs_per_block
        assert spb == P_r.tunings[op].slabs_per_block
        assert spb == T_ops.exact_slab_bound(mat)
    if fmt == "ccs":
        assert spb != T_ops.exact_slab_bound(tm)
    x = np.random.default_rng(1).normal(size=20).astype(np.float32)
    np.testing.assert_allclose(f32(P_t @ t_(x)), dense @ x, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("fmt", FMTS)
def test_plan_json_binds_in_both_packages(fmt, batch, tmp_path):
    dense = columns_dense(np.random.default_rng(21))
    rm, tm = both_csr(dense)
    rplan = RPL.Planner(tier="kernel").plan(rm, fmt=fmt, batch=batch)
    tplan = TPL.Planner(tier="kernel", device="cpu").plan(tm, fmt=fmt,
                                                         batch=batch)
    assert tplan.to_dict() == rplan.to_dict()
    assert tplan.transform.params == ({"block": 8} if fmt == "bcsr" else {})
    rpath, tpath = tmp_path / "ref.json", tmp_path / "port.json"
    rplan.save(str(rpath))
    tplan.save(str(tpath))
    in_port = TPL.ExecutionPlan.load(str(rpath)).bind(tm, device="cpu")
    in_ref = RPL.ExecutionPlan.load(str(tpath)).bind(rm)
    assert in_port.tiers == in_ref.tiers == {"spmv": "kernel",
                                             "spmm": "kernel"}
    for op in ("spmv", "spmm"):
        assert in_port.tunings[op].to_dict() == in_ref.tunings[op].to_dict()
        assert in_port.tunings[op].slabs_per_block is not None
    X = np.random.default_rng(2).normal(size=(130, 4)).astype(np.float32)
    mag = np.abs(dense) @ np.abs(X)
    assert_rel_close(in_port @ t_(X), f32(in_ref @ jnp.asarray(X)), mag,
                     1e-4)
    assert_rel_close(in_port @ t_(X), dense.astype(np.float64) @ X, mag,
                     1e-4)


def test_plan_with_another_block_size_replays_it(tmp_path):
    dense = columns_dense(np.random.default_rng(22))
    rm, tm = both_csr(dense)
    rplan = RPL.Planner(tier="kernel").plan(rm, fmt="bcsr")
    rplan.transform = RPL.TransformRecipe("bcsr", {"block": 4})
    path = tmp_path / "plan.json"
    rplan.save(str(path))
    P = TPL.ExecutionPlan.load(str(path)).bind(tm, device="cpu")
    assert P.matrix.block == 4
    x = np.ones(130, np.float32)
    np.testing.assert_allclose(f32(P @ t_(x)), dense @ x, rtol=1e-4,
                               atol=1e-4)


def test_paper_rule_serves_ccs_and_bcsr_from_the_db():
    """A TuningDB whose D* moves every matrix to the named format: the
    paper's rule picks it in both packages, and it binds at the kernel
    tier."""
    dense = columns_dense(np.random.default_rng(23))
    rm, tm = both_csr(dense)
    for fmt in FMTS:
        rdb = RA.TuningDB(machine="m", c=1.0, records=[],
                          d_star={fmt: 100.0})
        tdb = TA.TuningDB.from_json(rdb.to_json())
        rplan = RPL.Planner(db=rdb, rule="paper", tier="kernel").plan(
            rm, formats=(fmt,), batch=4)
        tplan = TPL.Planner(db=tdb, rule="paper", tier="kernel",
                            device="cpu").plan(tm, formats=(fmt,), batch=4)
        assert tplan.fmt == rplan.fmt == fmt
        assert tplan.to_dict() == rplan.to_dict()
        P = tplan.bind(tm, db=tdb, device="cpu")
        assert P.tiers == {"spmv": "kernel", "spmm": "kernel"}
        x = np.ones(130, np.float32)
        np.testing.assert_allclose(f32(P @ t_(x)), dense @ x, rtol=1e-4,
                                   atol=1e-4)


def test_offline_phase_measures_both_formats_with_kernel_impls():
    dense = columns_dense(np.random.default_rng(24))
    _, tm = both_csr(dense)
    tuner = KernelTuner(timer=lambda thunk, g: (thunk(), 1.0)[1])
    for batch, kw in ((1, {"spmv_impls": T_ops.KERNEL_SPMV_IMPLS}),
                      (4, {"spmm_impls": T_ops.KERNEL_SPMM_IMPLS})):
        db = TA.offline_phase([("m0", tm)], formats=FMTS, iters=1,
                              machine="cpu", batch=batch, device="cpu",
                              tuner=tuner, **kw)
        rec = db.records[0]
        assert set(rec.formats) == set(FMTS) and rec.batch == batch
        for f in FMTS:
            assert rec.formats[f].t_spmv > 0 and rec.formats[f].t_trans > 0
        assert rec.formats["bcsr"].mem_ratio > rec.formats["ccs"].mem_ratio
        assert set(db.d_star) == set(FMTS)
        op = "spmv" if batch == 1 else "spmm"
        assert {(g.fmt, g.op) for g in db.geometries} >= {
            ("ccs", op), ("bcsr", op)}
        RA.TuningDB.from_json(db.to_json())     # loads in the reference


# ---------------------------------------------------------------------------
# the tuner: records, the column-space D_mat, BCSR's own slab defaults
# ---------------------------------------------------------------------------
def fake_timer():
    def timer(thunk, g):
        thunk()
        if g is None:
            return 1.0
        return 0.5 + abs((g.block_rows or 32) - 8) * 1e-3 + \
            abs((g.block_k or 8) - 8) * 1e-4
    return timer


@pytest.mark.parametrize("fmt", FMTS)
def test_profile_d_mat_matches_reference(fmt):
    dense = columns_dense(np.random.default_rng(25))
    ref, port = both(dense, fmt)
    got = TKT._profile_of(port)
    want = RKT._profile_of(ref)
    assert got == want
    if fmt == "ccs":
        lens = np.diff(np.asarray(ref.indptr)).astype(np.float64)
        assert got[2] == pytest.approx(lens.std() / lens.mean())
        assert got[2] > 0


@pytest.mark.parametrize("fmt", FMTS)
def test_slab_bound_of_a_candidate_matches_reference(fmt):
    dense = tall_dense()
    ref, port = both(dense, fmt)
    for g in ({}, dict(block_rows=4), dict(block_nnz=64),
              dict(block_rows=2, block_nnz=16)):
        assert TKT._slab_bound_for(port, TileGeometry(**g)) == \
            RKT._slab_bound_for(ref, RKT.TileGeometry(**g))


@pytest.mark.parametrize("op,batch", [("spmv", 1), ("spmm", 8)])
@pytest.mark.parametrize("fmt", FMTS)
def test_tuner_records_match_reference_and_load_there(fmt, op, batch):
    """Without ``stats`` the record's profile is the container's own (the
    column-space D_mat for CCS), the winner carries the reference's slab
    bound at its geometry, and the records load in the reference's
    TuningDB, whose tuner answers from them."""
    dense = columns_dense(np.random.default_rng(26))
    ref, port = both(dense, fmt)
    db = TA.TuningDB(machine="t", c=1.0, records=[], d_star={})
    rec = KernelTuner(db=db, timer=fake_timer()).tune(port, op=op,
                                                      batch=batch)
    assert rec.fmt == fmt and rec.op == op and rec.batch == batch
    assert (rec.n, rec.nnz, rec.d_mat, rec.sig) == RKT._profile_of(ref)
    g = rec.geometry
    assert g.block_rows is not None
    assert g.slabs_per_block == RKT._slab_bound_for(
        ref, RKT.TileGeometry(**g.without_slab_bound().to_dict()))
    text = db.to_json()
    rdb = RA.TuningDB.from_json(text)
    assert json.loads(rdb.to_json()) == json.loads(text)
    rt = RKT.KernelTuner(db=rdb)
    assert rt.best(ref, op=op, batch=batch).to_dict() == g.to_dict()
    back = TA.TuningDB.from_json(rdb.to_json())
    assert KernelTuner(db=back).best(port, op=op, batch=batch) == g
    x = np.ones((130,) if op == "spmv" else (130, batch), np.float32)
    fn = TD.get_impl(fmt, op, tier="kernel")
    np.testing.assert_allclose(f32(fn(port, t_(x), tuning=g)), dense @ x,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fmt", FMTS)
def test_planner_with_a_tuner_binds_the_winners(fmt):
    dense = columns_dense(np.random.default_rng(27))
    _, tm = both_csr(dense)
    db = TA.TuningDB(machine="t", c=1.0, records=[], d_star={})
    tuner = KernelTuner(db, timer=fake_timer())
    plan = TPL.Planner(db=db, tuner=tuner, device="cpu").plan(
        tm, fmt=fmt, batch=8)
    P = plan.bind(tm, db=db, device="cpu")
    recs = {(r.op, r.batch): r for r in db.geometries if r.fmt == fmt}
    assert set(recs) == {("spmv", 1), ("spmm", 8)}
    for op, b in (("spmv", 1), ("spmm", 8)):
        assert P.tunings[op].without_slab_bound() == \
            recs[(op, b)].geometry.without_slab_bound()
        assert P.tunings[op].slabs_per_block == T_ops.exact_slab_bound(
            P.matrix, P.tunings[op])
    X = np.random.default_rng(3).normal(size=(130, 8)).astype(np.float32)
    np.testing.assert_allclose(f32(P @ t_(X)), dense @ X, rtol=1e-4,
                               atol=1e-4)
