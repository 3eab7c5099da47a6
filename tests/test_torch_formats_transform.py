"""Port vs reference: containers, statistics, host and device transforms.

The same numpy inputs (made from a seed) go through ``repro`` (JAX) and
``repro_torch`` (PyTorch, on the CPU here); every container is compared field
by field — integers exactly, float32 values exactly (they are copies).
"""
import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import formats as RF
from repro.core import transform as RT
from repro_torch.core import formats as TF
from repro_torch.core import suite as TS
from repro_torch.core import transform as TT
from repro_torch.device import default_device

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# helpers: one numpy matrix -> both packages; field-by-field comparison
# ---------------------------------------------------------------------------
def ref_parts(m):
    """(fmt_name, arrays, meta) of a reference container, in the shape
    ``repro_torch.core.formats.from_numpy`` takes."""
    if isinstance(m, RF.CSR):
        return ("csr", {"data": np.asarray(m.data), "cols": np.asarray(m.cols),
                        "indptr": np.asarray(m.indptr)},
                {"shape": m.shape, "nnz": m.nnz})
    if isinstance(m, RF.COO):
        return (f"coo_{m.order}",
                {"data": np.asarray(m.data), "rows": np.asarray(m.rows),
                 "cols": np.asarray(m.cols)},
                {"shape": m.shape, "nnz": m.nnz, "order": m.order})
    if isinstance(m, RF.ELL):
        return (f"ell_{m.order}",
                {"data": np.asarray(m.data), "cols": np.asarray(m.cols)},
                {"shape": m.shape, "nnz": m.nnz, "order": m.order})
    if isinstance(m, RF.BucketedELL):
        parts = [ref_parts(b) for b in m.buckets]
        return ("sell",
                {"perm": np.asarray(m.perm),
                 "buckets": [a for _, a, _ in parts]},
                {"shape": m.shape, "nnz": m.nnz,
                 "row_offsets": m.row_offsets,
                 "buckets": [mm for _, _, mm in parts]})
    raise TypeError(type(m))


def to_port(m):
    name, arrays, meta = ref_parts(m)
    return TF.from_numpy(name, arrays, meta, device="cpu")


def assert_arrays_equal(name, got, want):
    want = np.asarray(want)
    if want.dtype.name == "bfloat16":
        want = want.astype(np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=name)


def assert_same(ref_m, port_m):
    """Reference container == port container, field by field."""
    rname, rarr, rmeta = ref_parts(ref_m)
    pname, parr, pmeta = TF.to_numpy(port_m)
    assert pname == rname
    assert tuple(pmeta["shape"]) == tuple(rmeta["shape"])
    assert pmeta["nnz"] == rmeta["nnz"]
    assert pmeta.get("order") == rmeta.get("order")
    if rname == "sell":
        assert tuple(pmeta["row_offsets"]) == tuple(rmeta["row_offsets"])
        assert_arrays_equal("perm", parr["perm"], rarr["perm"])
        assert len(parr["buckets"]) == len(rarr["buckets"])
        for rb, pb in zip(ref_m.buckets, port_m.buckets):
            assert_same(rb, pb)
        return
    assert set(parr) == set(rarr)
    for k in rarr:
        assert_arrays_equal(k, parr[k], rarr[k])


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


def empty_rows_dense(rng):
    dense = random_dense(rng, 90, 70, 0.1)
    dense[10:25] = 0.0
    dense[-1] = 0.0
    return dense


MATRICES = {
    "random": lambda rng: random_dense(rng, 200, 150, 0.08),
    "ragged": lambda rng: random_dense(rng, 100, 61, 0.2),
    "heavy_tail": heavy_tail_dense,
    "empty_rows": empty_rows_dense,
    "all_zero": lambda rng: np.zeros((40, 30), np.float32),
    "tiny": lambda rng: random_dense(rng, 8, 8, 0.5),
}


@pytest.fixture(params=sorted(MATRICES))
def dense(request):
    return MATRICES[request.param](np.random.default_rng(11))


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pad", [1, 8, 128])
def test_csr_from_dense_matches_reference(dense, pad):
    assert_same(RT.csr_from_dense(dense, pad=pad),
                TT.csr_from_dense(dense, pad=pad, device="cpu"))


def test_csr_from_rows_matches_reference():
    rng = np.random.default_rng(3)
    lens = rng.integers(0, 9, size=50)
    row_cols = [np.sort(rng.choice(40, size=L, replace=False)).astype(np.int32)
                for L in lens]
    row_vals = [rng.normal(size=L).astype(np.float32) for L in lens]
    assert_same(RT.csr_from_rows(row_cols, row_vals, n_cols=40, pad=8),
                TT.csr_from_rows(row_cols, row_vals, n_cols=40, pad=8, device="cpu"))


def test_pad_to_multiple():
    for n, m in ((0, 8), (1, 8), (8, 8), (9, 8), (1000, 128)):
        assert TT.pad_to_multiple(n, m) == RT.pad_to_multiple(n, m)


def test_from_numpy_to_numpy_round_trip(dense):
    ref = RT.csr_from_dense(dense, pad=8)
    for name in ("csr", "coo_row", "coo_col", "ell_row", "ell_col", "sell"):
        rm = RT.TRANSFORMS_HOST[name](ref)
        pm = to_port(rm)
        fmt, arrays, meta = TF.to_numpy(pm)
        assert fmt == name
        assert_same(rm, TF.from_numpy(fmt, arrays, meta, device="cpu"))
        np.testing.assert_array_equal(pm.todense(), rm.todense())
        np.testing.assert_array_equal(pm.todense(), dense)


def test_indices_are_int32_and_values_keep_dtype():
    m = TT.csr_from_dense(random_dense(np.random.default_rng(0), 30, 20, .2),
                          pad=8, device="cpu")
    assert m.cols.dtype == torch.int32 and m.indptr.dtype == torch.int32
    assert m.data.dtype == torch.float32
    for name, t in TT.TRANSFORMS_HOST.items():
        out = t(m)
        for f in dataclasses.fields(out):
            v = getattr(out, f.name)
            if isinstance(v, torch.Tensor) and f.name != "data":
                assert v.dtype == torch.int32, (name, f.name)


# ---------------------------------------------------------------------------
# host transforms, statistics, footprint
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["coo_row", "coo_col", "ell_row", "ell_col",
                                 "sell", "csr"])
def test_host_transform_matches_reference(dense, fmt):
    ref_csr = RT.csr_from_dense(dense, pad=8)
    port_csr = TT.csr_from_dense(dense, pad=8, device="cpu")
    ref_out = RT.TRANSFORMS_HOST[fmt](ref_csr)
    port_out = TT.TRANSFORMS_HOST[fmt](port_csr)
    assert_same(ref_out, port_out)
    port_out.validate()
    assert TF.memory_bytes(port_out) == RF.memory_bytes(ref_out)


@pytest.mark.parametrize("width", [1, 5, 40])
@pytest.mark.parametrize("order", ["row", "col"])
def test_host_ell_explicit_width(order, width):
    dense = random_dense(np.random.default_rng(5), 64, 50, 0.2)
    assert_same(
        RT.host_csr_to_ell(RT.csr_from_dense(dense, pad=8), order, width),
        TT.host_csr_to_ell(TT.csr_from_dense(dense, pad=8, device="cpu"), order, width))


@pytest.mark.parametrize("slice_rows,quantum", [(128, 8), (16, 8), (32, 4)])
def test_host_sell_params(slice_rows, quantum):
    dense = heavy_tail_dense(np.random.default_rng(6))
    ref = RT.host_csr_to_sell(RT.csr_from_dense(dense, pad=8),
                              slice_rows=slice_rows, width_quantum=quantum)
    port = TT.host_csr_to_sell(TT.csr_from_dense(dense, pad=8, device="cpu"),
                               slice_rows=slice_rows, width_quantum=quantum)
    assert_same(ref, port)
    assert port.widths == ref.widths
    assert port.padded_nnz() == ref.padded_nnz()
    port.validate()


def test_host_transforms_carry_bfloat16_values():
    dense = random_dense(np.random.default_rng(8), 60, 45, 0.15)
    ref32 = RT.csr_from_dense(dense, pad=8)
    ref = RF.CSR(data=np.asarray(jnp.asarray(ref32.data, jnp.bfloat16)),
                 cols=ref32.cols, indptr=ref32.indptr, shape=ref32.shape,
                 nnz=ref32.nnz)
    port = to_port(ref)
    assert port.data.dtype == torch.bfloat16
    for name in ("coo_row", "coo_col", "ell_row", "ell_col", "sell"):
        out = TT.TRANSFORMS_HOST[name](port)
        assert_same(RT.TRANSFORMS_HOST[name](ref), out)
        leaf = out.buckets[0].data if name == "sell" else out.data
        assert leaf.dtype == torch.bfloat16


def test_matrix_stats_match_reference(dense):
    r = RF.MatrixStats.of(RT.csr_from_dense(dense, pad=8))
    p = TF.MatrixStats.of(TT.csr_from_dense(dense, pad=8, device="cpu"))
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert isinstance(p.sigma, float) and isinstance(p.max_row, int)


def test_matrix_stats_all_zero_matrix():
    dense = np.zeros((12, 9), np.float32)
    r = RF.MatrixStats.of(RT.csr_from_dense(dense, pad=8))
    p = TF.MatrixStats.of(TT.csr_from_dense(dense, pad=8, device="cpu"))
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert p.d_mat == float("inf")


# ---------------------------------------------------------------------------
# device transforms (torch ops on the tensor's device; the CPU here)
# ---------------------------------------------------------------------------
def _ref_device_csr(dense):
    m = RT.csr_from_dense(dense, pad=8)
    return RF.CSR(data=jnp.asarray(m.data), cols=jnp.asarray(m.cols),
                  indptr=jnp.asarray(m.indptr), shape=m.shape, nnz=m.nnz)


@pytest.mark.parametrize("order", ["row", "col"])
def test_device_csr_to_ell_matches_reference(dense, order):
    ref_csr = _ref_device_csr(dense)
    port_csr = TT.csr_from_dense(dense, pad=8, device="cpu")
    width = max(int(ref_csr.row_lengths().max()), 1)
    assert_same(RT.device_csr_to_ell(ref_csr, width, order),
                TT.device_csr_to_ell(port_csr, width, order))
    # and it agrees with the host recipe on everything but the nnz it reports
    host = TT.host_csr_to_ell(port_csr, order)
    devm = TT.device_csr_to_ell(port_csr, width, order)
    assert torch.equal(host.data, devm.data)
    assert torch.equal(host.cols, devm.cols)
    assert devm.data.is_contiguous()


def test_device_csr_to_coo_row_matches_reference(dense):
    assert_same(RT.device_csr_to_coo_row(_ref_device_csr(dense)),
                TT.device_csr_to_coo_row(TT.csr_from_dense(dense, pad=8, device="cpu")))


def test_device_csr_to_coo_col_matches_reference(dense):
    port_csr = TT.csr_from_dense(dense, pad=8, device="cpu")
    out = TT.device_csr_to_coo_col(port_csr)
    assert_same(RT.device_csr_to_coo_col(_ref_device_csr(dense)), out)
    assert_same(RT.host_csr_to_coo_col(RT.csr_from_dense(dense, pad=8)), out)
    out.validate()


# ---------------------------------------------------------------------------
# validate(): the same corruptions are rejected with the same message
# ---------------------------------------------------------------------------
def _csr_arrays():
    m = RT.csr_from_dense(
        random_dense(np.random.default_rng(2), 20, 15, 0.3), pad=8)
    return {"data": np.asarray(m.data).copy(),
            "cols": np.asarray(m.cols).copy(),
            "indptr": np.asarray(m.indptr).copy()}, \
        {"shape": m.shape, "nnz": m.nnz}


def _corrupt_csr(kind):
    a, meta = _csr_arrays()
    if kind == "indptr_start":
        a["indptr"][0] = 1
    elif kind == "indptr_decreasing":
        a["indptr"][5] = a["indptr"][4] - 1
    elif kind == "indptr_tail":
        meta["nnz"] = meta["nnz"] - 1
    elif kind == "indptr_shape":
        a["indptr"] = a["indptr"][:-1]
    elif kind == "col_too_big":
        a["cols"][0] = meta["shape"][1]
    elif kind == "col_negative":
        a["cols"][1] = -1
    elif kind == "cols_shape":
        a["cols"] = a["cols"][:-8]
    elif kind == "float_cols":
        a["cols"] = a["cols"].astype(np.float32)
    return a, meta


@pytest.mark.parametrize("kind", [
    "indptr_start", "indptr_decreasing", "indptr_tail", "indptr_shape",
    "col_too_big", "col_negative", "cols_shape", "float_cols"])
def test_csr_validate_rejects_like_reference(kind):
    a, meta = _corrupt_csr(kind)
    ref = RF.CSR(**a, **meta)
    port = TF.from_numpy("csr", a, meta, device="cpu")
    with pytest.raises(RF.MatrixValidationError) as r:
        ref.validate()
    with pytest.raises(TF.MatrixValidationError) as p:
        port.validate()
    assert str(p.value) == str(r.value)


def _coo_ell_cases():
    dense = random_dense(np.random.default_rng(4), 24, 18, 0.3)
    csr = RT.csr_from_dense(dense, pad=8)
    coo = ref_parts(RT.host_csr_to_coo_row(csr))
    ell = ref_parts(RT.host_csr_to_ell(csr))
    sell = ref_parts(RT.host_csr_to_sell(csr, slice_rows=8))
    return coo, ell, sell


def _copy_parts(parts):
    name, arrays, meta = parts
    arrays = {k: (v.copy() if isinstance(v, np.ndarray)
                  else [{kk: vv.copy() for kk, vv in b.items()} for b in v])
              for k, v in arrays.items()}
    return name, arrays, dict(meta)


def _build_ref(name, arrays, meta):
    if name.startswith("coo"):
        return RF.COO(**arrays, shape=meta["shape"], nnz=meta["nnz"],
                      order=meta["order"])
    if name.startswith("ell"):
        return RF.ELL(**arrays, shape=meta["shape"], nnz=meta["nnz"],
                      order=meta["order"])
    buckets = tuple(_build_ref("ell_row", a, m)
                    for a, m in zip(arrays["buckets"], meta["buckets"]))
    return RF.BucketedELL(perm=arrays["perm"], buckets=buckets,
                          row_offsets=tuple(meta["row_offsets"]),
                          shape=meta["shape"], nnz=meta["nnz"])


@pytest.mark.parametrize("kind", [
    "coo_unsorted", "coo_row_range", "coo_bad_order", "coo_nnz",
    "ell_col_range", "ell_bad_order", "ell_nnz", "ell_rows",
    "sell_perm", "sell_offsets", "sell_nnz"])
def test_coo_ell_sell_validate_rejects_like_reference(kind):
    coo, ell, sell = (_copy_parts(p) for p in _coo_ell_cases())
    if kind.startswith("coo"):
        name, a, meta = coo
        if kind == "coo_unsorted":
            a["rows"][[0, meta["nnz"] - 1]] = a["rows"][[meta["nnz"] - 1, 0]]
        elif kind == "coo_row_range":
            a["rows"][meta["nnz"] - 1] = meta["shape"][0]
        elif kind == "coo_bad_order":
            meta["order"] = "diag"
        elif kind == "coo_nnz":
            meta["nnz"] = a["data"].shape[0] + 1
    elif kind.startswith("ell"):
        name, a, meta = ell
        if kind == "ell_col_range":
            a["cols"][0, 0] = meta["shape"][1] + 3
        elif kind == "ell_bad_order":
            meta["order"] = "diag"
        elif kind == "ell_nnz":
            meta["nnz"] = a["data"].size + 1
        elif kind == "ell_rows":
            meta["shape"] = (meta["shape"][0] + 1, meta["shape"][1])
    else:
        name, a, meta = sell
        if kind == "sell_perm":
            a["perm"][0] = a["perm"][1]
        elif kind == "sell_offsets":
            meta["row_offsets"] = (1,) + tuple(meta["row_offsets"][1:])
        elif kind == "sell_nnz":
            meta["nnz"] = meta["nnz"] + 1
    ref = _build_ref(name, a, meta)
    port = TF.from_numpy(name, a, meta, device="cpu")
    with pytest.raises(RF.MatrixValidationError) as r:
        ref.validate()
    with pytest.raises(TF.MatrixValidationError) as p:
        port.validate()
    assert str(p.value) == str(r.value)


def test_validate_container_passes_good_and_returns_it():
    m = TT.csr_from_dense(random_dense(np.random.default_rng(1), 16, 16, .3), device="cpu")
    assert TF.validate_container(m) is m
    assert TF.validate_container(object()) is not None


# ---------------------------------------------------------------------------
# the device is explicit
# ---------------------------------------------------------------------------
def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            default_device()
        a, meta = _csr_arrays()
        with pytest.raises(RuntimeError):
            TF.from_numpy("csr", a, meta)          # device=None -> the card


@pytest.mark.parametrize("build", [
    lambda **kw: TT.csr_from_dense(np.eye(4, dtype=np.float32), **kw),
    lambda **kw: TT.csr_from_rows([np.array([0])], [np.array([1.0])],
                                  n_cols=2, **kw),
    lambda **kw: TS.synthesize(TS.TABLE1[0], scale=0.001, **kw),
    lambda **kw: TS.paper_suite(scale=0.001, include=["memplus"], **kw),
    lambda **kw: TS.synthesize_power_law(n=64, **kw),
], ids=["csr_from_dense", "csr_from_rows", "synthesize", "paper_suite",
        "synthesize_power_law"])
def test_constructors_default_to_the_card(build):
    """No constructor puts a matrix on the CPU unasked: without ``device=``
    the result lies on the card, or the call raises when there is none."""
    assert build(device="cpu") is not None
    if torch.cuda.is_available():
        out = build()
        m = out[0][1] if isinstance(out, list) else out
        assert m.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_containers_move_with_to_and_report_their_device():
    m = TT.host_csr_to_sell(TT.csr_from_dense(
        heavy_tail_dense(np.random.default_rng(9)), pad=8, device="cpu"), slice_rows=16)
    moved = m.to("cpu")
    assert moved.device == torch.device("cpu")
    assert all(b.device == torch.device("cpu") for b in moved.buckets)
    assert moved.row_offsets == m.row_offsets and moved.shape == m.shape
    assert "csr" in TF.FORMAT_NAMES and "sell" in TF.FORMAT_NAMES


# ---------------------------------------------------------------------------
# the port stands alone: no JAX, nothing of the JAX package
# ---------------------------------------------------------------------------
_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)(?:[\s.,]|$)|from\s+(?:jax|repro)[\s.])",
    re.MULTILINE)


def _port_sources():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_sources()
    assert len(files) > 15
    hits = []
    for f in files:
        for m in _FORBIDDEN.finditer(f.read_text()):
            hits.append(f"{f.relative_to(REPO)}: {m.group(0).strip()}")
    assert not hits, hits
    # the pattern does catch what it must, and spares the port's own name
    assert _FORBIDDEN.search("import jax\n")
    assert _FORBIDDEN.search("    from jax import numpy\n")
    assert _FORBIDDEN.search("from repro.core import x\n")
    assert _FORBIDDEN.search("import repro\n")
    assert not _FORBIDDEN.search("from repro_torch.core import x\n")
    assert not _FORBIDDEN.search("import repro_torch\n")


def test_port_names_no_tpu_quantity():
    words = re.compile(r"VMEM|v5e|819e9|sublane|\blanes/sublanes\b|\bTPU v")
    hits = [str(f.relative_to(REPO)) for f in _port_sources()
            if f.name != "chip_smoke.py" and words.search(f.read_text())]
    assert not hits, hits
