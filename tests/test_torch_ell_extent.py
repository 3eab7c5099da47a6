"""Port vs reference: the ELL SpMV read up to each row's live extent.

A row's live extent is 1 + the last slot of its band that is not a
``(±0, column 0)`` pad (0 for a row of pads only).  The port computes it once
per panel (``kernels/ell_spmv.py:ell_extent``), keeps it beside the bound
container (``kernels/ops.py:prepare``) and its ELL SpMV kernel reads each
row only that far, adding ``0 * x[0]`` once for a row whose band holds a
pad.  On the CPU the wrappers run the plain version, which repeats that
arithmetic; the kernel is held to it on the card (``tests/test_torch_cuda.py``).

Here: the extent against a count in numpy on panels with explicit zeros,
empty and all-pad rows, both storage orders, every SELL bucket and bfloat16
``-0.0``; the plain version with an extent against the JAX package's ELL
kernel (interpret mode, as ``tests/test_kernels.py`` runs it) within 1e-4 of
``sum |a x|`` (bfloat16: 2e-2); the NaN positions of the port's pinned
reading; and where the extent is computed: by ``prepare``, in
``ExecutionPlan.bind`` and inside ``offline_phase``'s transformation time.
"""
import dataclasses
import gc
import time

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ops as R_ops
from repro_torch.core import autotune as TA
from repro_torch.core import plan as TPL
from repro_torch.core import transform as TT
from repro_torch.kernels import ell_spmv as K1
from repro_torch.kernels import ops as T_ops

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def np_extent(data, cols):
    """1 + the last slot that is not (+-0, column 0), per row (a loop)."""
    out = np.zeros(data.shape[0], np.int32)
    for r in range(data.shape[0]):
        for w in range(data.shape[1]):
            if data[r, w] != 0 or cols[r, w] != 0:
                out[r] = w + 1
    return out


def panel(kind, rng):
    """``(data, cols, n_cols)``: a (n_rows, width) ELL panel in numpy."""
    n_rows, width, n_cols = 40, 11, 23
    lens = rng.integers(0, width + 1, n_rows)
    slot = np.arange(width)
    live = slot < lens[:, None]
    data = np.where(live, rng.normal(size=(n_rows, width)), 0.0).astype(
        np.float32)
    cols = np.where(live, rng.integers(1, n_cols, (n_rows, width)),
                    0).astype(np.int32)
    if kind == "explicit_zeros":
        # a stored zero at column c != 0 is live, so is a value at column 0;
        # a stored (0, column 0) in the middle of a row sits inside it
        data[3, 2], cols[3, 2] = 0.0, 7
        data[5, :4], cols[5, :4] = [1.5, 0.0, 0.0, 0.0], [0, 4, 0, 0]
        data[6, :6], cols[6, :6] = 2.0, 9
        data[6, 2], cols[6, 2] = 0.0, 0
        data[7, width - 1], cols[7, width - 1] = 0.0, 3   # zero in the last slot
    elif kind == "empty_rows":
        data[::4], cols[::4] = 0.0, 0
    elif kind == "all_pads":
        data[:], cols[:] = 0.0, 0
    elif kind == "negative_zero":
        # -0.0 at column 0 is a pad; -0.0 at another column is not
        data[data == 0] = -0.0
        data[9, 4], cols[9, 4] = -0.0, 5
    elif kind == "full":
        data = rng.normal(size=(n_rows, width)).astype(np.float32)
        cols = rng.integers(1, n_cols, (n_rows, width)).astype(np.int32)
    return data, cols, n_cols


KINDS = ("random", "explicit_zeros", "empty_rows", "all_pads",
         "negative_zero", "full")


def t_(a, dtype="float32"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        TDT[dtype] if np.issubdtype(np.asarray(a).dtype, np.floating)
        else torch.int32)


def as_dtype(a, dtype):
    return np.asarray(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["row", "col"])
@pytest.mark.parametrize("kind", KINDS)
def test_extent_matches_a_numpy_count(kind, order, dtype):
    data, cols, _ = panel(kind, np.random.default_rng(3))
    want = np_extent(data, cols)
    d, c = t_(data, dtype), t_(cols)
    if order == "col":      # column-major storage, viewed (n_rows, width)
        d, c = t_(data.T.copy(), dtype).t(), t_(cols.T.copy()).t()
    got = K1.ell_extent(d, c)
    assert got.dtype == torch.int32 and got.shape == (data.shape[0],)
    np.testing.assert_array_equal(got.numpy(), want)


def test_extent_of_bfloat16_negative_zero_is_a_pad():
    d = torch.tensor([[1.0, -0.0, -0.0], [-0.0, 0.0, 0.0]],
                     dtype=torch.bfloat16)
    c = torch.tensor([[3, 0, 0], [0, 0, 2]], dtype=torch.int32)
    assert torch.signbit(d[0, 1].float())
    assert K1.ell_extent(d, c).tolist() == [1, 3]


def test_extent_of_an_empty_band_is_zero():
    assert K1.ell_extent(torch.zeros(5, 0), torch.zeros(
        5, 0, dtype=torch.int32)).tolist() == [0] * 5


def band_matrix(rng, n=300, n_cols=240):
    """Rows of 0 to 14 entries in a band, one long row, an all-zero row."""
    dense = np.zeros((n, n_cols), np.float32)
    for r in range(n):
        k = int(rng.integers(0, 15))
        c0 = min(max(r * n_cols // n - k // 2, 0), n_cols - k)
        dense[r, c0:c0 + k] = rng.normal(size=k)
    dense[10, :] = rng.normal(size=n_cols)
    dense[11, :] = 0.0
    return dense


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_sell_bucket_gets_its_extent(dtype):
    rng = np.random.default_rng(5)
    tm = TT.csr_from_dense(band_matrix(rng), pad=8, device="cpu")
    tm = dataclasses.replace(tm, data=tm.data.to(TDT[dtype]))
    sell = T_ops.prepare(TT.TRANSFORMS_HOST["sell"](tm))
    assert len(sell.buckets) > 1
    for b in sell.buckets:
        got = T_ops.ell_extent_of(b)
        assert got is not None
        want = np_extent(b.data.float().numpy(), b.cols.numpy())
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fmt", ["ell_row", "ell_col", "sell"])
def test_prepare_attaches_once_and_the_product_reads_it(fmt, monkeypatch):
    rng = np.random.default_rng(6)
    dense = band_matrix(rng)
    m = TT.TRANSFORMS_HOST[fmt](TT.csr_from_dense(dense, pad=8,
                                                  device="cpu"))
    x = t_(rng.normal(size=dense.shape[1]).astype(np.float32))
    before = T_ops.spmv_ell(m, x) if fmt != "sell" else T_ops.spmv_sell(m, x)
    assert T_ops.prepare(m) is m
    panels = m.buckets if fmt == "sell" else (m,)
    ext = [T_ops.ell_extent_of(p) for p in panels]
    assert all(e is not None for e in ext)
    assert T_ops.prepare(m) is m          # a second call computes nothing
    assert all(T_ops.ell_extent_of(p) is e for p, e in zip(panels, ext))
    seen = []
    real = K1.ell_spmv_plain
    monkeypatch.setattr(K1, "ell_spmv_plain",
                        lambda d, c, xx, extent=None: seen.append(extent)
                        or real(d, c, xx, extent))
    after = T_ops.spmv_ell(m, x) if fmt != "sell" else T_ops.spmv_sell(m, x)
    read = [e if K1.extent_pays(e, p.width) else None
            for p, e in zip(panels, ext)]
    assert any(r is not None for r in read)
    assert all(s is r for s, r in zip(seen, read)) and len(seen) == len(ext)
    np.testing.assert_allclose(after.numpy(), before.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(after.numpy(), dense @ x.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_the_extent_is_read_only_where_the_band_holds_enough_pads():
    """A panel whose extents cover at most 3/4 of its slots is read up to
    them; one with fewer pads is read whole (the extent is one more load a
    row, and whole 64-byte runs of a row are fetched anyway)."""
    def panel_with(live_per_row, width=8, n_rows=10):
        d = torch.zeros(n_rows, width)
        d[:, :live_per_row] = 1.0
        return d, torch.ones(n_rows, width, dtype=torch.int32) * (d != 0)
    for live, pays in ((2, True), (6, True), (7, False), (8, False)):
        d, c = panel_with(live)
        assert K1.extent_pays(K1.ell_extent(d, c), 8) is pays
    # a container: one full row of 8 over rows of `live` entries
    for live, pays in ((1, True), (6, False)):
        dense = np.zeros((10, 12), np.float32)
        dense[:, :live] = 1.0
        dense[0, :8] = 2.0
        m = T_ops.prepare(TT.TRANSFORMS_HOST["ell_row"](TT.csr_from_dense(
            dense, pad=8, device="cpu")))
        assert T_ops.ell_extent_of(m) is not None
        assert (T_ops._extent_read(m) is not None) is pays
    assert not K1.extent_pays(torch.zeros(0, dtype=torch.int32), 8)
    assert not K1.extent_pays(torch.zeros(4, dtype=torch.int32), 0)


def test_extent_goes_with_its_container():
    m = TT.TRANSFORMS_HOST["ell_row"](TT.csr_from_dense(
        band_matrix(np.random.default_rng(7)), pad=8, device="cpu"))
    T_ops.prepare(m)
    n = len(T_ops._EXTENTS)
    del m
    gc.collect()
    assert len(T_ops._EXTENTS) == n - 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", ["row", "col"])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_with_extent_matches_reference(kind, order, dtype):
    """The plain version with an extent (what the kernel is held to)
    against the JAX package's ELL kernel on the same panel, finite x."""
    rng = np.random.default_rng(11)
    data, cols, n_cols = panel(kind, rng)
    x = rng.normal(size=n_cols).astype(np.float32)
    want = np.asarray(R_ops.ell_spmv_raw(jnp.asarray(data, JDT[dtype]),
                                         jnp.asarray(cols),
                                         jnp.asarray(x, JDT[dtype]),
                                         interpret=True), np.float32)
    d, c = t_(data, dtype), t_(cols)
    if order == "col":
        d, c = t_(data.T.copy(), dtype).t(), t_(cols.T.copy()).t()
    ext = K1.ell_extent(d, c)
    got = K1.ell_spmv(d, c, t_(x, dtype), extent=ext)   # CPU: the plain
    assert got.dtype == torch.float32
    dd, xx = as_dtype(data, dtype), as_dtype(x, dtype)
    mag = (np.abs(dd) * np.abs(xx)[cols]).sum(axis=1)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= TOL[dtype] * mag + 1e-30).all(), float(
        (err / (mag + 1e-30)).max())
    # the same values as reading the whole band
    np.testing.assert_array_equal(got.numpy(),
                                  K1.ell_spmv_plain(d, c, t_(x, dtype),
                                                    ext).numpy())
    np.testing.assert_allclose(got.numpy(),
                               K1.ell_spmv_plain(d, c, t_(x, dtype)).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("kind", KINDS)
def test_non_finite_x0_turns_exactly_the_padded_rows_nan(kind, bad):
    """The port's pinned reading: a row turns NaN where x[0] is not finite
    exactly when its band holds a (0, column 0) slot — with the extent (the
    pads past it add 0 * x[0] once) as without (every pad adds it)."""
    rng = np.random.default_rng(13)
    data, cols, n_cols = panel(kind, rng)
    x = rng.normal(size=n_cols).astype(np.float32)
    x[0] = bad
    d, c, xx = t_(data), t_(cols), t_(x)
    ext = K1.ell_extent(d, c)
    got = K1.ell_spmv_plain(d, c, xx, ext).numpy()
    band = K1.ell_spmv_plain(d, c, xx).numpy()
    has_pad = ((cols == 0) & (data == 0)).any(axis=1)
    reads_x0 = (cols == 0).any(axis=1)
    assert np.isnan(got[has_pad]).all()
    assert np.isfinite(got[~reads_x0]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(band))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(band))
    fin = np.isfinite(band)
    np.testing.assert_allclose(got[fin], band[fin], rtol=1e-6, atol=1e-6)


def test_non_finite_x_under_an_explicit_zero_is_read():
    """A stored zero at column c != 0 lies inside the extent: 0 * inf at
    x[c] makes its row NaN, as in the plain version that reads the band."""
    data = np.array([[1.0, 0.0, 2.0, 0.0], [1.0, 2.0, 0.0, 0.0],
                     [0.0, 0.0, 0.0, 0.0]], np.float32)
    cols = np.array([[1, 3, 2, 0], [1, 2, 0, 0], [3, 0, 0, 0]], np.int32)
    x = np.array([1.0, 2.0, 3.0, np.inf], np.float32)
    d, c, xx = t_(data), t_(cols), t_(x)
    ext = K1.ell_extent(d, c)
    assert ext.tolist() == [3, 2, 1]
    got = K1.ell_spmv_plain(d, c, xx, ext).numpy()
    assert np.isnan(got[[0, 2]]).all() and got[1] == 2.0 + 2.0 * 3.0
    np.testing.assert_array_equal(np.isnan(got),
                                  np.isnan(K1.ell_spmv_plain(d, c,
                                                             xx).numpy()))


def test_extent_rejects_a_wrong_shape_or_type():
    d, c = torch.ones(4, 3), torch.zeros(4, 3, dtype=torch.int32)
    x = torch.ones(2)
    with pytest.raises(ValueError):
        K1.ell_spmv(d, c, x, extent=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        K1.ell_spmv(d, c, x, extent=torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize("fmt", ["ell_row", "ell_col", "sell"])
def test_bind_computes_the_extent(fmt):
    """``ExecutionPlan.bind`` at the kernel tier leaves the bound panel
    prepared, so no product computes it; the product is the dense one."""
    rng = np.random.default_rng(17)
    dense = band_matrix(rng)
    csr = TT.csr_from_dense(dense, pad=8, device="cpu")
    P = TPL.Planner(tier="kernel", device="cpu").plan(csr, fmt=fmt).bind(
        csr, device="cpu")
    panels = P.matrix.buckets if fmt == "sell" else (P.matrix,)
    for p in panels:
        np.testing.assert_array_equal(T_ops.ell_extent_of(p).numpy(),
                                      np_extent(*_arrays(p)))
    x = rng.normal(size=dense.shape[1]).astype(np.float32)
    np.testing.assert_allclose((P @ t_(x)).numpy(), dense @ x, rtol=1e-5,
                               atol=1e-5)


def _arrays(p):
    d, c = p.data.float().numpy(), p.cols.numpy()
    return (d.T, c.T) if p.order == "col" else (d, c)


def test_reference_tier_bind_computes_no_extent():
    csr = TT.csr_from_dense(band_matrix(np.random.default_rng(19)), pad=8,
                            device="cpu")
    P = TPL.Planner(tier="reference", device="cpu").plan(
        csr, fmt="ell_row").bind(csr, device="cpu")
    assert P.tiers["spmv"] == "reference"
    assert T_ops.ell_extent_of(P.matrix) is None


def test_offline_phase_times_the_extent_with_the_transform(monkeypatch):
    """``offline_phase`` with the kernel impls computes each ELL panel's
    extent once, inside ``t_trans`` (here made to take 50 ms)."""
    calls = []
    real = T_ops.prepare

    def slow(m):
        calls.append(type(m).__name__)
        time.sleep(0.05)
        return real(m)
    monkeypatch.setattr(T_ops, "prepare", slow)
    csr = TT.csr_from_dense(band_matrix(np.random.default_rng(23)), pad=8,
                            device="cpu")
    db = TA.offline_phase([("band", csr)], formats=("ell_row", "sell"),
                          spmv_impls=T_ops.KERNEL_SPMV_IMPLS, iters=1,
                          device="cpu")
    # the CSR source's own set-up (what picks its SpMM kernel), the ELL
    # panel, then the SELL container (which prepares its buckets)
    assert calls[:3] == ["CSR", "ELL", "BucketedELL"]
    assert set(calls[3:]) == {"ELL"}
    for f in ("ell_row", "sell"):
        assert db.records[0].formats[f].t_trans >= 0.05


# ---------------------------------------------------------------------------
# a bound panel edited in place: its extents are taken anew before a read
# ---------------------------------------------------------------------------
def stale_case():
    """A 64 x 64 matrix, the identity plus 8 entries in row 0 (so each
    other row's band holds 7 pads and reading up to extents pays), and
    ``x = 1..64``."""
    dense = np.eye(64, dtype=np.float32)
    dense[0, 8:16] = 2.0
    return dense, np.arange(1, 65, dtype=np.float32)


def edit_first_pad_of_row(matrix, fmt, row, col, value):
    """Write ``(value, col)`` in place into ``row``'s first pad slot (slot
    1: each row but row 0 stores one entry) of a bound ELL panel or SELL
    bucket; returns the panel edited."""
    if fmt == "sell":
        perm = matrix.perm.numpy()
        for off, b in zip(matrix.row_offsets, matrix.buckets):
            hit = np.nonzero(perm[off:off + b.n_rows] == row)[0]
            if hit.size:
                p, r = b, int(hit[0])
                break
    else:
        p, r = matrix, row
    data, cols = (p.data.t(), p.cols.t()) if p.order == "col" else \
        (p.data, p.cols)
    assert float(data[r, 1]) == 0.0 and int(cols[r, 1]) == 0
    data[r, 1] = value
    cols[r, 1] = col
    return p


@pytest.mark.parametrize("fmt", ["ell_row", "ell_col", "sell"])
def test_a_bound_panel_edited_in_place_is_not_read_up_to_stale_extents(fmt):
    """The extents kept beside a bound panel are recomputed when its
    tensors change in place (their version counters moved), before the
    product reads them: row 5 gains 3.0 at column 7 in its first pad slot
    and the product is the dense one, y[5] = 6 + 3 * 8 = 30."""
    dense, x = stale_case()
    csr = TT.csr_from_dense(dense, pad=8, device="cpu")
    P = TPL.Planner(tier="kernel", rule="cost_model", device="cpu").plan(
        csr, fmt=fmt).bind(csr, device="cpu")
    p = edit_first_pad_of_row(P.matrix, fmt, row=5, col=7, value=3.0)
    old = T_ops._EXTENTS[p][0]
    assert T_ops._extent_read(p) is not None     # the extent is read
    dense[5, 7] = 3.0
    y = (P @ t_(x)).numpy()
    assert y[5] == 30.0
    np.testing.assert_allclose(y, dense @ x, rtol=1e-6, atol=1e-6)
    new = T_ops.ell_extent_of(p)
    assert new is not old
    np.testing.assert_array_equal(new.numpy(), np_extent(*_arrays(p)))
    # unedited since: the next product reads the same extents, none anew
    P @ t_(x)
    assert T_ops.ell_extent_of(p) is new
    assert T_ops._EXTENTS[p][2] == (p.data._version, p.cols._version)


def test_prepare_recomputes_an_edited_panel_and_keeps_an_unedited_one():
    dense, _ = stale_case()
    m = T_ops.prepare(TT.TRANSFORMS_HOST["ell_row"](TT.csr_from_dense(
        dense, pad=8, device="cpu")))
    first = T_ops.ell_extent_of(m)
    assert T_ops.prepare(m) is m and T_ops.ell_extent_of(m) is first
    assert int(first[5]) == 1
    edit_first_pad_of_row(m, "ell_row", row=5, col=7, value=3.0)
    T_ops.prepare(m)
    again = T_ops._EXTENTS[m][0]
    assert again is not first and int(again[5]) == 2


def _panels(m):
    """The ELL panels of a bound container: a panel, each SELL bucket, or
    those of each block of a hybrid container."""
    if isinstance(m, TT.ELL):
        return [m]
    if isinstance(m, TT.BucketedELL):
        return list(m.buckets)
    return [p for b in getattr(m, "blocks", ()) for p in _panels(b)]


@pytest.mark.parametrize("fmt", ["ell_row", "ell_col", "sell", "hybrid"])
def test_a_plan_bound_under_inference_mode_serves(fmt):
    """Inference tensors keep no version counter: a plan made, bound and
    served under ``torch.inference_mode()`` (the usual serving context)
    keeps the extents it was prepared with and gives the dense product,
    inside that mode and after it."""
    dense, x = stale_case()
    kw = ({"partition": "fixed", "block_rows": 32} if fmt == "hybrid"
          else {"fmt": fmt})
    with torch.inference_mode():
        csr = TT.csr_from_dense(dense, pad=8, device="cpu")
        P = TPL.Planner(tier="kernel", rule="cost_model", device="cpu").plan(
            csr, **kw).bind(csr, device="cpu")
        y = (P @ t_(x)).numpy()
    np.testing.assert_allclose(y, dense @ x, rtol=1e-6, atol=1e-6)
    panels = _panels(P.matrix)
    assert panels and all(p.data.is_inference() for p in panels)
    for p in panels:
        assert T_ops._EXTENTS[p][2] == (-1, -1)
        np.testing.assert_array_equal(T_ops.ell_extent_of(p).numpy(),
                                      np_extent(*_arrays(p)))
    np.testing.assert_allclose((P @ t_(x)).numpy(), dense @ x, rtol=1e-6,
                               atol=1e-6)
