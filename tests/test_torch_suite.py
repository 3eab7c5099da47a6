"""Port vs reference: the synthetic Table-1 suite and the memory policy.

The port vectorizes the reference's per-row generator loop; these tests show
that every array it produces is identical to the reference's for every
Table-1 spec (at a small scale, so the reference's Python loop stays quick).
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import formats as RF
from repro.core import policy as RP
from repro.core import suite as RS
from repro_torch.core import formats as TF
from repro_torch.core import policy as TP
from repro_torch.core import suite as TS

SPEC_NAMES = [s.name for s in RS.TABLE1]


def assert_csr_identical(ref, port):
    assert port.shape == ref.shape and port.nnz == ref.nnz
    for name in ("data", "cols", "indptr"):
        want = np.asarray(getattr(ref, name))
        got = getattr(port, name).numpy()
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_table1_is_the_same_table():
    assert len(TS.TABLE1) == 22
    assert [dataclasses.asdict(s) for s in TS.TABLE1] == \
        [dataclasses.asdict(s) for s in RS.TABLE1]


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_synthesize_is_array_identical_to_reference(name):
    rspec = next(s for s in RS.TABLE1 if s.name == name)
    tspec = next(s for s in TS.TABLE1 if s.name == name)
    ref = RS.synthesize(rspec, scale=0.02)
    port = TS.synthesize(tspec, scale=0.02, device="cpu")
    assert_csr_identical(ref, port)
    assert port.data.dtype == torch.float32 and port.device.type == "cpu"
    port.validate()
    assert dataclasses.asdict(TF.MatrixStats.of(port)) == \
        dataclasses.asdict(RF.MatrixStats.of(ref))


@pytest.mark.parametrize("name,scale,seed,pad", [
    ("memplus", 0.05, 3, 8),        # scattered columns, two-point lengths
    ("epb2", 0.03, 1, 1),           # scattered, another hash stride
    ("xenon2", 0.01, 7, 128),       # banded, normal lengths
    ("torso1", 0.004, 0, 8),        # the heavy-tail extreme
    ("chem_master1", 0.0005, 0, 8),  # clamps to the 64-row minimum
])
def test_synthesize_other_scales_seeds_and_pads(name, scale, seed, pad):
    rspec = next(s for s in RS.TABLE1 if s.name == name)
    tspec = next(s for s in TS.TABLE1 if s.name == name)
    assert_csr_identical(RS.synthesize(rspec, scale=scale, seed=seed, pad=pad),
                         TS.synthesize(tspec, scale=scale, seed=seed, pad=pad, device="cpu"))


@pytest.mark.parametrize("random_values", [False, True])
@pytest.mark.parametrize("n,mu,alpha,seed", [(512, 8.0, 2.0, 0),
                                             (300, 4.0, 1.5, 5)])
def test_synthesize_power_law_is_array_identical(n, mu, alpha, seed,
                                                 random_values):
    ref = RS.synthesize_power_law(n=n, mu=mu, alpha=alpha, seed=seed,
                                  random_values=random_values)
    port = TS.synthesize_power_law(n=n, mu=mu, alpha=alpha, seed=seed,
                                   random_values=random_values, device="cpu")
    assert_csr_identical(ref, port)


def test_paper_suite_selects_like_reference():
    include = ["wang3", "memplus", "torso1"]
    ref = RS.paper_suite(scale=0.01, include=include, skip_ell_overflow=True)
    port = TS.paper_suite(scale=0.01, include=include, skip_ell_overflow=True, device="cpu")
    assert [n for n, _ in port] == [n for n, _ in ref] == ["memplus", "wang3"]
    for (_, r), (_, p) in zip(ref, port):
        assert_csr_identical(r, p)


def test_verify_suite_reports_like_reference():
    assert TS.verify_suite(scale=0.01) == RS.verify_suite(scale=0.01)
    assert TS.verify_suite(scale=0.02, rtol=0.001) == \
        RS.verify_suite(scale=0.02, rtol=0.001)


@pytest.mark.parametrize("name", ["wang3", "memplus", "xenon1"])
def test_memory_policy_matches_reference(name):
    rspec = next(s for s in RS.TABLE1 if s.name == name)
    tspec = next(s for s in TS.TABLE1 if s.name == name)
    ref, port = RS.synthesize(rspec, 0.02), TS.synthesize(tspec, 0.02, device="cpu")
    fmts = ("csr", "coo_row", "coo_col", "ell_row", "ell_col", "sell")
    for kw in ({}, {"budget_ratio": 1.2}, {"hard_bytes": 4096}):
        assert TP.MemoryPolicy(**kw).allowed(fmts, port) == \
            RP.MemoryPolicy(**kw).allowed(fmts, ref)
    st = TF.MatrixStats.of(port)
    for f in fmts:
        assert TP.MemoryPolicy().estimate_bytes(f, st) == \
            RP.MemoryPolicy().estimate_bytes(f, RF.MatrixStats.of(ref))
    with pytest.raises(KeyError):
        TP.MemoryPolicy().estimate_bytes("nope", st)


@pytest.mark.parametrize("order", TS.COO_ORDERS)
def test_coo_orders_are_what_they_claim(order):
    """Each adversarial COO order keeps the matrix's product (the entries'
    multiset, up to its remapping of rows) and has the shape it names."""
    rng = np.random.default_rng(5)
    rows = np.sort(rng.integers(0, 50, 1000)).astype(np.int32)
    cols = rng.integers(0, 40, 1000).astype(np.int32)
    data = rng.normal(size=1000).astype(np.float32)
    r, c, d, n_rows = TS.coo_entries(rows, cols, data, 50, order, seed=3)
    assert r.dtype == c.dtype == np.int32 and d.dtype == np.float32
    assert r.shape == c.shape == d.shape
    assert 0 <= r.min() and r.max() < n_rows
    x = rng.normal(size=40)
    y = np.zeros(n_rows)
    np.add.at(y, r, d * x[c])
    want = np.zeros(50)
    np.add.at(want, rows, data * x[cols])
    if order == "one_row":
        assert set(r) == {25}
        np.testing.assert_allclose(y[25], want.sum(), rtol=1e-5)
    elif order == "alternating":
        assert (r[1:] != r[:-1]).all()
    elif order == "empty_rows":
        assert n_rows == 151 and not y[::3].any() and not y[2::3].any()
        np.testing.assert_allclose(y[1::3], want, rtol=1e-5, atol=1e-6)
    elif order == "ragged":
        assert r.shape[0] % 2 == 1 and (r == rows[:r.shape[0]]).all()
    else:
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-6)
        if order == "descending":
            assert (np.diff(r) <= 0).all()
        if order == "pads_at_end":
            assert r.shape[0] == 1000 + 338 and not d[1000:].any()
            assert not r[1000:].any() and not c[1000:].any()
        if order == "random":
            assert (r != rows).any()
    with pytest.raises(ValueError):
        TS.coo_entries(rows, cols, data, 50, "sideways")
