"""Port vs reference: the partitioned hybrid tier.

The same numpy inputs (made from a seed) go through ``repro.partition`` (JAX)
and ``repro_torch.partition`` (PyTorch, on the CPU here): the partition
strategies' boundaries are equal, sliced CSRs and whole hybrid containers
equal field by field, per-block decisions equal decision by decision, and
``spmv_hybrid`` / ``spmm_hybrid`` of both tiers agree with the JAX
package's (its kernel tier in interpret mode, as ``tests/test_partition.py``
runs it) and with a dense oracle within 1e-4 of ``sum |a x|``.  Mirrors the
non-service cases of ``tests/test_partition.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autotune as RA
from repro.core import formats as RF
from repro.core import spmv as r_spmv
from repro.core import suite as RS
from repro.core import transform as RT
from repro.core.policy import MemoryPolicy as RPolicy
from repro.kernels import ops as R_ops
from repro import partition as RP
from repro_torch import partition as TP
from repro_torch.core import autotune as TA
from repro_torch.core import dispatch as TD
from repro_torch.core import formats as TF
from repro_torch.core import suite as TS
from repro_torch.core import transform as TT
from repro_torch.core.policy import MemoryPolicy
from repro_torch.kernels import ops as T_ops

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REL_TOL = 1e-4
#: the four strategies of ``benchmarks/hybrid_blocks.py``'s sweep
SWEEP = (("fixed", {"block_rows": 256}), ("fixed", {"block_rows": 1024}),
         ("balanced_nnz", {"n_blocks": 8}),
         ("variance", {"max_blocks": 16, "min_rows": 64}))
SWEEP_IDS = ["fixed_256", "fixed_1024", "balanced_8", "variance_16"]


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def random_dense(rng, n_rows, n_cols, density):
    d = (rng.random((n_rows, n_cols)) < density).astype(np.float32)
    return d * rng.normal(1.0, 1.0, size=d.shape).astype(np.float32)


def both_csr(dense, dtype="float32"):
    rm = RT.csr_from_dense(dense, pad=8)
    tm = TT.csr_from_dense(dense, pad=8, device="cpu")
    if dtype != "float32":
        rm = dataclasses.replace(rm, data=jnp.asarray(rm.data, JDT[dtype]))
        tm = dataclasses.replace(tm, data=tm.data.to(TDT[dtype]))
    return rm, tm


def power_law(n=512, alpha=1.8, seed=3):
    return (RS.synthesize_power_law(n=n, alpha=alpha, seed=seed,
                                    random_values=True),
            TS.synthesize_power_law(n=n, alpha=alpha, seed=seed,
                                    random_values=True, device="cpu"))


def suite_pair(name, scale=0.02):
    rspec = next(s for s in RS.TABLE1 if s.name == name)
    tspec = next(s for s in TS.TABLE1 if s.name == name)
    return (RS.synthesize(rspec, scale=scale),
            TS.synthesize(tspec, scale=scale, device="cpu"))


def ref_parts(m):
    """(fmt_name, arrays, meta) of a reference container, in the nested
    shape ``repro_torch.core.formats.to_numpy`` gives."""
    if isinstance(m, RP.HybridMatrix):
        parts = [ref_parts(b) for b in m.blocks]
        return ("hybrid",
                {"perm": np.asarray(m.perm),
                 "blocks": [a for _, a, _ in parts]},
                {"shape": m.shape, "nnz": m.nnz,
                 "row_offsets": m.row_offsets, "formats": m.formats,
                 "identity_perm": m.identity_perm,
                 "blocks": [mm for _, _, mm in parts]})
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


def assert_tree_equal(got, want, where="root"):
    """Nested (dict / list / array / scalar) equality; arrays bit for bit
    with equal dtypes (bfloat16 compared as float32 values)."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            assert_tree_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        if want.dtype.name == "bfloat16":
            want = want.astype(np.float32)
        assert got.shape == want.shape and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, (where, got, want)


def assert_same(ref_m, port_m):
    assert_tree_equal(TF.to_numpy(port_m), ref_parts(ref_m))


def oracle(dense, x):
    """float64 product and sum |a x| per output element."""
    d = dense.astype(np.float64)
    xx = x.astype(np.float64)
    return d @ xx, np.abs(d) @ np.abs(xx)


def assert_close_rel(got, dense, x, tol=REL_TOL):
    want, scale = oracle(dense, x)
    err = np.abs(f32(got).astype(np.float64) - want) / (scale + 1e-30)
    assert float(err.max()) <= tol, float(err.max())


# ---------------------------------------------------------------------------
# partitioning strategies: the same boundaries as the reference
# ---------------------------------------------------------------------------
def _check_boundaries(b, n):
    assert b[0] == 0 and b[-1] == n
    assert np.all(np.diff(b) > 0)


@pytest.mark.parametrize("name", sorted(TP.PARTITIONERS))
def test_strategy_boundaries_valid(name):
    rng = np.random.default_rng(11)
    assert sorted(TP.PARTITIONERS) == sorted(RP.PARTITIONERS)
    for n in (1, 7, 64, 1000):
        lens = rng.integers(1, 50, size=n)
        got = TP.PARTITIONERS[name](lens)
        _check_boundaries(got, n)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, RP.PARTITIONERS[name](lens))


STRATEGY_KW = [("fixed", {"block_rows": 1}), ("fixed", {"block_rows": 33}),
               ("fixed", {"block_rows": 10 ** 6}),
               ("balanced_nnz", {"n_blocks": 1}),
               ("balanced_nnz", {"n_blocks": 5}),
               ("balanced_nnz", {"n_blocks": 10 ** 4}),
               ("variance", {"max_blocks": 2, "min_rows": 1}),
               ("variance", {"max_blocks": 16, "min_rows": 64}),
               ("variance", {"max_blocks": 8, "min_rows": 10,
                             "min_gain": 1e9})]


@pytest.mark.parametrize("lens_kind", ["skewed", "all_zero", "sorted"])
@pytest.mark.parametrize("strategy,kw", STRATEGY_KW,
                         ids=[f"{s}-{'-'.join(map(str, k.values()))}"
                              for s, k in STRATEGY_KW])
def test_strategy_kwargs_give_the_reference_boundaries(strategy, kw,
                                                       lens_kind):
    rng = np.random.default_rng(5)
    lens = np.minimum(rng.pareto(1.3, size=700) * 4, 600).astype(np.int64)
    if lens_kind == "all_zero":
        lens[:] = 0
    elif lens_kind == "sorted":
        lens = -np.sort(-lens)
    np.testing.assert_array_equal(TP.PARTITIONERS[strategy](lens, **kw),
                                  RP.PARTITIONERS[strategy](lens, **kw))


def test_fixed_blocks():
    b = TP.partition_fixed(np.ones(100), block_rows=32)
    np.testing.assert_array_equal(b, [0, 32, 64, 96, 100])


def test_balanced_nnz_equalizes_work():
    lens = np.full(1000, 5, dtype=np.int64)
    lens[500] = 5000
    b = TP.partition_balanced_nnz(lens, n_blocks=4)
    np.testing.assert_array_equal(b, RP.partition_balanced_nnz(lens,
                                                               n_blocks=4))
    per_block = [lens[s:e].sum() for s, e in zip(b[:-1], b[1:])]
    assert len(b) >= 3
    assert max(per_block) <= 0.75 * lens.sum()


def test_variance_split_isolates_tail():
    lens = np.concatenate([np.full(100, 500),
                           np.full(900, 5)]).astype(np.int64)
    b = TP.partition_variance(lens, max_blocks=8, min_rows=50)
    _check_boundaries(b, 1000)
    np.testing.assert_array_equal(
        b, RP.partition_variance(lens, max_blocks=8, min_rows=50))
    assert any(abs(int(c) - 100) <= 50 for c in b[1:-1])
    sse = sum(float(np.var(lens[s:e]) * (e - s))
              for s, e in zip(b[:-1], b[1:]))
    assert sse < 0.1 * float(np.var(lens) * 1000)
    with pytest.raises(ValueError):
        TP.partition_variance(np.zeros(0, np.int64))
    with pytest.raises(ValueError):
        TP.partition_fixed(np.ones((2, 2)))


@pytest.mark.parametrize("strategy", ["fixed", "balanced_nnz", "variance"])
@pytest.mark.parametrize("n_devices", [1, 3, 8])
def test_partition_for_devices_matches_reference(strategy, n_devices):
    rng = np.random.default_rng(n_devices)
    lens = np.minimum(rng.pareto(1.5, size=300) * 3, 200).astype(np.int64)
    got = TP.partition_for_devices(lens, n_devices, strategy=strategy)
    assert got.shape[0] == n_devices + 1
    np.testing.assert_array_equal(
        got, RP.partition_for_devices(lens, n_devices, strategy=strategy))


def test_partition_for_devices_refuses_like_reference():
    for kw in ({"n_devices": 0}, {"n_devices": 11},
               {"n_devices": 2, "strategy": "nope"}):
        for mod in (TP, RP):
            with pytest.raises((ValueError, KeyError)):
                mod.partition_for_devices(np.ones(10, np.int64), **kw)


# ---------------------------------------------------------------------------
# CSR slicing: field by field
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice_and_take_rows(dtype):
    rng = np.random.default_rng(11)
    dense = random_dense(rng, 60, 40, 0.2)
    dense[4] = 0.0                                 # an empty row
    rm, tm = both_csr(dense, dtype)
    sub = TP.slice_csr(tm, 10, 35)
    assert_same(RP.slice_csr(rm, 10, 35), sub)
    np.testing.assert_allclose(sub.todense(), f32(rm.todense())[10:35])
    for rows in (np.array([3, 1, 59, 17, 4]), np.array([4]),
                 np.zeros(0, np.int64), np.arange(60)[::-1]):
        sub2 = TP.take_rows_csr(tm, rows)
        assert_same(RP.take_rows_csr(rm, rows), sub2)
        assert sub2.data.dtype == TDT[dtype]
    assert_same(RP.slice_csr(rm, 4, 5), TP.slice_csr(tm, 4, 5))
    for c0, c1 in ((0, 40), (5, 17), (39, 40), (20, 20)):
        assert_same(RP.slice_csr_cols(rm, c0, c1),
                    TP.slice_csr_cols(tm, c0, c1))


def test_container_moves_with_its_int64_perm_index():
    rm, tm = power_law(n=256)
    hyb, _ = TP.build_hybrid(tm, strategy="variance", max_blocks=4,
                             min_rows=32)
    assert hyb.device.type == "cpu" and hyb.perm.dtype == torch.int32
    assert hyb.perm_index.dtype == torch.int64
    moved = hyb.to("meta")
    assert moved.perm_index.device.type == "meta"
    assert all(b.device.type == "meta" for b in moved.blocks)
    assert moved.formats == hyb.formats


# ---------------------------------------------------------------------------
# build: the same containers and decisions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mname", ["memplus", "chem_master1", "torso1",
                                   "power_law"])
@pytest.mark.parametrize("strategy,kw", SWEEP, ids=SWEEP_IDS)
def test_build_hybrid_equals_reference(mname, strategy, kw):
    rm, tm = power_law(n=2048) if mname == "power_law" else \
        suite_pair(mname)
    rh, rrep = RP.build_hybrid(rm, strategy=strategy, **kw)
    th, trep = TP.build_hybrid(tm, strategy=strategy, **kw)
    assert_same(rh, th)
    assert th.formats == rh.formats and th.n_blocks == rh.n_blocks
    assert th.format_counts() == rh.format_counts() == \
        trep.format_counts() == rrep.format_counts()
    assert (trep.strategy, trep.n_blocks) == (rrep.strategy, rrep.n_blocks)
    for td, rd in zip(trep.decisions, rrep.decisions):
        assert (td.fmt, td.rows, td.nnz, td.bytes) == \
            (rd.fmt, rd.rows, rd.nnz, rd.bytes)
        assert td.d_mat == rd.d_mat or (np.isnan(td.d_mat)
                                        and np.isnan(rd.d_mat)) or \
            (np.isinf(td.d_mat) and np.isinf(rd.d_mat))
        assert td.plan.to_dict() == rd.plan.to_dict()
    assert TF.memory_bytes(th) == RF.memory_bytes(rh)
    assert th.validate() is th
    for i in range(th.n_blocks):
        assert th.block_rows(i) == rh.block_rows(i)


@pytest.mark.parametrize("strategy,kw",
                         [("fixed", {"block_rows": 64}),
                          ("balanced_nnz", {"n_blocks": 4}),
                          ("variance", {"max_blocks": 6, "min_rows": 16})],
                         ids=["fixed", "balanced_nnz", "variance"])
def test_hybrid_spmv_matches_dense(strategy, kw):
    rng = np.random.default_rng(11)
    dense = random_dense(rng, 300, 200, 0.08)
    rm, tm = both_csr(dense)
    hyb, rep = TP.build_hybrid(tm, strategy=strategy, **kw)
    assert rep.n_blocks == hyb.n_blocks == len(hyb.formats)
    np.testing.assert_allclose(hyb.todense(), dense, rtol=1e-5, atol=1e-6)
    x = rng.normal(size=200).astype(np.float32)
    y = TD.spmv(hyb, torch.from_numpy(x))
    assert_close_rel(y, dense, x)
    X = rng.normal(size=(200, 5)).astype(np.float32)
    assert_close_rel(TP.spmm_hybrid(hyb, torch.from_numpy(X)), dense, X)
    rh, _ = RP.build_hybrid(rm, strategy=strategy, **kw)
    np.testing.assert_allclose(f32(y), f32(r_spmv(rh, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mname", ["memplus", "chem_master1", "torso1",
                                   "epb2"])
def test_hybrid_matches_csr_on_suite(mname):
    rng = np.random.default_rng(11)
    rm, tm = suite_pair(mname)
    hyb, _ = TP.build_hybrid(tm, strategy="variance", max_blocks=8,
                             min_rows=32)
    x = rng.normal(size=tm.n_cols).astype(np.float32)
    want = f32(TD.spmv(tm, torch.from_numpy(x)))
    got = f32(TP.spmv_hybrid(hyb, torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 *
                               max(1.0, float(np.abs(want).max())))
    rh, _ = RP.build_hybrid(rm, strategy="variance", max_blocks=8,
                            min_rows=32)
    np.testing.assert_allclose(got, f32(RP.spmv_hybrid(rh, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5 *
                               max(1.0, float(np.abs(want).max())))


def test_hybrid_kernel_path_matches():
    rng = np.random.default_rng(11)
    rm, tm = power_law(n=512)
    hyb, _ = TP.build_hybrid(tm, strategy="variance", max_blocks=6,
                             min_rows=32)
    rh, _ = RP.build_hybrid(rm, strategy="variance", max_blocks=6,
                            min_rows=32)
    x = rng.normal(size=tm.n_cols).astype(np.float32)
    want = f32(TD.spmv(tm, torch.from_numpy(x)))
    got = f32(T_ops.spmv_hybrid(hyb, torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4 *
                               max(1.0, float(np.abs(want).max())))
    ref = f32(R_ops.spmv_hybrid(rh, jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4 *
                               max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def mixed():
    """A 384-row power-law matrix whose variance partition mixes SELL and
    ELL blocks (and a CSR one for its heaviest rows), in both packages."""
    rm, tm = power_law(n=384, alpha=1.5, seed=3)
    kw = dict(strategy="variance", max_blocks=5, min_rows=48)
    rh, _ = RP.build_hybrid(rm, **kw)
    th, _ = TP.build_hybrid(tm, **kw)
    assert th.formats == rh.formats
    assert {"sell", "ell_row"} <= set(th.formats), th.formats
    return rm, tm, rh, th, kw


@pytest.mark.parametrize("tier", ["reference", "kernel"])
@pytest.mark.parametrize("batch", [1, 3, 128])
def test_hybrid_products_match_the_jax_kernel_and_a_dense_oracle(mixed,
                                                                 batch,
                                                                 tier):
    rm, tm, rh, th, _ = mixed
    dense = f32(rm.todense())
    rng = np.random.default_rng(batch)
    x = (rng.normal(size=tm.n_cols) if batch == 1 else
         rng.normal(size=(tm.n_cols, batch))).astype(np.float32)
    op = "spmv" if batch == 1 else "spmm"
    got = TD.dispatch(th, torch.from_numpy(x), op=op, tier=tier)
    assert got.dtype == torch.float32 and got.shape == (tm.n_rows,) + \
        x.shape[1:]
    assert_close_rel(got, dense, x)
    jfn = R_ops.spmv_hybrid if batch == 1 else R_ops.spmm_hybrid
    want = f32(jfn(rh, jnp.asarray(x), interpret=True))
    _, scale = oracle(dense, x)
    err = np.abs(f32(got) - want) / (scale + 1e-30)
    assert float(err.max()) <= REL_TOL


@pytest.mark.parametrize("op", ["spmv", "spmm"])
@pytest.mark.parametrize("dd,xd", [("bfloat16", "float32"),
                                   ("float32", "bfloat16"),
                                   ("bfloat16", "bfloat16")])
def test_mixed_block_dtypes_reassemble_to_the_reference_dtype(mixed, dd, xd,
                                                              op):
    """SELL blocks give ``x``'s dtype, ELL and CSR blocks the promoted
    one; the reassembled output takes the reference's concatenated dtype."""
    rm, tm, _, _, kw = mixed
    rm = dataclasses.replace(rm, data=jnp.asarray(rm.data, JDT[dd]))
    tm = dataclasses.replace(tm, data=tm.data.to(TDT[dd]))
    rh, _ = RP.build_hybrid(rm, **kw)
    th, _ = TP.build_hybrid(tm, **kw)
    assert_same(rh, th)
    rng = np.random.default_rng(2)
    x = (rng.normal(size=tm.n_cols) if op == "spmv" else
         rng.normal(size=(tm.n_cols, 3))).astype(np.float32)
    want = (RP.spmv_hybrid if op == "spmv" else RP.spmm_hybrid)(
        rh, jnp.asarray(x, JDT[xd]))
    for tier in ("reference", "kernel"):
        got = TD.dispatch(th, torch.from_numpy(x).to(TDT[xd]), op=op,
                          tier=tier)
        assert str(got.dtype).replace("torch.", "") == want.dtype.name
        np.testing.assert_allclose(f32(got), f32(want), rtol=5e-2,
                                   atol=5e-2)


@pytest.mark.parametrize("xd", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy,kw", [("fixed", {"block_rows": 8}),
                                         ("variance", {"min_rows": 4})])
def test_all_zero_matrix_gives_typed_zeros(strategy, kw, xd):
    dense = np.zeros((20, 9), np.float32)
    rm, tm = both_csr(dense)
    rh, _ = RP.build_hybrid(rm, strategy=strategy, **kw)
    th, _ = TP.build_hybrid(tm, strategy=strategy, **kw)
    assert_same(rh, th)
    for op, shape in (("spmv", (9,)), ("spmm", (9, 4))):
        x = torch.ones(shape, dtype=TDT[xd])
        want = (RP.spmv_hybrid if op == "spmv" else RP.spmm_hybrid)(
            rh, jnp.ones(shape, JDT[xd]))
        for tier in ("reference", "kernel"):
            got = TD.dispatch(th, x, op=op, tier=tier)
            assert got.shape == (20,) + shape[1:]
            assert str(got.dtype).replace("torch.", "") == want.dtype.name
            assert not bool(got.any())


def test_skewed_matrix_gets_multiple_formats():
    rm, tm = power_law(n=2048, seed=0)
    hyb, rep = TP.build_hybrid(tm, strategy="variance", max_blocks=16,
                               min_rows=64)
    assert len(set(hyb.formats)) >= 2, rep.format_counts()
    assert TF.memory_bytes(hyb) <= MemoryPolicy().budget_ratio * \
        TF.memory_bytes(tm) * 1.1
    assert rep.t_transform > 0 and all(d.t_transform >= 0
                                       for d in rep.decisions)
    assert sum(d.nnz for d in rep.decisions) == tm.nnz
    assert rep.t_partition >= 0


def test_memory_policy_filters_block_candidates():
    skewed = TF.MatrixStats(n=1000, nnz=6000, mu=6.0, sigma=80.0,
                            d_mat=13.3, max_row=900, min_row=1)
    uniform = TF.MatrixStats(n=1000, nnz=6000, mu=6.0, sigma=0.1,
                             d_mat=0.017, max_row=7, min_row=5)
    for stats, policy, check in (
            (skewed, dict(budget_ratio=2.0),
             lambda f: f not in ("ell_row", "ell_col")),
            (uniform, dict(budget_ratio=2.0),
             lambda f: f in ("ell_row", "ell_col", "sell")),
            (uniform, dict(budget_ratio=2.0, hard_bytes=1),
             lambda f: f == "csr")):
        got = TP.choose_block_format(stats, policy=MemoryPolicy(**policy))
        rstats = RF.MatrixStats(**dataclasses.asdict(stats))
        assert got == RP.choose_block_format(rstats,
                                             policy=RPolicy(**policy))
        assert check(got), got


def _tiny_dbs():
    """The same small TuningDB in both packages (made by hand)."""
    recs = []
    for i, d in enumerate((0.05, 0.3, 1.5, 6.0)):
        fm = {f: dict(t_spmv=1e-5 * (1 + i * k), t_trans=1e-4 * (k + 1),
                      sp=2.0 / (1 + i * k), tt=3.0 * (k + 1),
                      r=(2.0 / (1 + i * k)) / (3.0 * (k + 1)),
                      mem_ratio=1.0 + 0.2 * k)
              for k, f in enumerate(TP.BLOCK_FORMATS)}
        recs.append(dict(name=f"m{i}", n=100, nnz=900, mu=9.0, sigma=9 * d,
                         d_mat=d, t_crs=1e-5, batch=1, formats=fm))
    import json
    text = json.dumps({"machine": "tiny", "c": 0.5,
                       "d_star": {"ell_row": 0.3, "sell": 1.5},
                       "records": recs, "geometries": []})
    return RA.TuningDB.from_json(text), TA.TuningDB.from_json(text)


@pytest.mark.parametrize("rule", ["paper", "auto", "cost_model"])
@pytest.mark.parametrize("d_mat", [0.01, 0.5, 4.0])
def test_choose_block_format_rules_match_reference(rule, d_mat):
    rdb, tdb = _tiny_dbs()
    kw = dict(n=500, nnz=4500, mu=9.0, sigma=9.0 * d_mat, d_mat=d_mat,
              max_row=int(9 + 27 * d_mat), min_row=1)
    for k, b in ((1, 1), (100, 1), (10 ** 6, 8)):
        args = dict(rule=rule, expected_iterations=k, batch=b)
        if rule == "cost_model":
            got = TP.choose_block_format(TF.MatrixStats(**kw), **args)
            want = RP.choose_block_format(RF.MatrixStats(**kw), **args)
        else:
            got = TP.choose_block_format(TF.MatrixStats(**kw), db=tdb,
                                         **args)
            want = RP.choose_block_format(RF.MatrixStats(**kw), db=rdb,
                                          **args)
        assert got == want


def test_build_hybrid_with_a_db_matches_reference():
    rdb, tdb = _tiny_dbs()
    rm, tm = suite_pair("torso1")
    for rule in ("paper", "auto"):
        rh, rrep = RP.build_hybrid(rm, db=rdb, rule=rule, max_blocks=6,
                                   min_rows=32)
        th, trep = TP.build_hybrid(tm, db=tdb, rule=rule, max_blocks=6,
                                   min_rows=32)
        assert_same(rh, th)
        assert [d.plan.to_dict() for d in trep.decisions] == \
            [d.plan.to_dict() for d in rrep.decisions]
    with pytest.raises(KeyError):
        TP.build_hybrid(tm, strategy="nope")


# ---------------------------------------------------------------------------
# first-class format integration
# ---------------------------------------------------------------------------
def test_hybrid_registered_everywhere():
    assert "hybrid" in TF.FORMAT_NAMES
    assert "hybrid" in TT.TRANSFORMS_HOST
    assert "hybrid" in T_ops.KERNEL_SPMV_IMPLS
    assert "hybrid" in T_ops.KERNEL_SPMM_IMPLS
    assert TD.resolve_impl("hybrid", "spmv")[0] is TP.spmv_hybrid
    assert TD.resolve_impl("hybrid", "spmm", tier="kernel")[0] is \
        T_ops.spmm_hybrid
    assert TP.BLOCK_FORMATS == RP.BLOCK_FORMATS
    assert TP.__all__ == RP.__all__
    assert TA.DEFAULT_FORMATS == RA.DEFAULT_FORMATS
    assert MemoryPolicy().estimate_bytes(
        "hybrid", TF.MatrixStats(n=10, nnz=50, mu=5, sigma=1, d_mat=0.2,
                                 max_row=7, min_row=3)) > 0


def test_offline_phase_measures_hybrid():
    rng = np.random.default_rng(11)
    dense = random_dense(rng, 128, 128, 0.1)
    rm, tm = both_csr(dense)
    for impls in ({}, {"spmv_impls": T_ops.KERNEL_SPMV_IMPLS}):
        db = TA.offline_phase([("rand", tm)], formats=("hybrid", "ell_row"),
                              iters=1, machine="test", device="cpu",
                              **impls)
        meas = db.records[0].formats["hybrid"]
        assert meas.t_spmv > 0 and meas.t_trans > 0
        assert np.isfinite(meas.r)
        assert "hybrid" in db.d_star
    ref = RA.offline_phase([("rand", rm)], formats=("hybrid", "ell_row"),
                           iters=1, machine="test")
    assert set(db.d_star) == set(ref.d_star)
    assert set(db.records[0].formats) == set(ref.records[0].formats)
    assert db.records[0].formats["hybrid"].mem_ratio == \
        ref.records[0].formats["hybrid"].mem_ratio
    assert set(dataclasses.asdict(db.records[0])) == \
        set(dataclasses.asdict(ref.records[0]))


def test_offline_phase_times_each_blocks_set_up(monkeypatch):
    """With the kernel impls, ``prepare`` of every block of the hybrid
    container is inside its ``t_trans``."""
    seen = []
    real = T_ops.prepare

    def spy(m):
        seen.append(type(m).__name__)
        return real(m)
    monkeypatch.setattr(T_ops, "prepare", spy)
    rm, tm = power_law(n=384, alpha=1.5)
    TA.offline_phase([("pl", tm)], formats=("hybrid",), iters=1,
                     spmv_impls=T_ops.KERNEL_SPMV_IMPLS, device="cpu")
    assert "HybridMatrix" in seen
    i = seen.index("HybridMatrix")
    assert {"ELL", "BucketedELL"} <= set(seen[i + 1:])


def test_host_csr_to_hybrid_via_transforms():
    rng = np.random.default_rng(11)
    dense = random_dense(rng, 100, 80, 0.1)
    rm, tm = both_csr(dense)
    hyb = TT.TRANSFORMS_HOST["hybrid"](tm)
    np.testing.assert_allclose(hyb.todense(), dense, rtol=1e-5, atol=1e-6)
    assert TP.host_csr_to_hybrid(tm).shape == tm.shape
    assert_same(RT.TRANSFORMS_HOST["hybrid"](rm), hyb)


def test_to_numpy_and_from_numpy_carry_a_hybrid_container():
    rm, tm = power_law(n=384, alpha=1.5)
    rh, _ = RP.build_hybrid(rm, max_blocks=5, min_rows=48)
    name, arrays, meta = ref_parts(rh)
    th = TF.from_numpy(name, arrays, meta, device="cpu")
    assert isinstance(th, TP.HybridMatrix) and th.validate() is th
    assert_same(rh, th)
    again = TF.from_numpy(*TF.to_numpy(th), device="cpu")
    assert_same(rh, again)
    x = np.random.default_rng(0).normal(size=384).astype(np.float32)
    np.testing.assert_allclose(f32(TP.spmv_hybrid(th, torch.from_numpy(x))),
                               f32(RP.spmv_hybrid(rh, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


CORRUPTIONS = ["perm_repeat", "perm_shape", "identity_flag", "gap",
               "format_name", "nested", "columns", "nnz", "no_blocks",
               "block_inside"]


@pytest.mark.parametrize("kind", CORRUPTIONS)
def test_validate_rejects_a_broken_container(kind):
    _, tm = power_law(n=384, alpha=1.5)
    h, _ = TP.build_hybrid(tm, max_blocks=5, min_rows=48)
    perm = h.perm.clone()
    if kind == "perm_repeat":
        perm[1] = perm[0]
        bad = dataclasses.replace(h, perm=perm)
    elif kind == "perm_shape":
        bad = dataclasses.replace(h, perm=perm[:-1])
    elif kind == "identity_flag":
        bad = dataclasses.replace(h, identity_perm=True)
    elif kind == "gap":
        bad = dataclasses.replace(h, row_offsets=(0,) + tuple(
            o + 1 for o in h.row_offsets[1:]))
    elif kind == "format_name":
        f = list(h.formats)
        f[0] = "coo_col" if f[0] != "coo_col" else "csr"
        bad = dataclasses.replace(h, formats=tuple(f))
    elif kind == "nested":
        bad = dataclasses.replace(h, blocks=(h,) + h.blocks[1:],
                                  formats=("hybrid",) + h.formats[1:])
    elif kind == "columns":
        b0 = h.blocks[-1]
        blk = dataclasses.replace(b0, shape=(b0.shape[0], b0.shape[1] + 1))
        bad = dataclasses.replace(h, blocks=h.blocks[:-1] + (blk,))
    elif kind == "nnz":
        bad = dataclasses.replace(h, nnz=h.nnz + 1)
    elif kind == "no_blocks":
        bad = dataclasses.replace(h, blocks=(), formats=(), row_offsets=())
    else:
        # an out-of-range column inside a block (a SELL block: its first
        # bucket) is caught by the block's own validate
        b0 = h.blocks[0]
        inner = b0.buckets[0] if hasattr(b0, "buckets") else b0
        c = inner.cols.clone()
        c.view(-1)[0] = 10 ** 6
        inner = dataclasses.replace(inner, cols=c)
        blk = (dataclasses.replace(b0, buckets=(inner,) + b0.buckets[1:])
               if hasattr(b0, "buckets") else inner)
        bad = dataclasses.replace(h, blocks=(blk,) + h.blocks[1:])
    with pytest.raises(TF.MatrixValidationError):
        TF.validate_container(bad)
