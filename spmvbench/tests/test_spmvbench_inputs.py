"""The benchmark's inputs and its reference, on the CPU."""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT
from spmvbench import roofline
from spmvbench.generators import kronecker, stencil27
from spmvbench.reference import LowerPrecision, Reference

CPU = torch.device("cpu")


def dense(m):
    a = np.zeros(m.shape)
    rows = m.row_ids().numpy()
    a[rows, m.cols.numpy()] = m.vals.double().numpy()
    return a


@pytest.mark.parametrize("nx,ny,nz", [(3, 3, 3), (6, 5, 4), (9, 8, 7)])
def test_stencil_counts_and_rows(nx, ny, nz):
    m = stencil27.build({"nx": nx, "ny": ny, "nz": nz, "diagonal": 26.0,
                         "off_diagonal": -1.0}, 0, CPU)
    assert m.n_rows == nx * ny * nz
    assert m.nnz == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    lens = m.row_lengths().numpy()
    inner = (nx - 2) * (ny - 2) * (nz - 2)
    assert (lens == 27).sum() == inner
    assert (lens == 8).sum() == 8
    assert (lens == 18).sum() == 2 * ((nx - 2) * (ny - 2) + (nx - 2)
                                      * (nz - 2) + (ny - 2) * (nz - 2))
    assert (lens == 12).sum() == 4 * ((nx - 2) + (ny - 2) + (nz - 2))
    a = dense(m)
    assert np.array_equal(a, a.T)
    assert np.all(np.diag(a) == 26.0)
    assert np.all(np.diff(m.cols.numpy().astype(np.int64))[
        np.diff(m.row_ids().numpy()) == 0] > 0)      # ascending in a row
    assert np.linalg.eigvalsh(a).min() > 0           # SPD


def test_stencil_matches_hpcg_loop():
    nx, ny, nz = 4, 3, 5
    m = stencil27.build({"nx": nx, "ny": ny, "nz": nz, "diagonal": 26.0,
                         "off_diagonal": -1.0}, 0, CPU)
    cols = []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            if 0 <= iz + sz < nz and 0 <= iy + sy < ny \
                                    and 0 <= ix + sx < nx:
                                cols.append((iz + sz) * nx * ny
                                            + (iy + sy) * nx + ix + sx)
    assert m.cols.tolist() == cols


KRON = {"scale": 9, "edge_factor": 16, "A": 0.57, "B": 0.19, "C": 0.19,
        "graph_seed": 5}


def test_kronecker_symmetric_without_duplicates():
    m = kronecker.build(KRON, 0, CPU)
    rows, cols = m.row_ids().numpy(), m.cols.numpy()
    assert m.n_rows == 512
    keys = rows.astype(np.int64) * m.n_cols + cols
    assert np.all(np.diff(keys) > 0)                 # sorted, no duplicate
    assert not np.any(rows == cols)                  # no self-loop
    assert set(zip(rows, cols)) == set(zip(cols, rows))
    deg = np.bincount(rows, minlength=m.n_rows)
    np.testing.assert_allclose(m.vals.numpy(), 1.0 / deg[cols], rtol=1e-7)
    # a power law: the largest row far above the mean
    assert deg.max() > 8 * deg.mean()


def test_kronecker_graph_is_the_configurations():
    a = kronecker.build(KRON, 1, CPU)
    b = kronecker.build(KRON, 2, CPU)
    assert torch.equal(a.cols, b.cols) and torch.equal(a.indptr, b.indptr)
    c = kronecker.build(dict(KRON, graph_seed=6), 1, CPU)
    assert not torch.equal(a.indptr, c.indptr)


@pytest.mark.parametrize("rhs", [1, 3])
def test_reference_against_dense(rhs):
    m = kronecker.build(KRON, 0, CPU)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((m.n_cols,) if rhs == 1 else (m.n_cols, rhs),
                    generator=g)
    want = dense(m) @ x.double().numpy()
    got = Reference(m)(x)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(Reference(m).abs_product(x).numpy(),
                               np.abs(dense(m)) @ np.abs(x.double().numpy()),
                               rtol=1e-12, atol=1e-15)
    low = LowerPrecision(m)(x)
    assert low.dtype == x.dtype
    gap = float((low.double() - got).abs().max()
                / Reference(m).abs_product(x).max())
    assert 1e-4 < gap < 2e-2


def test_roofline_bytes_are_the_crs_form():
    m = stencil27.build({"nx": 5, "ny": 4, "nz": 3, "diagonal": 26.0,
                         "off_diagonal": -1.0}, 0, CPU)
    n, nnz = m.n_rows, m.nnz
    assert roofline.form_bytes(m) == nnz * 8 + (n + 1) * 4 + 2 * n * 4
    assert roofline.form_bytes(m, rhs=32) == (nnz * 8 + (n + 1) * 4
                                              + 32 * 2 * n * 4)
    assert roofline.share_pct(roofline.PEAK_BYTES_PER_S, 2.0) == 50.0
    assert roofline.share_pct(1.0, 0.0) is None


def test_roofline_bytes_same_for_every_form():
    from repro_torch.core import transform as T
    m = kronecker.build(KRON, 0, CPU)
    csr = m.to_program()
    forms = [csr, T.host_csr_to_ell(csr, order="row"),
             T.host_csr_to_ell(csr, order="col"), T.host_csr_to_sell(csr),
             T.host_csr_to_coo_row(csr)]
    counts = {roofline.form_bytes(f, rhs=r) for f in forms for r in (1,)}
    assert counts == {roofline.form_bytes(m)}
    assert len({roofline.form_bytes(f, rhs=32) for f in forms}) == 1


def test_no_module_of_jax_or_the_jax_package(tiny_root):
    """Every module of the benchmark, and a whole tiny run of each cell,
    load no module whose top-level name is ``jax``, ``jaxlib``, ``flax``
    or ``repro`` (``repro_torch`` is another name)."""
    code = f"""
import importlib, pkgutil, sys, time, torch
from pathlib import Path
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import spmvbench
for mod in pkgutil.walk_packages(spmvbench.__path__, 'spmvbench.'):
    if '.tests' not in mod.name:
        importlib.import_module(mod.name)
from spmvbench import harness
for w in ('hpcg256.cg50', 'kron23.pr20', 'hpcg128.rebind', 'kron23.serve32'):
    harness.run(Path({str(tiny_root)!r}), w, 3, 0.05, w.endswith('pr20'),
                torch.device('cpu'), time.perf_counter(), log=lambda s: None)
print(sorted({{k.split('.')[0] for k in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = eval(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in tops
    assert not {"jax", "jaxlib", "flax", "repro"} & set(tops)
