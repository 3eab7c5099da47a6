"""On the card: each CUDA kernel of the port against its plain PyTorch version.

These tests need a CUDA device and ``nvcc`` (the kernels compile at first
use); without a card they skip.  The file imports neither JAX nor the JAX
package, so it runs on a machine that has only PyTorch::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels as TK
from repro_torch.core import dispatch as TD
from repro_torch.core import transform as TT
from repro_torch.kernels import ell_spmv as K1

FORMATS = ("csr", "coo_row", "coo_col", "ell_row", "ell_col", "sell")
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: float32 / bfloat16 tolerance: both sides accumulate in float32 from the
#: same inputs, only the order of the sum differs
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no interpret mode")
    return torch.device("cuda")


def heavy_tail_dense(rng):
    dense = np.zeros((128, 200), np.float32)
    dense[5, :] = rng.normal(size=200)
    dense[70, :150] = rng.normal(size=150)
    dense += (rng.random(dense.shape) < 0.01) * rng.normal(
        size=dense.shape).astype(np.float32)
    return dense.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_cuda_kernel_matches_plain_version(cuda, fmt, dtype):
    rng = np.random.default_rng(31)
    dense = heavy_tail_dense(rng)
    tm = TT.csr_from_dense(dense, pad=8, device="cpu")
    tm = dataclasses.replace(tm, data=tm.data.to(TDT[dtype]))
    tf = TT.TRANSFORMS_HOST[fmt](tm)
    x = torch.from_numpy(rng.normal(size=200).astype(np.float32)).to(
        TDT[dtype])
    before = sum(TK.launch_counts().values())
    got = TD.spmv(tf.to(cuda), x.to(cuda), tier="kernel")
    torch.cuda.synchronize()
    assert sum(TK.launch_counts().values()) > before
    want = TD.spmv(tf, x, tier="kernel")       # plain version, on the CPU
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), **TOL[dtype])


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_mixed_devices(cuda):
    data, cols = torch.ones(4, 3), torch.zeros(4, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        K1.ell_spmv(data.to(cuda), cols.to(cuda), torch.ones(5))


@pytest.mark.cuda
def test_cuda_wrapper_refuses_non_contiguous_x(cuda):
    data = torch.ones(4, 3, device=cuda)
    cols = torch.zeros(4, 3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        K1.ell_spmv(data, cols, torch.ones(10, device=cuda)[::2])


@pytest.mark.cuda
def test_cuda_wrappers_count_no_launch_for_empty_input(cuda):
    from repro_torch.kernels import coo_spmv as K3
    from repro_torch.kernels import csr_spmv as K2
    i32 = dict(dtype=torch.int32, device=cuda)
    x = torch.ones(5, device=cuda)
    before = TK.launch_counts()
    y = K3.coo_spmv(torch.ones(0, device=cuda), torch.zeros(0, **i32),
                    torch.zeros(0, **i32), x, 4)
    assert y.tolist() == [0.0] * 4
    assert K2.csr_spmv(torch.ones(8, device=cuda), torch.zeros(8, **i32),
                       torch.zeros(1, **i32), x).shape == (0,)
    assert K1.ell_spmv(torch.ones(0, 3, device=cuda),
                       torch.zeros(0, 3, **i32), x).shape == (0,)
    assert TK.launch_counts() == before
