"""On the card: each CUDA kernel of the port (SpMV and SpMM) against its plain
PyTorch version.

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
from repro_torch.core.kernel_tune import (GPU_K_TILES, GPU_NNZ_TILES,
                                          TileGeometry)
from repro_torch.core.suite import COO_ORDERS, coo_entries
from repro_torch.kernels import ell_spmv as K1

FORMATS = ("csr", "coo_row", "coo_col", "ell_row", "ell_col", "sell", "ccs",
           "bcsr")
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


#: the SpMM kernel each format launches
SPMM_KERNEL = {"csr": "csr_spmm", "coo_row": "coo_spmm", "coo_col": "coo_spmm",
               "ell_row": "ell_spmm", "ell_col": "ell_spmm",
               "sell": "ell_spmm", "ccs": "ccs_spmm", "bcsr": "bcsr_spmm"}


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 32, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_cuda_spmm_kernel_matches_plain_version(cuda, fmt, dtype, batch):
    rng = np.random.default_rng(32)
    dense = heavy_tail_dense(rng)
    tm = TT.csr_from_dense(dense, pad=8, device="cpu")
    tm = dataclasses.replace(tm, data=tm.data.to(TDT[dtype]))
    tf = TT.TRANSFORMS_HOST[fmt](tm)
    X = torch.from_numpy(rng.normal(size=(200, batch)).astype(
        np.float32)).to(TDT[dtype])
    before = TK.launch_counts()[SPMM_KERNEL[fmt]]
    got = TD.spmm(tf.to(cuda), X.to(cuda), tier="kernel")
    torch.cuda.synchronize()
    assert TK.launch_counts()[SPMM_KERNEL[fmt]] > before
    want = TD.spmm(tf, X, tier="kernel")       # plain version, on the CPU
    assert got.shape == want.shape == (128, batch)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["csr", "coo_row", "ell_row", "ell_col",
                                 "ccs", "bcsr"])
@pytest.mark.parametrize("g", [dict(block_rows=1, block_k=1),
                               dict(block_rows=64, block_k=40),
                               dict(block_nnz=100, block_k=8),
                               dict(block_rows=16, block_nnz=256,
                                    block_k=32),
                               dict(block_rows=1024, block_nnz=16384,
                                    block_k=128)],
                         ids=["r1-k1", "r64-k40", "nnz100-k8", "r16-k32",
                              "big"])
def test_cuda_spmm_launch_geometry_sweep(cuda, fmt, g):
    rng = np.random.default_rng(33)
    dense = heavy_tail_dense(rng)
    tf = TT.TRANSFORMS_HOST[fmt](TT.csr_from_dense(dense, pad=8,
                                                   device="cpu"))
    X = torch.from_numpy(rng.normal(size=(200, 130)).astype(np.float32))
    got = TD.spmm(tf.to(cuda), X.to(cuda), tier="kernel",
                  tuning=TileGeometry(**g))
    np.testing.assert_allclose(got.cpu().numpy(), dense @ X.numpy(),
                               **TOL["float32"])


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("g", [dict(block_rows=1, block_nnz=32),
                               dict(block_rows=5, block_nnz=100),
                               dict(block_rows=1024, block_nnz=16384)],
                         ids=["r1", "r5", "big"])
def test_cuda_spmv_launch_geometry_sweep(cuda, fmt, g):
    rng = np.random.default_rng(34)
    dense = heavy_tail_dense(rng)
    tf = TT.TRANSFORMS_HOST[fmt](TT.csr_from_dense(dense, pad=8,
                                                   device="cpu"))
    x = torch.from_numpy(rng.normal(size=200).astype(np.float32))
    got = TD.spmv(tf.to(cuda), x.to(cuda), tier="kernel",
                  tuning=TileGeometry(**g))
    np.testing.assert_allclose(got.cpu().numpy(), dense @ x.numpy(),
                               **TOL["float32"])


@pytest.mark.cuda
def test_cuda_device_timer_times_the_card_not_the_host(cuda):
    """The call sleeps 2 ms on the host before it enqueues a tiny launch:
    a timer whose head start the host outlasts would report >= 2 ms."""
    import time

    from repro_torch.core.autotune import time_device
    y = torch.zeros(1024, device=cuda)

    def thunk():
        time.sleep(0.002)
        y.add_(1.0)

    thunk()
    torch.cuda.synchronize()
    assert time_device(thunk) < 0.5e-3


@pytest.mark.cuda
def test_cuda_spmm_wrappers_count_no_launch_for_empty_input(cuda):
    from repro_torch.kernels import coo_spmv as K3
    from repro_torch.kernels import csr_spmv as K2
    i32 = dict(dtype=torch.int32, device=cuda)
    X = torch.ones(5, 3, device=cuda)
    before = TK.launch_counts()
    assert not K3.coo_spmm(torch.ones(0, device=cuda), torch.zeros(0, **i32),
                           torch.zeros(0, **i32), X, 4).any()
    assert K2.csr_spmm(torch.ones(8, device=cuda), torch.zeros(8, **i32),
                       torch.zeros(1, **i32), X).shape == (0, 3)
    assert K1.ell_spmm(torch.ones(0, 3, device=cuda),
                       torch.zeros(0, 3, **i32), X).shape == (0, 3)
    assert K1.ell_spmm(torch.ones(4, 3, device=cuda),
                       torch.zeros(4, 3, **i32),
                       torch.ones(5, 0, device=cuda)).shape == (4, 0)
    assert TK.launch_counts() == before


#: a kernel against its plain version, relative to sum_k |data_k * x_k| of
#: the output element (``chip_smoke.KERNEL_REL_TOL``): both read the same
#: float32 or bfloat16 values and accumulate in float32, only the order of
#: the sum differs — and an element with no entry must stay exactly 0
KERNEL_REL_TOL = 1e-4


def coo_case(order, seed, dtype, batch=None):
    """Row-sorted COO entries, ~29 a row over 700 rows (so one row crosses
    every block of every tile), rearranged in ``order``; CPU tensors
    ``(data, rows, cols, x, n_rows)``, values in ``dtype``."""
    rng = np.random.default_rng(seed)
    n_rows, nnz, n_cols = 700, 20011, 500
    rows, cols, data, n_rows = coo_entries(
        np.sort(rng.integers(0, n_rows, nnz)).astype(np.int32),
        rng.integers(0, n_cols, nnz).astype(np.int32),
        rng.normal(size=nnz).astype(np.float32), n_rows, order, seed=seed)
    shape = (n_cols,) if batch is None else (n_cols, batch)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return (torch.from_numpy(data).to(TDT[dtype]), torch.from_numpy(rows),
            torch.from_numpy(cols), x.to(TDT[dtype]), n_rows)


def assert_kernel_close(got, want, mag):
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got.cpu().double() - want.double()).abs()
    assert bool((err <= KERNEL_REL_TOL * mag.double()).all()), \
        float((err / (mag.double() + 1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block_nnz", (None,) + GPU_NNZ_TILES)
@pytest.mark.parametrize("order", COO_ORDERS)
def test_cuda_coo_spmv_reduces_row_runs_in_any_order(cuda, order, block_nnz,
                                                     dtype):
    """K3's in-warp reduction of runs of equal rows, on orders built to
    break it, at the default launch and each tile of the tuner's grid."""
    from repro_torch.kernels import coo_spmv as K3
    data, rows, cols, x, n_rows = coo_case(order, 51, dtype)
    before = K3.coo_spmv.launches
    got = K3.coo_spmv(data.to(cuda), rows.to(cuda), cols.to(cuda),
                      x.to(cuda), n_rows, block_nnz=block_nnz)
    torch.cuda.synchronize()
    assert K3.coo_spmv.launches == before + 1
    assert_kernel_close(got, K3.coo_spmv_plain(data, rows, cols, x, n_rows),
                        K3.coo_spmv_plain(data.abs(), rows, cols, x.abs(),
                                          n_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3, 8, 32, 128])
@pytest.mark.parametrize("order", COO_ORDERS)
def test_cuda_coo_spmm_flushes_row_runs_in_any_order(cuda, order, batch,
                                                     dtype):
    """K6's register-held row tile, flushed once per run, on orders built
    to break it, at every column tile and entries-per-block tile of the
    tuner's grid."""
    from repro_torch.kernels import coo_spmv as K3
    data, rows, cols, x, n_rows = coo_case(order, 52, dtype, batch)
    want = K3.coo_spmm_plain(data, rows, cols, x, n_rows)
    mag = K3.coo_spmm_plain(data.abs(), rows, cols, x.abs(), n_rows)
    args = [t.to(cuda) for t in (data, rows, cols, x)]
    for block_k in GPU_K_TILES:
        for block_nnz in (None,) + GPU_NNZ_TILES:
            before = K3.coo_spmm.launches
            got = K3.coo_spmm(*args, n_rows, block_nnz=block_nnz,
                              block_k=block_k)
            torch.cuda.synchronize()
            assert K3.coo_spmm.launches == before + 1
            assert_kernel_close(got, want, mag)


def ragged_dense(rng, n_rows=100, n_cols=61):
    """Rows and columns that are no multiple of a BCSR block, a dense
    column, a run of empty columns and an empty last row."""
    dense = ((rng.random((n_rows, n_cols)) < 0.15) *
             rng.normal(size=(n_rows, n_cols))).astype(np.float32)
    dense[:, 5] = rng.normal(size=n_rows)
    dense[:, 30:40] = 0.0
    dense[-1] = 0.0
    return dense


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 1, 5, 128])
@pytest.mark.parametrize("block", [3, 4, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bcsr_kernels_match_plain_at_every_block_size(cuda, block,
                                                           dtype, batch):
    """K9 (``batch=None``) and K10 on ragged shapes: the fast paths for
    b = 4, 8, 16 and the generic one (b = 3), block columns past n_cols
    masked, rows past n_rows not written."""
    from repro_torch.kernels import bcsr_spmv as K9
    rng = np.random.default_rng(35 + block)
    dense = ragged_dense(rng)
    tm = TT.csr_from_dense(dense, pad=8, device="cpu")
    tm = dataclasses.replace(tm, data=tm.data.to(TDT[dtype]))
    m = TT.host_csr_to_bcsr(tm, block=block)
    shape = (61,) if batch is None else (61, batch)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        TDT[dtype])
    fn = K9.bcsr_spmv if batch is None else K9.bcsr_spmm
    args = (m.data, m.block_cols, m.indptr)
    before = fn.launches
    got = fn(*(a.to(cuda) for a in args), x.to(cuda), m.n_rows)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = fn(*args, x, m.n_rows)               # plain version, on the CPU
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 1, 3, 128])
def test_cuda_ccs_kernels_match_plain_on_empty_and_dense_columns(cuda,
                                                                 batch):
    from repro_torch.kernels import ccs_spmv as K7
    rng = np.random.default_rng(36)
    dense = ragged_dense(rng)
    m = TT.host_csr_to_ccs(TT.csr_from_dense(dense, pad=8, device="cpu"))
    shape = (61,) if batch is None else (61, batch)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    fn = K7.ccs_spmv if batch is None else K7.ccs_spmm
    args = (m.data, m.rows, m.indptr)
    got = fn(*(a.to(cuda) for a in args), x.to(cuda), m.n_rows,
             block_rows=7)
    want = fn(*args, x, m.n_rows)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               **TOL["float32"])
    np.testing.assert_allclose(got.cpu().numpy(), dense @ x.numpy(),
                               **TOL["float32"])


@pytest.mark.cuda
def test_cuda_ccs_bcsr_wrappers_count_no_launch_for_empty_input(cuda):
    from repro_torch.kernels import bcsr_spmv as K9
    from repro_torch.kernels import ccs_spmv as K7
    i32 = dict(dtype=torch.int32, device=cuda)
    x, X = torch.ones(5, device=cuda), torch.ones(5, 3, device=cuda)
    before = TK.launch_counts()
    ip = torch.zeros(6, **i32)
    assert not K7.ccs_spmv(torch.ones(0, device=cuda), torch.zeros(0, **i32),
                           ip, x, 4).any()
    assert not K7.ccs_spmm(torch.ones(8, device=cuda), torch.zeros(8, **i32),
                           ip, X, 0).any()
    blocks = torch.zeros(1, 8, 8, device=cuda)
    assert K9.bcsr_spmv(blocks, torch.zeros(1, **i32), torch.zeros(1, **i32),
                        x, 0).shape == (0,)
    assert K9.bcsr_spmm(blocks, torch.zeros(1, **i32), torch.zeros(2, **i32),
                        torch.ones(5, 0, device=cuda), 3).shape == (3, 0)
    assert TK.launch_counts() == before


# ---------------------------------------------------------------------------
# K11: the fused int8-KV decode attention, and the LM's decode on the card
# ---------------------------------------------------------------------------
def k11_inputs(rng, B, S, KV, G, Dh, q_dtype):
    """Random int8 codes and bfloat16 scales (the cache layout), each
    sequence filled to a random length in [S/2, S)."""
    from repro_torch.models.attention import _quantize_kv
    k_q, k_s = _quantize_kv(torch.from_numpy(
        rng.normal(size=(B, S, KV, Dh)).astype(np.float32)))
    v_q, v_s = _quantize_kv(torch.from_numpy(
        rng.normal(size=(B, S, KV, Dh)).astype(np.float32)))
    q = torch.from_numpy(rng.normal(size=(B, KV, G, Dh)).astype(
        np.float32)).to(TDT[q_dtype])
    lens = rng.integers(S // 2, S, size=B)
    key_pos = torch.from_numpy(np.where(
        np.arange(S)[None, :] < lens[:, None], np.arange(S)[None, :],
        -1).astype(np.int32))
    q_pos = torch.from_numpy((lens - 1).astype(np.int32))
    return [q, k_q, k_s, v_q, v_s, key_pos, q_pos]


def assert_k11_close(got, want, q_dtype):
    """float32 q: the reference's 2e-4; bfloat16 q: one bfloat16 ulp of the
    larger value (both round float32 values that differ only in summation
    order) plus 1e-6 for the float32 sums' own error, which near zero (a
    mean of +-v over many slots cancels) exceeds one ulp of the value."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    if q_dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(
            np.maximum(np.abs(got), np.abs(want)),
            np.finfo(np.float32).tiny))) - 7)
        assert np.all(np.abs(got - want) <= ulp + 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,KV,G,Dh,window", [
    (2, 512, 2, 3, 64, None), (1, 1024, 4, 1, 128, None),
    (3, 640, 2, 2, 32, 256), (2, 512, 1, 6, 64, 128),
    (8, 1000, 8, 2, 128, None),       # ragged S, the served head shape
    (2, 300, 2, 2, 16, None),         # the smoke configs' head_dim
    (2, 200, 2, 5, 80, 64),           # h2o-danube's head_dim 80, G = 5
    (1, 5, 1, 2, 128, None)])         # fewer slots than one split's keys
def test_cuda_decode_attention_int8_matches_plain(cuda, B, S, KV, G, Dh,
                                                  window, q_dtype):
    from repro_torch.kernels import decode_attention as K11
    rng = np.random.default_rng(41)
    args = k11_inputs(rng, B, S, KV, G, Dh, q_dtype)
    before = TK.launch_counts()["decode_attention_int8"]
    got = K11.decode_attention_int8(*[a.to(cuda) for a in args],
                                    window=window)
    torch.cuda.synchronize()
    assert TK.launch_counts()["decode_attention_int8"] == before + 1
    assert got.shape == (B, KV, G, Dh) and got.dtype == TDT[q_dtype]
    want = K11.decode_attention_int8_plain(*args, window=window)
    assert_k11_close(got, want, q_dtype)
    on_card = K11.decode_attention_int8_plain(*[a.to(cuda) for a in args],
                                              window=window)
    assert_k11_close(got, on_card, q_dtype)


@pytest.mark.cuda
def test_cuda_decode_attention_int8_fully_masked_rows(cuda):
    """No valid slot (empty cache, or q_pos before every key): the mean of
    V over all slots, as the reference gives, never NaN."""
    from repro_torch.kernels import decode_attention as K11
    args = k11_inputs(np.random.default_rng(42), 3, 700, 2, 2, 64, "float32")
    args[5][1] = -1
    args[6][2] = -1
    got = K11.decode_attention_int8(*[a.to(cuda) for a in args], window=32)
    assert bool(torch.isfinite(got).all())
    assert_k11_close(got, K11.decode_attention_int8_plain(*args, window=32),
                     "float32")


@pytest.mark.cuda
def test_cuda_decode_attention_int8_refuses_what_it_cannot_read(cuda):
    from repro_torch.kernels import decode_attention as K11
    args = [a.to(cuda) for a in k11_inputs(np.random.default_rng(43), 2, 64,
                                           2, 2, 32, "float32")]
    before = TK.launch_counts()["decode_attention_int8"]
    for i, bad in ((2, args[2].float()), (4, args[4].float())):
        with pytest.raises(TypeError):
            K11.decode_attention_int8(*(args[:i] + [bad] + args[i + 1:]))
    odd = k11_inputs(np.random.default_rng(44), 2, 64, 2, 2, 24, "float32")
    with pytest.raises(ValueError):
        K11.decode_attention_int8(*[a.to(cuda) for a in odd])
    # a view whose codes start off a 16-byte boundary
    k_q = torch.zeros(2 * 64 * 2 * 32 + 8, dtype=torch.int8, device=cuda)
    k_q = k_q[8:].view(2, 64, 2, 32)
    with pytest.raises(ValueError):
        K11.decode_attention_int8(*(args[:1] + [k_q] + args[2:]))
    assert TK.launch_counts()["decode_attention_int8"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-1.8b"])
def test_cuda_int8_decode_step_launches_k11_per_layer(cuda, arch):
    """The model's int8 decode step on the card launches K11 once per layer
    and gives the CPU's logits (float32; the plain version on the host)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import model as TM
    cfg = smoke_config(get_config(arch)).replace(kv_quant=True)
    params = TM.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = [{k: {n: t.to(cuda) for n, t in v.items()}
                for k, v in layer.items()} for layer in params["layers"]]
    p_card = {k: ({n: t.to(cuda) for n, t in v.items()}
                  if isinstance(v, dict) else v)
              for k, v in params.items() if k != "layers"}
    p_card["layers"] = on_card
    toks = torch.from_numpy(np.random.default_rng(45).integers(
        0, cfg.vocab_size, (2, 40)))
    logits = {}
    for dev in ("cpu", cuda):
        p = params if dev == "cpu" else p_card
        caches = TM.init_caches(cfg, 2, 48, torch.float32, device=dev)
        _, caches = TM.prefill(p, {"tokens": toks[:, :-1].to(dev)}, caches,
                               cfg)
        before = TK.launch_counts()["decode_attention_int8"]
        logits[str(dev)], _ = TM.decode_step(
            p, toks[:, -1:].to(dev), caches, torch.tensor([39, 30],
                                                          device=dev), cfg)
        torch.cuda.synchronize()
        launched = TK.launch_counts()["decode_attention_int8"] - before
        assert launched == (cfg.n_layers if dev == cuda else 0)
    # cuBLAS and the CPU sum in other orders, and an int8 code may then
    # round the other way (~3e-4 on these logits, test_torch_lm_model.py)
    np.testing.assert_allclose(logits[str(cuda)].cpu().numpy(),
                               logits["cpu"].numpy(), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# K2: entry slices, rows joined by a keyed scan and carries — deterministic
# ---------------------------------------------------------------------------
def csr_arrays(kind, seed, dtype):
    """CPU ``(data, cols, indptr, x)`` of one CSR case: ``empty_rows``
    (leading, trailing and every third row empty), ``one_row`` (every entry
    in one row), ``power_law`` (torso1's two-point rows, 4959 entries each,
    past several slices of every tile), ``pads`` (slots past IRP[-1] hold
    NaN: never read), ``ragged`` (1003 entries: no multiple of 4), and
    ``unaligned`` (``data[1:]``, ``cols[1:]``: no 16-byte load aligns)."""
    from repro_torch.core import suite
    rng = np.random.default_rng(seed)
    n_cols = 300
    if kind == "power_law":
        spec = next(s for s in suite.TABLE1 if s.name == "torso1")
        m = suite.synthesize(spec, scale=0.05, device="cpu")
        data, cols, indptr = m.data, m.cols, m.indptr
        n_cols = m.n_cols
        data = torch.from_numpy(rng.normal(size=data.shape[0]).astype(
            np.float32))
    else:
        lens = {"empty_rows": np.where(np.arange(90) % 3 == 0, 0,
                                       rng.integers(1, 40, 90)),
                "one_row": np.where(np.arange(50) == 3, 5000, 0),
                "pads": rng.integers(0, 30, 70),
                "ragged": np.full(59, 17),
                "unaligned": rng.integers(0, 50, 80)}[kind]
        if kind == "empty_rows":
            lens[:4] = 0
            lens[-5:] = 0
        if kind == "ragged":
            lens[-1] = 1003 - 17 * 58
        nnz = int(lens.sum())
        indptr = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(lens)]).astype(np.int32))
        cols = torch.from_numpy(rng.integers(0, n_cols, nnz).astype(np.int32))
        data = torch.from_numpy(rng.normal(size=nnz).astype(np.float32))
        if kind == "pads":
            data = torch.cat([data, torch.full((61,), float("nan"))])
            cols = torch.cat([cols, torch.zeros(61, dtype=torch.int32)])
    x = torch.from_numpy(rng.normal(size=n_cols).astype(np.float32))
    data = data.to(TDT[dtype])
    if kind == "unaligned":
        data = torch.cat([data[:1], data])[1:]
        cols = torch.cat([cols[:1], cols])[1:]
    return data, cols, indptr, x.to(TDT[dtype])


CSR_KINDS = ("empty_rows", "one_row", "power_law", "pads", "ragged",
             "unaligned")


def on_card(arrays, cuda):
    """The arrays on the card, keeping a view's offset (``unaligned``)."""
    out = []
    for a in arrays:
        if a.storage_offset():
            base = a._base if a._base is not None else a
            out.append(base.to(cuda)[a.storage_offset():])
        else:
            out.append(a.to(cuda))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", CSR_KINDS)
def test_cuda_csr_spmv_slices_match_plain_at_every_tile(cuda, kind, dtype):
    """K2 against its plain version at the default launch and every
    candidate of the tuner's grid (entries per block), each launch giving
    the same bits twice."""
    from repro_torch.core.kernel_tune import candidate_geometries
    from repro_torch.kernels import csr_spmv as K2
    data, cols, indptr, x = csr_arrays(kind, 61, dtype)
    want = K2.csr_spmv_plain(data, cols, indptr, x)
    mag = K2.csr_spmv_plain(data.nan_to_num().abs(), cols, indptr, x.abs())
    args = on_card((data, cols, indptr, x), cuda)
    if kind == "unaligned":
        assert args[0].data_ptr() % 16 and args[1].data_ptr() % 16
    grid = candidate_geometries("csr", "spmv", n_rows=indptr.shape[0] - 1,
                                nnz_pad=data.shape[0])
    assert grid and all(g.block_nnz for g in grid)
    for bn in [None] + [g.block_nnz for g in grid]:
        before = K2.csr_spmv.launches
        got = K2.csr_spmv(*args, block_nnz=bn)
        again = K2.csr_spmv(*args, block_nnz=bn)
        torch.cuda.synchronize()
        assert K2.csr_spmv.launches == before + 2
        assert torch.equal(got, again), bn
        assert_kernel_close(got, want, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("block_nnz", (None,) + GPU_NNZ_TILES)
def test_cuda_csr_spmv_is_bit_identical_across_launches(cuda, block_nnz):
    """Rows of 4959 entries cross several slices: their carries are added in
    slice order, so ten launches give one result, bit for bit."""
    from repro_torch.kernels import csr_spmv as K2
    args = on_card(csr_arrays("power_law", 62, "float32"), cuda)
    first = K2.csr_spmv(*args, block_nnz=block_nnz)
    for _ in range(9):
        assert torch.equal(K2.csr_spmv(*args, block_nnz=block_nnz), first)


# ---------------------------------------------------------------------------
# K8: a block's adjacent columns meet in a shared-memory window of Y rows
# ---------------------------------------------------------------------------
def ccs_arrays(kind, seed, dtype):
    """CPU ``(data, rows, indptr, n_rows)`` of one CCS case: ``banded``
    (xenon2's band), ``scattered`` (viscoplastic2's hashed columns),
    ``shuffled`` (the band with each column's rows in random order),
    ``wide`` (the band plus entries far from it, so a block's rows span past
    its window), ``heavy`` (torso1's long rows: the widest window), ``ragged``
    (empty and dense columns) and ``all_zero``."""
    from repro_torch.core import suite
    rng = np.random.default_rng(seed)
    specs = {s.name: s for s in suite.TABLE1}
    if kind == "ragged":
        csr = TT.csr_from_dense(ragged_dense(rng), pad=8, device="cpu")
    elif kind == "all_zero":
        csr = TT.csr_from_dense(np.zeros((40, 30), np.float32), pad=8,
                                device="cpu")
    elif kind == "wide":
        dense = np.zeros((400, 400), np.float32)
        i = np.arange(400)
        for off in range(-6, 7):
            j = np.clip(i + off, 0, 399)
            dense[i, j] = rng.normal(size=400)
        far = rng.integers(0, 400, (600, 2))
        dense[far[:, 0], far[:, 1]] = rng.normal(size=600)
        csr = TT.csr_from_dense(dense, pad=8, device="cpu")
    else:
        name, scale = {"banded": ("xenon2", 0.02),
                       "shuffled": ("xenon2", 0.02),
                       "scattered": ("viscoplastic2", 0.1),
                       "heavy": ("torso1", 0.02)}[kind]
        csr = suite.synthesize(specs[name], scale=scale, device="cpu")
    m = TT.host_csr_to_ccs(csr)
    data = torch.from_numpy(rng.normal(size=m.data.shape[0]).astype(
        np.float32))
    rows = m.rows.clone()
    if kind == "shuffled":
        ip = m.indptr.numpy()
        perm = np.concatenate([a + rng.permutation(b - a)
                               for a, b in zip(ip[:-1], ip[1:])]
                              + [np.arange(ip[-1], rows.shape[0])])
        rows, data = rows[perm], data[perm]
    return data.to(TDT[dtype]), rows, m.indptr, m.n_rows


CCS_KINDS = ("banded", "scattered", "shuffled", "wide", "heavy", "ragged",
             "all_zero")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 3, 8, 40, 128])
@pytest.mark.parametrize("kind", CCS_KINDS)
def test_cuda_ccs_spmm_window_matches_plain(cuda, kind, batch, dtype):
    """K8 against its plain version at the default launch, each column tile
    of the tuner's grid and a few columns-per-block values (so windows of
    other sizes and places)."""
    from repro_torch.kernels import ccs_spmv as K7
    data, rows, indptr, n_rows = ccs_arrays(kind, 63, dtype)
    rng = np.random.default_rng(64)
    x = torch.from_numpy(rng.normal(size=(indptr.shape[0] - 1, batch)).astype(
        np.float32)).to(TDT[dtype])
    want = K7.ccs_spmm_plain(data, rows, indptr, x, n_rows)
    mag = K7.ccs_spmm_plain(data.abs(), rows, indptr, x.abs(), n_rows)
    args = [t.to(cuda) for t in (data, rows, indptr, x)]
    for block_k in (None,) + GPU_K_TILES:
        for block_rows in (None, 1, 7, 32):
            before = K7.ccs_spmm.launches
            got = K7.ccs_spmm(*args, n_rows, block_rows=block_rows,
                              block_k=block_k)
            torch.cuda.synchronize()
            assert K7.ccs_spmm.launches == before + 1
            assert_kernel_close(got, want, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [8, 32, 128])
def test_cuda_ccs_spmm_widest_window(cuda, batch):
    """torso1's columns reach ~75 rows past a block's own, so at B = 128 each
    lane group keeps the most rows it may (16) in registers; the rest of its
    rows' entries go to Y from outside the window."""
    from repro_torch.kernels import _common as C
    from repro_torch.kernels import ccs_spmv as K7
    data, rows, indptr, n_rows = ccs_arrays("heavy", 65, "float32")
    n_cols = indptr.shape[0] - 1
    *_, window, rows_per_group = C.ccs_spmm_launch(batch, n_rows, n_cols,
                                                   data.shape[0])
    assert rows_per_group == (C.CCS_ROWS_PER_GROUP_MAX if batch > 16 else 0)
    x = torch.from_numpy(np.random.default_rng(66).normal(
        size=(n_cols, batch)).astype(np.float32))
    got = K7.ccs_spmm(*(t.to(cuda) for t in (data, rows, indptr, x)), n_rows)
    assert_kernel_close(got, K7.ccs_spmm_plain(data, rows, indptr, x, n_rows),
                        K7.ccs_spmm_plain(data.abs(), rows, indptr, x.abs(),
                                          n_rows))


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [1.5, 30.0])
@pytest.mark.parametrize("B,S,KV,G,Dh,window", [
    (2, 512, 2, 3, 64, None), (3, 640, 2, 2, 32, 256),
    (8, 1000, 8, 2, 128, None)])
def test_cuda_decode_attention_int8_softcap_matches_plain(
        cuda, B, S, KV, G, Dh, window, softcap, q_dtype):
    """K11 with the reference's logit softcap (cap * tanh(s / cap) before
    the mask) against its plain version; a cap of 1.5 bends every score."""
    from repro_torch.kernels import decode_attention as K11
    args = k11_inputs(np.random.default_rng(46), B, S, KV, G, Dh, q_dtype)
    args[0] = args[0] * 8      # scores of several units, so the cap bites
    got = K11.decode_attention_int8(*[a.to(cuda) for a in args],
                                    window=window, softcap=softcap)
    torch.cuda.synchronize()
    want = K11.decode_attention_int8_plain(*args, window=window,
                                           softcap=softcap)
    assert_k11_close(got, want, q_dtype)
    if softcap < 2:
        uncapped = K11.decode_attention_int8_plain(*args, window=window)
        assert not torch.allclose(uncapped.float(), want.float(), atol=1e-2)


# ---------------------------------------------------------------------------
# K7: a warp's run of adjacent columns meets in a shared-memory window of y
# ---------------------------------------------------------------------------
def ccs_spmv_arrays(kind, seed, dtype):
    """CPU ``(data, rows, indptr, n_rows)`` of one K7 case.  Beside
    :func:`ccs_arrays`'s kinds: ``collide`` (40 copies of one row in one
    column, inside its window, and 40 of another far outside it: lanes of
    one pass on one row), ``boundary`` (runs of columns on the same 20 rows,
    so a pass spans two columns with equal rows), ``long`` (columns of 600
    entries, past 32 and past any window), ``outside`` (every entry far from
    the rows its column maps to: none falls in a window, clamped ones at
    either end included), ``pads`` (slots past IRP_T[-1] hold NaN: never
    read) and ``unaligned`` (``data[1:]``, ``rows[1:]`` views)."""
    rng = np.random.default_rng(seed)
    if kind in CCS_KINDS:
        return ccs_arrays(kind, seed, dtype)
    if kind in ("collide", "boundary", "long", "outside", "pads",
                "unaligned"):
        n_rows = n_cols = 2000
        cols_rows = []
        for c in range(n_cols):
            if kind == "collide":
                r = np.sort(rng.choice(n_rows, 12, replace=False))
                if c == 5:
                    r = np.concatenate([r, np.full(40, 6),
                                        np.full(40, 1700)])
            elif kind == "boundary":
                r = c // 64 * 64 % (n_rows - 20) + np.arange(20)
            elif kind == "long":
                r = (np.sort(rng.choice(n_rows, 600, replace=False))
                     if c % 50 == 0 else np.array([c]))
            elif kind == "outside":
                r = np.array([(c + 1000 + d) % n_rows for d in (0, 7, 300)])
            else:             # a band, as xenon2's
                r = np.clip(c + np.arange(-8, 9), 0, n_rows - 1)
                r = np.unique(r)
            cols_rows.append(np.asarray(r, np.int64))
        lens = np.array([len(r) for r in cols_rows])
        indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        nnz = int(indptr[-1])
        rows = np.concatenate(cols_rows).astype(np.int32)
        data = rng.normal(size=nnz).astype(np.float32)
        tail = 13             # pads past IRP_T[-1]
        rows = np.concatenate([rows, np.zeros(tail, np.int32)])
        data = np.concatenate([data, np.full(tail, np.nan if kind == "pads"
                                             else 0.0, np.float32)])
        data = torch.from_numpy(data).to(TDT[dtype])
        rows = torch.from_numpy(rows)
        if kind == "unaligned":
            data = torch.cat([data[:1], data])[1:]
            rows = torch.cat([rows[:1], rows])[1:]
        return data, rows, torch.from_numpy(indptr), n_rows
    raise ValueError(kind)


CCS_SPMV_KINDS = CCS_KINDS + ("collide", "boundary", "long", "outside",
                              "pads", "unaligned")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", CCS_SPMV_KINDS)
def test_cuda_ccs_spmv_window_matches_plain(cuda, kind, dtype):
    """K7 against its plain version at the default launch and at every
    columns-per-block candidate of the tuner's grid (so windows of other
    sizes and places, and runs of 1 to 128 columns a warp)."""
    from repro_torch.core.kernel_tune import candidate_geometries
    from repro_torch.kernels import ccs_spmv as K7
    data, rows, indptr, n_rows = ccs_spmv_arrays(kind, 67, dtype)
    x = torch.from_numpy(np.random.default_rng(68).normal(
        size=indptr.shape[0] - 1).astype(np.float32)).to(TDT[dtype])
    want = K7.ccs_spmv_plain(data, rows, indptr, x, n_rows)
    mag = K7.ccs_spmv_plain(data.abs(), rows, indptr, x.abs(), n_rows)
    args = on_card((data, rows, indptr, x), cuda)
    if kind == "unaligned":
        assert args[0].data_ptr() % 16 and args[1].data_ptr() % 16
    flushes = K7.ccs_spmv_flushes(rows, indptr, n_rows)
    if kind == "outside":
        assert flushes["flushed"] == 0 and flushes["outside"] == int(
            indptr[-1])
    grid = candidate_geometries("ccs", "spmv", n_rows=indptr.shape[0] - 1,
                                nnz_pad=data.shape[0])
    for br in [None] + [g.block_rows for g in grid]:
        before = K7.ccs_spmv.launches
        got = K7.ccs_spmv(*args, n_rows, block_rows=br)
        torch.cuda.synchronize()
        assert K7.ccs_spmv.launches == before + 1
        assert_kernel_close(got, want, mag)


# ---------------------------------------------------------------------------
# K4: no X gather for a padded slot, the same result
# ---------------------------------------------------------------------------
def ell_nonfinite_case(rng, batch):
    """A 64-row ELL-Row panel of 7 slots over 50 columns, CPU tensors
    ``(data, cols, x)``: rows 0-15 full and off column 0, 16-31 ending in
    pads (0, column 0), 32-39 a stored +0 at column 0 mid-band, 40-47 a
    stored -0 there, 48-55 a stored 0 at column 3, 56-63 a real entry at
    column 0.  ``X[0, :]`` cycles through +inf, 1.5, -inf and NaN."""
    n_rows, width, n_cols = 64, 7, 50
    cols = rng.integers(1, n_cols, (n_rows, width)).astype(np.int32)
    data = rng.normal(size=(n_rows, width)).astype(np.float32)
    cols[16:32, 4:], data[16:32, 4:] = 0, 0.0
    cols[32:48, 2] = 0
    data[32:40, 2], data[40:48, 2] = 0.0, -0.0
    cols[48:56, 5], data[48:56, 5] = 3, 0.0
    cols[56:64, 1] = 0
    x = rng.normal(size=(n_cols, batch)).astype(np.float32)
    x[0] = np.resize(np.array([np.inf, 1.5, -np.inf, np.nan], np.float32),
                     batch)
    return (torch.from_numpy(data), torch.from_numpy(cols),
            torch.from_numpy(x))


def assert_same_nonfinite(got, want, mag):
    """NaN and infinities in the same places (infinities of the same
    sign); the finite values held as :func:`assert_kernel_close` holds
    them."""
    got = got.cpu()
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    err = (got[fin].double() - want[fin].double()).abs()
    assert bool((err <= KERNEL_REL_TOL * mag[fin].double()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [1, 4, 128, 129])
def test_cuda_ell_spmm_pads_keep_non_finite_x0(cuda, batch, dtype):
    """K4 skips the X gather of a (+-0, column 0) slot and adds 0 * X[0]
    once a row: NaN exactly where the plain version has it (the rows
    whose band holds such a slot, where X[0, b] is not finite), the
    infinities of real column-0 entries, the rest within the tolerance."""
    data, cols, x = ell_nonfinite_case(np.random.default_rng(71), batch)
    data, x = data.to(TDT[dtype]), x.to(TDT[dtype])
    want = K1.ell_spmm_plain(data, cols, x)
    assert bool(torch.isnan(want[16:48, 0]).all())
    assert not bool(torch.isnan(want[:16]).any())
    xf = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    mag = K1.ell_spmm_plain(data.abs(), cols, xf.abs())
    for block_k in (None,) + GPU_K_TILES:
        got = K1.ell_spmm(data.to(cuda), cols.to(cuda), x.to(cuda),
                          block_k=block_k)
        torch.cuda.synchronize()
        assert_same_nonfinite(got, want, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 4, 8, 31, 32, 128, 129])
@pytest.mark.parametrize("fmt", ["ell_row", "ell_col", "sell"])
def test_cuda_ell_spmm_every_tile_and_pitch(cuda, fmt, batch):
    """K4 on ELL-Row, ELL-Col (viewed transposed) and each SELL bucket,
    float32 and bfloat16, at the default column tile and each of the
    tuner's, with X's rows at an odd pitch (odd B) and X at an address no
    vector load aligns to; two launches give the same bits."""
    rng = np.random.default_rng(72)
    tf = TT.TRANSFORMS_HOST[fmt](TT.csr_from_dense(
        heavy_tail_dense(rng), pad=8, device="cpu"))
    if fmt == "sell":
        panels = [(b.data, b.cols) for b in tf.buckets]
    elif fmt == "ell_col":
        panels = [(tf.data.t(), tf.cols.t())]
    else:
        panels = [(tf.data, tf.cols)]
    for dtype in ("float32", "bfloat16"):
        xs = torch.from_numpy(rng.normal(size=(200, batch)).astype(
            np.float32)).to(TDT[dtype])
        moved = torch.empty(200 * batch + 1, dtype=TDT[dtype],
                            device=cuda)[1:].view(200, batch)
        moved.copy_(xs)
        for data, cols in panels:
            data = data.to(TDT[dtype])
            want = K1.ell_spmm_plain(data, cols, xs)
            mag = K1.ell_spmm_plain(data.abs(), cols, xs.abs())
            d, c = data.to(cuda), cols.to(cuda)
            if fmt == "ell_col":
                d, c = d.t().contiguous().t(), c.t().contiguous().t()
            for X in (xs.to(cuda), moved):
                for block_k in (None,) + GPU_K_TILES:
                    got = K1.ell_spmm(d, c, X, block_k=block_k)
                    again = K1.ell_spmm(d, c, X, block_k=block_k)
                    torch.cuda.synchronize()
                    assert torch.equal(got, again)
                    assert_kernel_close(got, want, mag)
