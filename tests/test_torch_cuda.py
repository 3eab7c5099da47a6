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
torch = pytest.importorskip("torch")

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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dbrx-132b", "mixtral-8x22b",
                                  "zamba2-1.2b"])
def test_cuda_new_families_decode_step_k11_against_plain(cuda, arch,
                                                         monkeypatch):
    """The MoE and hybrid archs' int8 decode step on the card: K11 launches
    once per attention layer (every layer of dbrx and mixtral, zamba2's
    shared block in its mamba_attn layers), and the step's logits equal
    the same step with K11's plain version in its place (float32)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import decode_attention as K11
    from repro_torch.models import attention as TA
    from repro_torch.models import model as TM
    from repro_torch.sharding.rules import tree_map
    cfg = smoke_config(get_config(arch)).replace(kv_quant=True,
                                                 moe_dispatch="auto")
    params = tree_map(lambda t: t.to(cuda), TM.init(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(46).integers(
        0, cfg.vocab_size, (2, 40))).to(cuda)
    caches = TM.init_caches(cfg, 2, 48, torch.float32, device=cuda)
    TM.prefill(params, {"tokens": toks[:, :-1]}, caches, cfg)
    snapshot = tree_map(torch.clone, caches)
    pos = torch.tensor([39, 30], device=cuda)
    attn_layers = sum(k in ("moe", "local_moe", "mamba_attn")
                      for k in TM.layer_kinds(cfg))
    before = TK.launch_counts()["decode_attention_int8"]
    got, _ = TM.decode_step(params, toks[:, -1:], caches, pos, cfg)
    torch.cuda.synchronize()
    assert TK.launch_counts()["decode_attention_int8"] - before == \
        attn_layers > 0
    monkeypatch.setattr(TA, "decode_attention_int8",
                        K11.decode_attention_int8_plain)
    want, _ = TM.decode_step(params, toks[:, -1:], snapshot, pos, cfg)
    assert torch.isfinite(got).all()
    # K11 and its plain version sum the slots in other orders (float32,
    # 2e-4 apart at most per output, test_torch_decode_attention.py)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-3, atol=1e-3)


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


# ---------------------------------------------------------------------------
# K1 read up to each row's live extent; K5's window of X rows
# ---------------------------------------------------------------------------
def extent_panel(kind, rng, width=11):
    """A 300-row ELL-Row panel over 90 columns, CPU tensors ``(data,
    cols)``: random row lengths, explicit zeros at column 0 and elsewhere,
    empty rows, or every slot a pad."""
    n_rows, n_cols = 300, 90
    lens = rng.integers(0, width + 1, n_rows)
    live = np.arange(width) < lens[:, None]
    data = np.where(live, rng.normal(size=(n_rows, width)), 0.0).astype(
        np.float32)
    cols = np.where(live, rng.integers(1, n_cols, (n_rows, width)),
                    0).astype(np.int32)
    if kind == "explicit_zeros":
        data[::7, 1], cols[::7, 1] = 0.0, 5
        data[3::7, 2], cols[3::7, 2] = 0.0, 0
        data[5::7, width - 1], cols[5::7, width - 1] = 0.0, 2
    elif kind == "empty_rows":
        data[::3], cols[::3] = 0.0, 0
    elif kind == "all_pads":
        data[:], cols[:] = 0.0, 0
    return torch.from_numpy(data), torch.from_numpy(cols)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [11, 43, 130])
@pytest.mark.parametrize("order", ["row", "col"])
@pytest.mark.parametrize("kind", ["random", "explicit_zeros", "empty_rows",
                                  "all_pads"])
def test_cuda_ell_spmv_extent_matches_plain(cuda, kind, order, width):
    """K1 with and without an extent against its plain version, float32 and
    bfloat16, ELL-Row (8 or 32 lanes a row) and ELL-Col (a thread a row),
    at the default launch and the tuner's rows per block."""
    rng = np.random.default_rng(81)
    data, cols = extent_panel(kind, rng, width)
    for dtype in ("float32", "bfloat16"):
        d = data.to(TDT[dtype])
        x = torch.from_numpy(rng.normal(size=90).astype(np.float32)).to(
            TDT[dtype])
        ext = K1.ell_extent(d, cols)
        want = K1.ell_spmv_plain(d, cols, x, ext)
        mag = K1.ell_spmv_plain(d.abs(), cols, x.abs())
        dc, cc = d.to(cuda), cols.to(cuda)
        if order == "col":
            dc, cc = dc.t().contiguous().t(), cc.t().contiguous().t()
        ext_c = K1.ell_extent(dc, cc)
        assert torch.equal(ext_c.cpu(), ext)
        for br in (None, 1, 64, 1024):
            for e in (ext_c, None):
                before = K1.ell_spmv.launches
                got = K1.ell_spmv(dc, cc, x.to(cuda), extent=e,
                                  block_rows=br)
                torch.cuda.synchronize()
                assert K1.ell_spmv.launches == before + 1
                assert_kernel_close(got, want, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["row", "col"])
def test_cuda_ell_spmv_extent_keeps_non_finite_x(cuda, order):
    """With an extent K1 turns NaN exactly the rows the plain version does:
    those whose band holds a pad, where x[0] is not finite (+-inf, NaN),
    and those with a stored zero under a non-finite x[c]; the infinities of
    real entries stay infinities."""
    rng = np.random.default_rng(82)
    data, cols, X = ell_nonfinite_case(rng, 4)
    for dtype in ("float32", "bfloat16"):
        d = data.to(TDT[dtype])
        dc, cc = d.to(cuda), cols.to(cuda)
        if order == "col":
            dc, cc = dc.t().contiguous().t(), cc.t().contiguous().t()
        ext = K1.ell_extent(dc, cc)
        for b in range(4):
            x = X[:, b].contiguous().to(TDT[dtype])
            for c in (None, 3):         # x[3] sits under stored zeros
                if c is not None:
                    x = x.clone()
                    x[c] = float("inf")
                want = K1.ell_spmv_plain(d, cols, x, ext.cpu())
                assert torch.equal(torch.isnan(want), torch.isnan(
                    K1.ell_spmv_plain(d, cols, x)))
                xf = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
                mag = K1.ell_spmv_plain(d.abs(), cols, xf.abs())
                got = K1.ell_spmv(dc, cc, x.to(cuda), extent=ext)
                torch.cuda.synchronize()
                assert_same_nonfinite(got, want, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["ell_row", "ell_col", "sell"])
def test_cuda_prepared_ell_reads_its_extent(cuda, fmt):
    """A bound ELL or SELL container carries its extents on the card and
    its product launches K1 with them: the plain version's values."""
    from repro_torch.kernels import ops as T_ops
    rng = np.random.default_rng(83)
    dense = heavy_tail_dense(rng)
    tf = TT.TRANSFORMS_HOST[fmt](TT.csr_from_dense(dense, pad=8,
                                                   device="cpu"))
    m = T_ops.prepare(tf.to(cuda))
    panels = m.buckets if fmt == "sell" else (m,)
    assert all(T_ops.ell_extent_of(p).is_cuda for p in panels)
    x = torch.from_numpy(rng.normal(size=200).astype(np.float32))
    got = TD.spmv(m, x.to(cuda), tier="kernel")
    torch.cuda.synchronize()
    want = TD.spmv(tf, x, tier="kernel")
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               **TOL["float32"])


def csr_window_case(kind, seed, dtype):
    """CPU ``(data, cols, indptr)`` of a 3000-row matrix over 2600 columns:
    a band of 0-40 entries a row about the diagonal, hash-scattered
    columns, the band with rows of every column and empty rows (heavy
    tail), or the band with each row's columns shuffled."""
    rng = np.random.default_rng(seed)
    n, n_cols = 3000, 2600
    lens = rng.integers(0, 41, n)
    if kind == "heavy_tail":
        lens[::500] = n_cols
        lens[3::11] = 0
    cols = []
    for r in range(n):
        k = int(lens[r])
        if kind == "scattered":
            c = (r + np.arange(k) * 1009) % n_cols
        else:
            c0 = min(max(r * n_cols // n - k // 2, 0), n_cols - k)
            c = np.arange(c0, c0 + k)
            if kind == "unsorted":
                c = rng.permutation(c)
        cols.append(c)
    cols = np.concatenate(cols).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    data = rng.normal(size=cols.shape[0]).astype(np.float32)
    return (torch.from_numpy(data).to(TDT[dtype]), torch.from_numpy(cols),
            torch.from_numpy(indptr))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 3, 8, 17, 32, 40, 128, 129])
@pytest.mark.parametrize("kind", ["banded", "scattered", "heavy_tail",
                                  "unsorted"])
def test_cuda_csr_spmm_window_matches_plain(cuda, kind, batch):
    """K5 against its plain version, float32 and bfloat16, at the default
    launch and in the window kernel at every B, tiles narrower than B, rows
    per block from 1 to a window past 48 KB of shared memory, with X
    aligned (bulk copies) and at an odd address (plain loads); two launches
    give the same bits."""
    from repro_torch.kernels import csr_spmv as K2
    n_cols = 2600
    for dtype in ("float32", "bfloat16"):
        data, cols, indptr = csr_window_case(kind, 84, dtype)
        xs = torch.from_numpy(np.random.default_rng(85).normal(
            size=(n_cols, batch)).astype(np.float32)).to(TDT[dtype])
        want = K2.csr_spmm_plain(data, cols, indptr, xs)
        mag = K2.csr_spmm_plain(data.abs(), cols, indptr, xs.abs())
        args = on_card((data, cols, indptr), cuda)
        moved = torch.empty(n_cols * batch + 1, dtype=TDT[dtype],
                            device=cuda)[1:].view(n_cols, batch)
        moved.copy_(xs)
        for X in (xs.to(cuda), moved):
            for g in (dict(), dict(window=True), dict(block_rows=1),
                      dict(block_rows=256, window=True),
                      dict(block_rows=1024, window=True),
                      dict(block_k=32, window=True),
                      dict(block_rows=37, block_k=8, window=True)):
                before = K2.csr_spmm.launches
                got = K2.csr_spmm(*args, X, **g)
                again = K2.csr_spmm(*args, X, **g)
                torch.cuda.synchronize()
                assert K2.csr_spmm.launches == before + 2
                assert torch.equal(got, again), g
                assert_kernel_close(got, want, mag)


@pytest.mark.cuda
def test_cuda_csr_spmm_window_past_48k_and_its_misses(cuda, monkeypatch):
    """At B = 128 float32 a block of 256 rows may keep 262 X rows (134 KB of
    shared memory, past the 48 KB a launch gets without asking) where its
    window may take all of an SM's; the banded matrix's windows serve every
    entry, the scattered one's few."""
    from repro_torch import launch_shapes as LS
    from repro_torch.kernels import _common as C
    from repro_torch.kernels import csr_spmv as K2
    monkeypatch.setattr(LS, "CSR_SPMM_BLOCKS_PER_SM", 1)
    for kind, served in (("banded", True), ("scattered", False)):
        data, cols, indptr = csr_window_case(kind, 86, "float32")
        _, _, _, _, rows, window, _ = C.csr_spmm_launch(
            128, 3000, 2600, data.shape[0], block_rows=256)
        assert window * 128 * 4 > 48 * 1024
        X = torch.from_numpy(np.random.default_rng(87).normal(
            size=(2600, 128)).astype(np.float32))
        want = K2.csr_spmm_plain(data, cols, indptr, X)
        mag = K2.csr_spmm_plain(data.abs(), cols, indptr, X.abs())
        got = K2.csr_spmm(*on_card((data, cols, indptr), cuda), X.to(cuda),
                          block_rows=256)
        torch.cuda.synchronize()
        assert_kernel_close(got, want, mag)
        misses = K2.csr_spmm_window_misses(cols, indptr, 2600, 128,
                                           block_rows=256)
        if served:
            assert misses["misses"] == 0
            assert misses["windowed"] == misses["blocks"]
        else:
            assert misses["misses"] > 0.5 * misses["entries"]


# ---------------------------------------------------------------------------
# K10: block products on the tensor cores over X slices in shared memory
# ---------------------------------------------------------------------------
#: (data, x) value types: every pairing the kernels take
K10_PAIRS = [("float32", "float32"), ("float32", "bfloat16"),
             ("bfloat16", "float32"), ("bfloat16", "bfloat16")]


def bcsr_case(kind, block, seed, data_dtype):
    """A CPU BCSR matrix of one K10 case: ``ragged`` (ragged_dense: its last
    block column runs past n_cols, its last block row past n_rows),
    ``empty_rows`` (the same with runs of empty block rows), ``zero`` (no
    stored block) and ``band`` (a band three blocks wide over 90 block
    rows)."""
    rng = np.random.default_rng(seed)
    if kind == "zero":
        dense = np.zeros((37, 29), np.float32)
    elif kind == "band":
        n = 90 * block + 3
        dense = np.zeros((n, n), np.float32)
        for r in range(n):
            lo = max(0, r - block - 2)
            dense[r, lo:r + block + 2] = rng.normal(size=len(range(
                lo, min(n, r + block + 2))))
    else:
        dense = ragged_dense(rng)
        if kind == "empty_rows":
            dense[8:40] = 0.0
            dense[70:] = 0.0
    tm = TT.csr_from_dense(dense, pad=8, device="cpu")
    tm = dataclasses.replace(tm, data=tm.data.to(TDT[data_dtype]))
    return TT.host_csr_to_bcsr(tm, block=block)


def assert_k10_close(m, x, got):
    """K10 against its plain version on the CPU, within 1e-4 of the plain
    version on |data|, |x|."""
    from repro_torch.kernels import bcsr_spmv as K9
    args = (m.data, m.block_cols, m.indptr)
    want = K9.bcsr_spmm_plain(*args, x, m.n_rows)
    mag = K9.bcsr_spmm_plain(m.data.abs(), m.block_cols, m.indptr, x.abs(),
                             m.n_rows)
    assert_kernel_close(got, want, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", K10_PAIRS, ids="-".join)
@pytest.mark.parametrize("batch", [1, 5, 8, 15, 16, 17, 32, 128, 200])
@pytest.mark.parametrize("block", [3, 4, 8, 16])
def test_cuda_bcsr_spmm_matches_plain_at_every_block_and_batch(
        cuda, block, batch, pair):
    """K10 against its plain version at every b, B (200 walks two column
    tiles) and value-type pairing, on a ragged matrix, one with empty block
    rows and an all-zero one: as the wrapper routes it and, for b = 4, 8,
    16, in each kernel forced; one launch counted a call."""
    from repro_torch.kernels import bcsr_spmv as K9
    data_dtype, x_dtype = pair
    routes = [None] + ([True, False] if block in (4, 8, 16) else [])
    for kind in ("ragged", "empty_rows", "zero"):
        m = bcsr_case(kind, block, 90 + block, data_dtype)
        x = torch.from_numpy(np.random.default_rng(91).normal(
            size=(m.n_cols, batch)).astype(np.float32)).to(TDT[x_dtype])
        args = [t.to(cuda) for t in (m.data, m.block_cols, m.indptr)]
        for mma in routes:
            before = K9.bcsr_spmm.launches
            got = K9.bcsr_spmm(*args, x.to(cuda), m.n_rows, mma=mma)
            torch.cuda.synchronize()
            assert K9.bcsr_spmm.launches == before + 1
            assert_k10_close(m, x, got)
            if kind == "zero":
                assert not got.any()


def tf32_probe(shape, rng):
    """Positive values 1 + 2^-12 (1 + r / 2), r in [0, 1): rounded to TF32
    (10 bits) they are 1, so a single TF32 product is off by ~2^-12 of
    |a.x| in the same direction for every term — more than 1e-4 of the sum
    of |a.x|."""
    return (1.0 + 2.0 ** -12 * (1.0 + 0.5 * rng.random(shape))).astype(
        np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", K10_PAIRS[:3], ids="-".join)
@pytest.mark.parametrize("block", [4, 8, 16])
def test_cuda_bcsr_spmm_keeps_float32_digits_on_the_tensor_cores(
        cuda, block, pair):
    """The 3xTF32 probe: values whose bits below TF32's tenth matter, in
    every pairing with a float32 operand, held to 1e-4 of sum |a.x| (a
    single TF32 product misses it: tests/test_torch_bcsr_mma.py)."""
    from repro_torch.kernels import bcsr_spmv as K9
    data_dtype, x_dtype = pair
    rng = np.random.default_rng(92)
    dense = (rng.random((150, 140)) < 0.3) * tf32_probe((150, 140), rng)
    tm = TT.csr_from_dense(dense.astype(np.float32), pad=8, device="cpu")
    tm = dataclasses.replace(tm, data=tm.data.to(TDT[data_dtype]))
    m = TT.host_csr_to_bcsr(tm, block=block)
    for batch in (16, 32, 128):
        x = torch.from_numpy(tf32_probe((140, batch), rng)).to(TDT[x_dtype])
        got = K9.bcsr_spmm(*[t.to(cuda) for t in (m.data, m.block_cols,
                                                  m.indptr)],
                           x.to(cuda), m.n_rows, mma=True)
        torch.cuda.synchronize()
        assert_k10_close(m, x, got)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [16, 32, 128, 200])
@pytest.mark.parametrize("block", [4, 8, 16])
def test_cuda_bcsr_spmm_ring_matches_plain(cuda, block, batch):
    """On a band (three blocks a block row: bfloat16 x bfloat16 at b = 8
    pairs two and takes the third alone) the tensor-core kernel matches the
    plain version at other block rows a CUDA block and column tiles, X
    aligned (bulk copies) and at an odd address (plain loads), float32 and
    bfloat16; two launches give the same bits."""
    from repro_torch.kernels import bcsr_spmv as K9
    for dtype in ("float32", "bfloat16"):
        m = bcsr_case("band", block, 93, dtype)
        x = torch.from_numpy(np.random.default_rng(94).normal(
            size=(m.n_cols, batch)).astype(np.float32)).to(TDT[dtype])
        moved = torch.empty(m.n_cols * batch + 1, dtype=TDT[dtype],
                            device=cuda)[1:].view(m.n_cols, batch)
        moved.copy_(x)
        args = [t.to(cuda) for t in (m.data, m.block_cols, m.indptr)]
        for X in (x.to(cuda), moved):
            for kw in (dict(), dict(block_rows=1), dict(block_rows=3),
                       dict(block_rows=16), dict(block_k=16)):
                kw["mma"] = True
                before = K9.bcsr_spmm.launches
                got = K9.bcsr_spmm(*args, X, m.n_rows, **kw)
                again = K9.bcsr_spmm(*args, X, m.n_rows, **kw)
                torch.cuda.synchronize()
                assert K9.bcsr_spmm.launches == before + 2
                assert torch.equal(got, again), kw
                assert_k10_close(m, x, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bound_bcsr_matches_plain(cuda, dtype):
    """A bound BCSR matrix through ``ops.spmm_bcsr`` (``ops.prepare`` passes
    it through: K10 keeps nothing beside it), a band and a scattered one, at
    the tiles of both kernels, is the kernel's result in the product's
    value type, and that matches the plain version."""
    from repro_torch.kernels import bcsr_spmv as K9
    from repro_torch.kernels import ops as T_ops
    band = bcsr_case("band", 8, 95, dtype)
    rng = np.random.default_rng(96)
    scattered = ((rng.random((400, 400)) < 0.01)
                 * rng.normal(size=(400, 400))).astype(np.float32)
    tm = TT.csr_from_dense(scattered, pad=8, device="cpu")
    sm = TT.host_csr_to_bcsr(dataclasses.replace(
        tm, data=tm.data.to(TDT[dtype])))
    for m in (band, sm):
        bound = m.to(cuda)
        assert T_ops.prepare(bound) is bound
        for batch in (32, 64, 128):
            x = torch.from_numpy(np.random.default_rng(97).normal(
                size=(m.n_cols, batch)).astype(np.float32)).to(TDT[dtype])
            got = T_ops.spmm_bcsr(bound, x.to(cuda))
            raw = K9.bcsr_spmm(bound.data, bound.block_cols, bound.indptr,
                               x.to(cuda), bound.n_rows)
            torch.cuda.synchronize()
            assert torch.equal(got, raw.to(got.dtype))
            assert_k10_close(m, x, raw)


# ---------------------------------------------------------------------------
# K11: masked slots skipped, one rescale a tile, codes through a ring
# ---------------------------------------------------------------------------
def k11_cache(kind, rng, B, S, KV, G, Dh, q_dtype):
    """K11 inputs (``k11_inputs``) with the cache of one kind and the
    window it is read with: ``prefix`` (valid prefixes), ``ring`` (a full
    ring: key_pos from ``models/attention.py``'s formula at positions past
    the slots), ``ring_window`` (the same read through a window shorter than
    the ring), ``last_slot`` (rows whose only valid slot is the last),
    ``masked_row`` (a row with no valid slot beside valid ones)."""
    args = k11_inputs(rng, B, S, KV, G, Dh, q_dtype)
    window = None
    if kind in ("ring", "ring_window"):
        pos = rng.integers(S, 4 * S, size=B).astype(np.int64)
        idx = np.arange(S)
        args[5] = torch.from_numpy((pos[:, None] - (
            (pos[:, None] - idx[None, :]) % S)).astype(np.int32))
        args[6] = torch.from_numpy(pos.astype(np.int32))
        window = S // 3 if kind == "ring_window" else None
    elif kind == "last_slot":
        args[5][:] = -1
        args[5][:, -1] = args[6]
    elif kind == "masked_row":
        args[5][1] = -1
    return args, window


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [3, 20, 700, 5000])
@pytest.mark.parametrize("kind", ["prefix", "ring", "ring_window",
                                  "last_slot", "masked_row"])
def test_cuda_decode_attention_int8_every_cache(cuda, kind, S, q_dtype):
    """K11 against its plain version on every kind of cache the server
    holds, with fewer slots than one tile (3, 20) and more than one split's
    (5000); one launch counted a call."""
    from repro_torch.kernels import decode_attention as K11
    rng = np.random.default_rng(98)
    args, window = k11_cache(kind, rng, 3, S, 2, 2, 64, q_dtype)
    before = TK.launch_counts()["decode_attention_int8"]
    got = K11.decode_attention_int8(*[a.to(cuda) for a in args],
                                    window=window)
    torch.cuda.synchronize()
    assert TK.launch_counts()["decode_attention_int8"] == before + 1
    assert bool(torch.isfinite(got).all())
    assert_k11_close(got, K11.decode_attention_int8_plain(*args,
                                                          window=window),
                     q_dtype)


def k11_oracle(args, softcap=0.0):
    """The masked (capped) softmax attention over the same dequantized
    inputs, in float64 on the host."""
    q, k_q, k_s, v_q, v_s, key_pos, q_pos = [a.cpu() for a in args]
    k = k_q.double() * k_s.double()[..., None]
    v = v_q.double() * v_s.double()[..., None]
    s = torch.einsum("bkgd,bskd->bkgs", q.double(), k) / \
        float(np.sqrt(q.shape[-1]))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    valid = (key_pos >= 0) & (key_pos <= q_pos[:, None])
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, v)


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 2.0])
@pytest.mark.parametrize("G", [1, 2, 3, 5, 6])
@pytest.mark.parametrize("Dh", [16, 64, 80, 128, 256, 512])
def test_cuda_decode_attention_int8_every_head_and_group(cuda, Dh, G,
                                                         softcap):
    """K11 at every head width (16 to 512, 80 not a power of two) and every
    group the configs use, with the logit softcap on and off, float32 and
    bfloat16 q; q scaled by 4, so that scores of several units sharpen the
    softmax and the cap bends them.  float32 q: against the plain version
    (the reference's 2e-4).  bfloat16 q: against a float64 oracle of the
    same dequantized inputs, one bfloat16 ulp of the larger value plus
    1e-6: the plain version's own float32 sums may miss that rule by more
    than the kernel does (at Dh 512, G 3 they do;
    ``experiments/torch_k11_accuracy.py`` prints both)."""
    from repro_torch.kernels import decode_attention as K11
    for q_dtype in ("float32", "bfloat16"):
        args = k11_inputs(np.random.default_rng(99), 2, 300, 2, G, Dh,
                          q_dtype)
        args[0] = args[0] * 4
        got = K11.decode_attention_int8(*[a.to(cuda) for a in args],
                                        softcap=softcap)
        torch.cuda.synchronize()
        want = (K11.decode_attention_int8_plain(*args, softcap=softcap)
                if q_dtype == "float32" else k11_oracle(args, softcap))
        assert_k11_close(got, want, q_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefix", "ring_window", "last_slot"])
def test_cuda_decode_attention_int8_reads_no_masked_slot(cuda, kind):
    """Scales of NaN in every masked slot of a row that has a valid one
    change nothing: the kernel reads neither their codes' scales nor, so,
    their codes (the plain version, which reads every slot, is run on the
    clean cache)."""
    from repro_torch.kernels import decode_attention as K11
    rng = np.random.default_rng(100)
    args, window = k11_cache(kind, rng, 3, 1500, 2, 2, 128, "bfloat16")
    key_pos, q_pos = args[5], args[6]
    valid = (key_pos >= 0) & (key_pos <= q_pos[:, None])
    if window is not None:
        valid &= key_pos > (q_pos[:, None] - window)
    assert bool(valid.any(dim=1).all()) and not bool(valid.all())
    dirty = list(args)
    for i in (2, 4):
        dirty[i] = torch.where(valid[:, :, None], args[i],
                               torch.full_like(args[i], float("nan")))
    got = K11.decode_attention_int8(*[a.to(cuda) for a in dirty],
                                    window=window)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert_k11_close(got, K11.decode_attention_int8_plain(*args,
                                                          window=window),
                     "bfloat16")


# ---------------------------------------------------------------------------
# the hybrid container: each block through its format's kernel
# ---------------------------------------------------------------------------
#: the kernel a block of each format launches, per op (SELL: once a bucket)
BLOCK_KERNEL = {"spmv": {"csr": "csr_spmv", "coo_row": "coo_spmv",
                         "coo_col": "coo_spmv", "ell_row": "ell_spmv",
                         "ell_col": "ell_spmv", "sell": "ell_spmv"},
                "spmm": {"csr": "csr_spmm", "coo_row": "coo_spmm",
                         "coo_col": "coo_spmm", "ell_row": "ell_spmm",
                         "ell_col": "ell_spmm", "sell": "ell_spmm"}}
HYBRID_SWEEP = {"fixed_256": ("fixed", {"block_rows": 256}),
                "fixed_1024": ("fixed", {"block_rows": 1024}),
                "balanced_8": ("balanced_nnz", {"n_blocks": 8}),
                "variance_16": ("variance", {"max_blocks": 16,
                                             "min_rows": 64})}


def expected_block_launches(hyb, op):
    want = {}
    for f, b in zip(hyb.formats, hyb.blocks):
        k = BLOCK_KERNEL[op][f]
        want[k] = want.get(k, 0) + (len(b.buckets) if f == "sell" else 1)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["spmv", "spmm"])
@pytest.mark.parametrize("sweep", sorted(HYBRID_SWEEP))
def test_cuda_hybrid_kernel_tier_matches_its_reference_tier(cuda, sweep, op,
                                                            dtype):
    """Each block launches its format's kernel (and nothing runs a plain
    version), the launches per kernel are those the blocks call for, and
    the reassembled product equals the reference tier's on the card."""
    from repro_torch.core.suite import synthesize_power_law
    from repro_torch.kernels import ops
    from repro_torch.partition import build_hybrid
    strategy, kw = HYBRID_SWEEP[sweep]
    csr = synthesize_power_law(n=3000, alpha=1.4, seed=5,
                               random_values=True, device="cpu")
    csr = dataclasses.replace(csr, data=csr.data.to(TDT[dtype]))
    hyb, _ = build_hybrid(csr, strategy=strategy, **kw)
    hyb = ops.prepare(hyb.to(cuda))
    rng = np.random.default_rng(7)
    shape = (3000,) if op == "spmv" else (3000, 128)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    before = TK.launch_counts()
    got = TD.dispatch(hyb, x, op=op, tier="kernel")
    torch.cuda.synchronize()
    after = TK.launch_counts()
    risen = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert risen == expected_block_launches(hyb, op)
    want = TD.dispatch(hyb, x, op=op, tier="reference")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", sorted(HYBRID_SWEEP))
def test_cuda_hybrid_plan_binds_and_serves_on_the_card(cuda, sweep):
    """``Planner(tier="kernel").plan(csr, partition=...).bind(csr) @ x`` on
    the card: the container and each ELL panel's extents lie there, the
    product matches a float64 product within 1e-4 of sum |a x|."""
    from repro_torch.core.plan import Planner
    from repro_torch.core.suite import synthesize_power_law
    from repro_torch.kernels import ops
    strategy, kw = HYBRID_SWEEP[sweep]
    csr = synthesize_power_law(n=3000, alpha=1.4, seed=6,
                               random_values=True, device=cuda)
    P = Planner(tier="kernel", device=cuda).plan(
        csr, partition=strategy, batch=8, **kw).bind(csr, device=cuda)
    assert P.matrix.device.type == "cuda" and P.tiers["spmv"] == "kernel"
    for f, b in zip(P.matrix.formats, P.matrix.blocks):
        for p in (b.buckets if f == "sell" else
                  (b,) if f.startswith("ell") else ()):
            assert ops.ell_extent_of(p).is_cuda
    dense = torch.from_numpy(csr.to("cpu").todense()).double()
    rng = np.random.default_rng(8)
    for shape in ((3000,), (3000, 8)):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        got = (P @ x.to(cuda)).double().cpu()
        want = dense @ x.double()
        scale = dense.abs() @ x.double().abs()
        assert float(((got - want).abs() / (scale + 1e-30)).max()) <= 1e-4


def edit_first_pad(matrix, fmt, row, col, value):
    """Write ``(value, col)`` in place into ``row``'s first pad slot (slot
    1) of a bound ELL panel or of the SELL bucket holding ``row``."""
    if fmt == "sell":
        perm = matrix.perm.cpu().numpy()
        for off, b in zip(matrix.row_offsets, matrix.buckets):
            hit = np.nonzero(perm[off:off + b.n_rows] == row)[0]
            if hit.size:
                p, r = b, int(hit[0])
                break
    else:
        p, r = matrix, row
    data, cols = (p.data.t(), p.cols.t()) if p.order == "col" else \
        (p.data, p.cols)
    data[r, 1] = value
    cols[r, 1] = col
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["ell_row", "ell_col", "sell"])
def test_cuda_bound_panel_edited_in_place_reads_fresh_extents(cuda, fmt):
    """The kernel reads a bound panel edited in place (row 5 gains 3.0 at
    column 7 in its first pad slot) up to its new extents: y[5] = 30."""
    from repro_torch.core.plan import Planner
    from repro_torch.kernels import ops
    dense = np.eye(64, dtype=np.float32)
    dense[0, 8:16] = 2.0
    csr = TT.csr_from_dense(dense, pad=8, device=cuda)
    P = Planner(tier="kernel", rule="cost_model", device=cuda).plan(
        csr, fmt=fmt).bind(csr, device=cuda)
    p = edit_first_pad(P.matrix, fmt, row=5, col=7, value=3.0)
    assert ops._extent_read(p) is not None and ops._extent_read(p).is_cuda
    before = TK.launch_counts()["ell_spmv"]
    y = (P @ torch.arange(1, 65, dtype=torch.float32, device=cuda)).cpu()
    assert TK.launch_counts()["ell_spmv"] > before
    dense[5, 7] = 3.0
    assert float(y[5]) == 30.0
    np.testing.assert_allclose(y.numpy(), dense @ np.arange(1, 65), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the SpMV service on the card: the tuned rung through the blocks' kernels
# ---------------------------------------------------------------------------
def service_oracle_error(csr, x, got):
    """Worst |got - A x| over sum |a x| (float64 oracle), any rank."""
    dense = torch.from_numpy(csr.to("cpu").todense()).double()
    xd = x.double().cpu()
    want = dense @ xd
    scale = dense.abs() @ xd.abs()
    return float(((got.double().cpu() - want).abs()
                  / (scale + 1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", ["variance_16", "balanced_8"])
def test_cuda_service_serves_every_product_through_tuned_kernels(cuda,
                                                                 sweep,
                                                                 tmp_path):
    """``SpMVService(tuner=...)`` on the card: a kernel-tier plan, each
    direct product and each flush launching exactly the kernels its blocks
    call for, every answer from the tuned rung within 1e-4 of sum |a x|;
    a second service on the same store replays the plan with no tuning."""
    from repro_torch.core.kernel_tune import KernelTuner
    from repro_torch.core.plan_store import PlanStore
    from repro_torch.core.suite import synthesize_power_law
    from repro_torch.serve import SpMVService
    strategy, kw = HYBRID_SWEEP[sweep]
    csr = synthesize_power_law(n=3000, alpha=1.4, seed=9,
                               random_values=True, device="cpu")
    svc = SpMVService(tuner=KernelTuner(max_candidates=3), max_batch=8,
                      strategy=strategy, plan_store=PlanStore(str(tmp_path)))
    entry = svc.register("m", csr, measure_baseline=False, **kw)
    assert entry.plan.tier == "kernel" and entry.matrix.device.type == "cuda"
    hyb = entry.matrix
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=3000).astype(np.float32))
    X = torch.from_numpy(rng.normal(size=(3000, 8)).astype(np.float32))

    def launches(fn):
        before = TK.launch_counts()
        out = fn()
        after = TK.launch_counts()
        return out, {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}

    y, risen = launches(lambda: svc.spmv("m", x))
    assert risen == expected_block_launches(hyb, "spmv")
    assert service_oracle_error(csr, x, y) <= 1e-4
    Y, risen = launches(lambda: svc.spmm("m", X))
    assert risen == expected_block_launches(hyb, "spmm")
    assert service_oracle_error(csr, X, Y) <= 1e-4
    futs, risen = launches(lambda: [svc.submit("m", X[:, i % 8])
                                    for i in range(2 * 8 + 3)]
                           + [svc.flush("m")])
    per_flush = expected_block_launches(hyb, "spmm")
    assert risen == {k: 3 * v for k, v in per_flush.items()}
    for i, f in enumerate(futs[:-1]):
        assert service_oracle_error(csr, X[:, i % 8], f.result()) <= 1e-4
    for op in ("spmv", "spmm"):
        g = svc.stats()["m"]["guard"][op]
        assert set(k for k, v in g["served_by"].items() if v) == {"tuned"}
        assert g["fallback_calls"] == 0 and g["short_circuits"] == 0
    assert svc.stats()["m"]["compiled"] == 2     # one SpMV, one SpMM shape

    replay = SpMVService(tuner=KernelTuner(timer=lambda t, g: 1 / 0),
                         max_batch=8, strategy=strategy,
                         plan_store=PlanStore(str(tmp_path)))
    e2 = replay.register("m", csr, measure_baseline=False, **kw)
    assert e2.from_plan and e2.plan.tier == "kernel"
    _, risen = launches(lambda: replay.spmv("m", x))
    assert risen == expected_block_launches(e2.matrix, "spmv")


@pytest.mark.cuda
def test_cuda_service_armed_fault_ladder(cuda):
    """Faults armed on purpose: three ``kernel.raise`` open the breaker,
    calls then short-circuit to the reference rung on the card, a probe
    past the cooldown closes it, ``kernel.nan`` is answered by the
    reference rung; every answer meets the oracle, the ladder's counts are
    the armed counts, and the tuned rung serves again once cleared."""
    from repro_torch.core.kernel_tune import KernelTuner
    from repro_torch.core.suite import synthesize_power_law
    from repro_torch.obs import FakeClock
    from repro_torch.serve import SpMVService, faults
    csr = synthesize_power_law(n=2000, alpha=1.4, seed=11,
                               random_values=True, device="cpu")
    clk = FakeClock()
    svc = SpMVService(tuner=KernelTuner(max_candidates=2), clock=clk,
                      breaker_failures=3, breaker_cooldown_s=10.0)
    svc.register("m", csr, measure_baseline=False)
    x = torch.from_numpy(np.random.default_rng(12).normal(
        size=2000).astype(np.float32))
    faults.clear()
    try:
        faults.arm("kernel.raise", prob=1.0)
        for _ in range(3):
            assert service_oracle_error(csr, x, svc.spmv("m", x)) <= 1e-4
        g = svc.stats()["m"]["guard"]["spmv"]
        assert g["breaker"]["state"] == "open"
        assert faults.counts()["kernel.raise"]["fired"] == 3
        for _ in range(2):                       # short-circuited
            assert service_oracle_error(csr, x, svc.spmv("m", x)) <= 1e-4
        assert faults.counts()["kernel.raise"]["checked"] == 3
        faults.disarm("kernel.raise")
        clk.advance(10.0)                        # half-open probe
        assert service_oracle_error(csr, x, svc.spmv("m", x)) <= 1e-4
        g = svc.stats()["m"]["guard"]["spmv"]
        assert g["breaker"]["state"] == "closed"
        faults.arm("kernel.nan", prob=1.0)
        assert service_oracle_error(csr, x, svc.spmv("m", x)) <= 1e-4
        assert faults.counts()["kernel.nan"]["fired"] == 1
    finally:
        faults.clear()
    g = svc.stats()["m"]["guard"]["spmv"]
    assert g["failures"] == {"tuned/exception": 3, "tuned/non_finite": 1}
    assert g["short_circuits"] == 2
    assert g["served_by"] == {"tuned": 1, "reference": 6, "csr": 0}
    assert g["fallback_calls"] == 6
    before = TK.launch_counts()
    assert service_oracle_error(csr, x, svc.spmv("m", x)) <= 1e-4
    assert sum(TK.launch_counts().values()) > sum(before.values())
    assert svc.stats()["m"]["guard"]["spmv"]["served_by"]["tuned"] == 2


# ---------------------------------------------------------------------------
# streaming: deltas edit the served containers on the card
# ---------------------------------------------------------------------------
def stream_dense(seed, n_rows=400, n_cols=256):
    """Rows 2-14 long: several SELL buckets, the widest 16 slots."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n_rows, n_cols), np.float32)
    for i in range(n_rows):
        ln = int(rng.integers(2, 15))
        dense[i, rng.choice(n_cols, ln, replace=False)] = rng.normal(size=ln)
    return rng, dense


def same_tensors(a, b):
    """Two containers of one format, tensor by tensor, exactly."""
    from repro_torch.core.formats import to_numpy
    na, aa, ma = to_numpy(a)
    nb, ab, mb = to_numpy(b)
    assert (na, ma["shape"], ma["nnz"]) == (nb, mb["shape"], mb["nnz"])
    flat = (lambda d: [d["perm"]] + [v for bk in d["buckets"]
                                     for v in (bk["data"], bk["cols"])]) \
        if na == "sell" else (lambda d: [d[k] for k in sorted(d)])
    for u, v in zip(flat(aa), flat(ab)):
        np.testing.assert_array_equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["csr", "sell"])
def test_cuda_delta_edits_the_container_on_the_card(cuda, fmt):
    """A delta with duplicate updates (one stored entry twice, one absent
    entry twice), a twice-deleted entry and appended rows, applied to a
    bound container on the card: every tensor equals the same apply on
    the CPU (the CUDA stores of repeated indices are deduplicated first),
    the container stays on the card, and its kernel serves the oracle."""
    from repro_torch.core.plan import Planner
    from repro_torch.stream import DeltaBatch, StreamingPlannedMatrix
    rng, dense = stream_dense(71)
    ip = TT.csr_from_dense(dense, pad=8, device="cpu").indptr.numpy()
    cols = TT.csr_from_dense(dense, pad=8, device="cpu").cols.numpy()
    k = 37
    sr = int(np.searchsorted(ip, k, side="right") - 1)
    sc = int(cols[k])
    delta = DeltaBatch(
        n_cols=256, append_cols=(np.arange(30, dtype=np.int64),
                                 np.arange(5, dtype=np.int64)),
        append_vals=(np.ones(30, np.float32), np.full(5, 2, np.float32)),
        update_rows=np.asarray([sr, sr, 9, 9, sr, 40], np.int64),
        update_cols=np.asarray([sc, sc, 255, 255, sc, 200], np.int64),
        update_vals=np.asarray([1, 2, 3, 4, 5, 6], np.float32),
        delete_rows=np.asarray([sr, sr, 12], np.int64),
        delete_cols=np.asarray([sc, sc, 3], np.int64))
    out = {}
    for dev in ("cpu", cuda):
        csr = TT.csr_from_dense(dense, pad=8, device=dev)
        sm = StreamingPlannedMatrix(
            csr, Planner(tier="kernel", device=dev), plan_kw={"fmt": fmt})
        res = sm.apply(delta)
        assert not res.fallback and res.container.device.type == \
            torch.device(dev).type
        out[str(dev)] = (sm, res)
    (cpu_sm, cpu_res), (gpu_sm, gpu_res) = out["cpu"], out[str(cuda)]
    assert gpu_res.mode == cpu_res.mode == "splice"
    same_tensors(cpu_res.csr, gpu_res.csr)
    same_tensors(cpu_res.container, gpu_res.container)
    x = torch.from_numpy(rng.normal(size=256).astype(np.float32))
    before = sum(TK.launch_counts().values())
    y = (gpu_sm @ x.to(cuda)).cpu()
    assert sum(TK.launch_counts().values()) > before
    assert service_oracle_error(gpu_sm.csr, x, y) <= 1e-4


@pytest.mark.cuda
def test_cuda_sell_bucket_widened_by_a_delta_is_read_by_k1(cuda):
    """A row lengthened past the widest bucket widens it on the card; K1
    reads every bucket up to fresh extents (one launch a bucket) and
    matches its plain version and the oracle."""
    from repro_torch.core.plan import Planner
    from repro_torch.kernels import ops
    from repro_torch.kernels.ell_spmv import ell_extent, ell_spmv_plain
    from repro_torch.stream import DeltaBatch, StreamingPlannedMatrix
    rng, dense = stream_dense(73)
    csr = TT.csr_from_dense(dense, pad=8, device=cuda)
    sm = StreamingPlannedMatrix(csr, Planner(tier="kernel", device=cuda),
                                plan_kw={"fmt": "sell"})
    w0 = sm.bound.matrix.widths[0]
    row = int(sm.bound.matrix.perm[-1])        # in the narrowest bucket
    have = set(np.nonzero(dense[row])[0].tolist())
    new = [c for c in range(256) if c not in have][: w0 + 9]
    res = sm.apply(DeltaBatch(
        n_cols=256, update_rows=np.full(len(new), row, np.int64),
        update_cols=np.asarray(new, np.int64),
        update_vals=np.ones(len(new), np.float32)))
    sell = sm.bound.matrix
    assert not res.fallback and sell.widths[0] > w0
    x = torch.from_numpy(rng.normal(size=256).astype(np.float32)).to(cuda)
    before = TK.launch_counts()["ell_spmv"]
    y = sm @ x
    assert TK.launch_counts()["ell_spmv"] - before == len(sell.buckets)
    for off, b in zip(sell.row_offsets, sell.buckets):
        ext = ops.ell_extent_of(b)
        assert ext is not None and ext.is_cuda
        assert torch.equal(ext, ell_extent(b.data, b.cols))
        want = ell_spmv_plain(b.data, b.cols, x)
        got = y[sell.perm[off:off + b.n_rows].long()]
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert service_oracle_error(sm.csr, x.cpu(), y) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["csr", "sell"])
def test_cuda_a_delta_reads_back_only_delta_sized_arrays(cuda, fmt,
                                                         monkeypatch):
    """On the card a delta never copies the matrix to the host: every
    tensor read back during the apply is the size of the delta."""
    from repro_torch.core.plan import Planner
    from repro_torch.core.suite import synthesize_power_law
    from repro_torch.stream import StreamingPlannedMatrix, random_delta
    csr = synthesize_power_law(n=20000, alpha=1.6, seed=5,
                               random_values=True, device=cuda)
    sm = StreamingPlannedMatrix(csr, Planner(tier="kernel", device=cuda),
                                plan_kw={"fmt": fmt})
    delta = random_delta(np.random.default_rng(6), sm.csr, n_appends=8,
                         n_updates=64, n_deletes=16, row_len=12)
    seen = []
    real = torch.Tensor.cpu

    def cpu(self, *a, **kw):
        seen.append(self.numel())
        return real(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    res = sm.apply(delta)
    monkeypatch.undo()
    assert not res.fallback and res.container.device.type == "cuda"
    assert seen and max(seen) <= 2 * delta.nnz_delta < sm.csr.nnz // 100


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["row", "col"])
def test_cuda_sharded_dispatch_serves_through_the_kernels(cuda, axis):
    """``dispatch`` mode on one card: each shard's product launches its
    format's kernel (a SELL shard once a bucket), every shard on the
    tuned rung, SpMV and SpMM within 1e-4 of the oracle."""
    from repro_torch.core.plan import Planner
    from repro_torch.core.suite import synthesize_power_law
    csr = synthesize_power_law(n=6000, alpha=1.4, seed=8,
                               random_values=True, device=cuda)
    spm = Planner(tier="kernel", device=cuda).build_sharded(
        csr, n_shards=4, axis=axis)
    assert spm.mode == "dispatch"
    assert all(d.type == "cuda" for d in spm.devices)
    rng = np.random.default_rng(9)
    for batch in (1, 8):
        x = torch.from_numpy(rng.normal(
            size=(6000, batch) if batch > 1 else 6000).astype(np.float32))
        want = {}
        for pm in spm.planned:
            k = {"sell": "ell", "ell_row": "ell", "ell_col": "ell"}.get(
                pm.fmt, pm.fmt.split("_")[0])
            k += "_spmv" if batch == 1 else "_spmm"
            n = len(pm.matrix.buckets) if pm.fmt == "sell" else 1
            want[k] = want.get(k, 0) + n
        before = TK.launch_counts()
        y = spm @ x.to(cuda)
        after = TK.launch_counts()
        risen = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        assert risen == want
        assert y.is_cuda and service_oracle_error(csr, x, y) <= 1e-4
    for shard in spm.guard_report():
        assert shard["spmv"]["served_by"]["csr"] == 0
        assert shard["spmv"]["served_by"]["tuned"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["row", "col"])
def test_cuda_shard_map_slab_pads_are_never_read(cuda, axis):
    """A ``shard_map`` rank's slab, padded to the envelope (``nnz_pad >
    nnz`` and rows past its own), through K2 and K5 as the executor calls
    them: the pad entries lie past ``IRP[-1]``, so NaN written there is
    never read — each product is the plain version's on the unpadded
    slab, and the padded rows are zero."""
    from repro_torch.core import dispatch as TD_
    from repro_torch.core.formats import CSR as TCSR
    from repro_torch.core.suite import synthesize_power_law
    from repro_torch.kernels import ops
    from repro_torch.sharding.spmv import _envelope, _pad_slab, shard_csr
    csr = synthesize_power_law(n=6000, alpha=1.4, seed=8,
                               random_values=True, device="cpu")
    _, subs = shard_csr(csr, 4, axis=axis, strategy="balanced_nnz")
    rows_pad, nnz_pad, width_pad = _envelope(subs)
    rng = np.random.default_rng(10)
    assert sum(nnz_pad > m.nnz for m in subs) >= 3
    for m in subs:
        d, c, ip = _pad_slab(m, rows_pad, nnz_pad)
        d[m.nnz:] = float("nan")
        n_cols = m.n_cols if axis == "row" else width_pad
        local = ops.prepare(TCSR(data=d.to(cuda), cols=c.to(cuda),
                                 indptr=ip.to(cuda),
                                 shape=(rows_pad, n_cols), nnz=m.nnz))
        for batch in (1, 8, 64):
            x = torch.from_numpy(rng.normal(size=(n_cols, batch) if batch > 1
                                            else n_cols).astype(np.float32))
            op = "spmv" if batch == 1 else "spmm"
            before = TK.launch_counts()
            y = TD_.get_impl("csr", op, "kernel")(local, x.to(cuda))
            after = TK.launch_counts()
            assert after[f"csr_{op}"] == before[f"csr_{op}"] + 1
            want = TD_.get_impl("csr", op, "reference")(
                m, x[:m.n_cols])
            got = y.cpu()
            assert torch.isfinite(got).all()
            np.testing.assert_allclose(got[:m.n_rows].numpy(),
                                       want.numpy(), **TOL["float32"])
            assert not got[m.n_rows:].any()


# ---------------------------------------------------------------------------
# training: one step on the card against the same step on the host
# ---------------------------------------------------------------------------
def _leaf_paths(tree, path=""):
    """Each leaf's path (``layers/3/mamba/D``), in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _leaf_paths(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{path}/{i}")]
    return [path]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,loose", [
    ("qwen3-1.7b", {}), ("dbrx-132b", {}),
    ("zamba2-1.2b", {f"mamba/{k}": 4e-4 for k in ("D", "A_log", "dt_bias",
                                                   "norm")})])
def test_cuda_train_step_matches_the_cpu(cuda, arch, loose):
    """One training step of the smoke model (float32, TF32 off) from one set
    of float32 masters and one batch: the card's loss and every gradient
    leaf equal the host's within 1e-4 of the leaf's max |g| (cuBLAS and
    the CPU sum in other orders; zamba2's per-channel SSM leaves at 4e-4,
    as in test_torch_train_model.py), and AdamW on the card, given the
    host's gradients, gives the host's parameters.  (The whole step's
    parameters are not compared: Adam's first step is lr * sign(g), so a
    gradient within rounding of zero may step the other way.)"""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import tree_leaves, tree_map
    cfg = smoke_config(get_config(arch))
    params = TM.init(cfg, torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.float32)
    rng = np.random.default_rng(47)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
             for k in ("tokens", "labels")}
    p_card = tree_map(lambda t: t.to(cuda), params)
    loss_c, g_c = value_and_grad(params, batch, cfg)
    loss_g, g_g = value_and_grad(
        p_card, {k: v.to(cuda) for k, v in batch.items()}, cfg)
    assert float(loss_g) == pytest.approx(float(loss_c), rel=1e-5)
    for path, a, b in zip(_leaf_paths(params), g_g, g_c):
        rel = next((t for k, t in loose.items() if path.endswith("/" + k)),
                   1e-4)
        assert float((a.cpu() - b).abs().max()) <= \
            rel * float(b.abs().max()), path
    opt = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    it = iter(g_c)
    grads = tree_map(lambda _: next(it), params)
    want, _, n_c = adamw.update(opt, grads, adamw.init(params), params)
    got, _, n_g = adamw.update(opt, tree_map(lambda t: t.to(cuda), grads),
                               adamw.init(p_card), p_card)
    assert float(n_g) == pytest.approx(float(n_c), rel=1e-5)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cuda_checkpoint_restores_on_the_card(cuda, tmp_path):
    """A training state saved from the card's tensors (through the
    reference's layout) restores onto the card, leaf for leaf."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import (jax_spec, model as TM, opt_state_from_jax,
                                    opt_state_to_jax, params_from_jax,
                                    params_to_jax)
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import tree_leaves
    cfg = smoke_config(get_config("zamba2-1.2b"))
    params = TM.init(cfg, torch.Generator(device=cuda).manual_seed(1),
                     device=cuda, dtype=torch.float32)
    state = adamw.init(params)
    save(str(tmp_path), 3, {"params": params_to_jax(params, cfg),
                            "opt": opt_state_to_jax(state, cfg)})
    spec = jax_spec(cfg)
    tree, _ = restore(str(tmp_path), 3, {
        "params": spec, "opt": adamw.AdamWState(
            step=np.zeros((), np.int32), m=spec, v=spec)},
        verify=True, device=cuda)
    got = params_from_jax(tree["params"], cfg, device=cuda,
                          dtype=torch.float32)
    opt = opt_state_from_jax(tree["opt"], cfg, device=cuda)
    for a, b in zip(tree_leaves(got), tree_leaves(params)):
        assert a.device.type == "cuda" and torch.equal(a, b)
    assert opt.step.device.type == "cuda" and int(opt.step) == 0
