"""Port vs reference: K10's tensor-core BCSR SpMM — the host-side rules that
route and shape its launch, and its order of operations (3xTF32 block
products; bfloat16 products of two blocks a step) emulated in numpy against
the JAX package's Pallas kernel in interpret mode.

The kernel itself runs only on the card (``test_torch_cuda.py``, the
``cuda``-marked tests); here its arithmetic is emulated: each operand split
into TF32 parts hi = rna(v) and lo = rna(v - hi), each block product taken
as lo.hi + hi.lo + hi.hi.  Tolerance, relative to ``sum_k |a_rk * x_k|`` of
each output element: 1e-4, the kernel's own against its plain version.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import transform as RT
from repro.kernels import ops as R_ops
from repro_torch.core import transform as TT
from repro_torch.kernels import _common as C
from repro_torch.kernels import bcsr_spmv as K9

TOL = 1e-4


def tf32(a):
    """float32 values rounded to TF32 (10 mantissa bits), to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32``."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_cut(a):
    """float32 values cut to TF32 (their 13 low mantissa bits cleared), as
    the kernel splits an operand and the tensor core reads one."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def emulated_spmm(data, block_cols, indptr, x, n_rows, split=(True, True)):
    """The tensor-core kernel's arithmetic on numpy arrays: every stored
    block's product from TF32 parts — hi = v cut to TF32, lo = v - hi as
    the tensor core reads it (cut too) — lo.hi + hi.lo + hi.hi for the
    operands that are float32 (``split``: data, x; a False operand is exact
    in TF32, as bfloat16 is), or rna(v) products alone with ``split=None``
    (a single TF32 product); float32 sums."""
    b = data.shape[1]
    nbr = indptr.shape[0] - 1
    n_cols, batch = x.shape
    xp = np.zeros((-(-n_cols // b) * b, batch), np.float32)
    xp[:n_cols] = x
    xb = xp.reshape(-1, b, batch)[block_cols[:indptr[-1]]]
    d = data[:indptr[-1]].astype(np.float32)
    if split is None:
        terms = [(tf32(d), tf32(xb))]
    else:
        dh, xh = tf32_cut(d), tf32_cut(xb)
        terms = [(dh, xh)]
        if split[0]:
            terms.insert(0, (tf32_cut(d - dh), xh))
        if split[1]:
            terms.insert(0, (dh, tf32_cut(xb - xh)))
    tiles = np.zeros(xb.shape[:1] + (b, batch), np.float32)
    for dd, xx in terms:      # the small terms first
        tiles += np.einsum("pij,pjc->pic", dd.astype(np.float64),
                           xx.astype(np.float64)).astype(np.float32)
    y = np.zeros((nbr, b, batch), np.float64)
    rows = np.repeat(np.arange(nbr), np.diff(indptr))
    np.add.at(y, rows, tiles)
    return y.reshape(nbr * b, batch)[:n_rows].astype(np.float32)


def probe(shape, rng):
    """Positive values 1 + 2^-12 (1 + r / 2): their TF32 parts are 1 and
    ~2^-12, so a single TF32 product errs by ~2^-12 of every term, one way."""
    return (1.0 + 2.0 ** -12 * (1.0 + 0.5 * rng.random(shape))).astype(
        np.float32)


def both_bcsr(dense, block=8):
    rm = RT.host_csr_to_bcsr(RT.csr_from_dense(dense, pad=8), block=block)
    tm = TT.host_csr_to_bcsr(TT.csr_from_dense(dense, pad=8, device="cpu"),
                             block=block)
    return rm, tm


def rel_err(got, want, mag):
    return float((np.abs(got.astype(np.float64) - want) /
                  (mag + 1e-30)).max())


@pytest.mark.parametrize("block", [4, 8, 16])
@pytest.mark.parametrize("kind", ["random", "probe"])
def test_three_tf32_products_match_the_jax_kernel(kind, block):
    """The kernel's order of operations, emulated, against the reference's
    Pallas kernel in interpret mode: within 1e-4 of sum |a.x| on random
    values and on the probe, where a single TF32 product is not."""
    rng = np.random.default_rng(60 + block)
    mask = rng.random((90, 70)) < 0.3
    if kind == "probe":
        dense = mask * probe((90, 70), rng)
        x = probe((70, 24), rng)
    else:
        dense = mask * rng.normal(size=(90, 70))
        x = rng.normal(size=(70, 24))
    dense, x = dense.astype(np.float32), x.astype(np.float32)
    rm, tm = both_bcsr(dense, block)
    want = np.asarray(R_ops.spmm_bcsr(rm, jnp.asarray(x), interpret=True),
                      np.float64)
    mag = np.abs(dense).astype(np.float64) @ np.abs(x).astype(np.float64)
    arrays = (tm.data.numpy(), tm.block_cols.numpy(), tm.indptr.numpy())
    got = emulated_spmm(*arrays, x, tm.n_rows)
    assert rel_err(got, want, mag) <= TOL
    single = emulated_spmm(*arrays, x, tm.n_rows, split=None)
    if kind == "probe":
        assert rel_err(single, want, mag) > TOL
    # a bfloat16 operand is exact in TF32: the mixed pairs split the other;
    # bfloat16 x bfloat16 is one exact product (m16n8k16)
    for dd, xd, split in (("bfloat16", "float32", (False, True)),
                          ("float32", "bfloat16", (True, False)),
                          ("bfloat16", "bfloat16", (False, False))):
        d_t = tm.data.to(getattr(torch, dd)).float().numpy()
        x_t = torch.from_numpy(x).to(getattr(torch, xd)).float().numpy()
        rmd = dataclasses.replace(rm, data=jnp.asarray(d_t))
        want = np.asarray(R_ops.spmm_bcsr(rmd, jnp.asarray(x_t),
                                          interpret=True), np.float64)
        got = emulated_spmm(d_t, arrays[1], arrays[2], x_t, tm.n_rows,
                            split=split)
        assert rel_err(got, want, mag) <= TOL


@pytest.mark.parametrize("batch,block,block_k,mma", [
    (1, 8, None, False), (8, 8, None, False), (15, 8, None, False),
    (16, 8, None, False), (17, 8, None, False), (32, 8, None, False),
    (63, 8, None, False), (64, 8, None, True), (128, 8, None, True),
    (200, 8, None, True), (128, 8, 8, False), (128, 8, 32, False),
    (128, 8, 64, True), (128, 4, None, True), (128, 16, None, True),
    (128, 3, None, False), (128, 2, None, False), (128, 12, None, False)])
def test_bcsr_spmm_routes_narrow_tiles_to_the_lane_groups(batch, block,
                                                          block_k, mma):
    """The tensor-core kernel takes b = 4, 8, 16 at a column tile of 64 or
    more (at B = 32 and below the first port's lane groups were faster on
    the card); any other b, and narrower tiles, run the lane groups."""
    assert C.BCSR_MMA_MIN_COLS == 64
    assert C.bcsr_spmm_mma(batch, block, block_k) is mma


@pytest.mark.parametrize("batch", [1, 16, 17, 40, 128, 200])
@pytest.mark.parametrize("block", [4, 8, 16])
@pytest.mark.parametrize("block_rows", [None, 1, 3, 8, 20, 1000])
@pytest.mark.parametrize("sizes", [(4, 4), (2, 4), (4, 2), (2, 2)])
def test_bcsr_spmm_launch_fits_and_hits_every_bank(batch, block, block_rows,
                                                   sizes):
    """Each launch ``bcsr_spmm_launch`` makes is one the C entry point
    takes: whole warps up to 256 threads, at most one a block row, at least
    one slice a warp and at most 32, all in an SM's shared memory; slice
    rows hold the tile rounded to 16 values in a 16-byte multiple whose
    pitch is 8 words mod 32 for float32 X (the mma fragment loads of 4 rows
    hit 32 banks) and 4 for bfloat16 (``ldmatrix`` reads 8 rows of 16
    bytes, and the fragment loads of 4 rows of 2-byte values)."""
    x_size, d_size = sizes
    kt, threads, rows, slots, stride = C.bcsr_spmm_launch(
        batch, block, block_rows, None, x_size, d_size)
    assert kt == C.rhs_tile(batch)[0]
    assert rows == (block_rows or C.BCSR_MMA_ROWS)
    warps = threads // 32
    assert threads % 32 == 0 and 1 <= warps <= min(rows, C.BCSR_MMA_WARPS)
    assert warps <= slots <= C.BCSR_MMA_MAX_SLOTS
    assert stride % 16 == 0 and stride >= -(-kt // 16) * 16 * x_size
    assert (stride // 4) % 32 == 2 * x_size
    assert slots * (block * stride + block * block * d_size) <= \
        C.SMEM_BLOCK_MAX
