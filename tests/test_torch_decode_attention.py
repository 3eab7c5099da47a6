"""Port vs reference: the fused int8-KV decode attention (K11) and the
int8 KV quantizer.

The same numpy inputs go through the JAX package — its Pallas kernel in
interpret mode and its oracle ``repro.kernels.ref.decode_attention_int8_ref``,
as ``tests/test_kernels.py`` runs them — and through the port, whose wrapper
runs the kernel's plain PyTorch version on CPU tensors (the CUDA kernel is
held against that plain version on the card, ``test_torch_cuda.py`` and
``chip_smoke.py``).

Tolerance: rtol = atol = 2e-4, the reference's own for this kernel — both
sides compute in float32 and differ only in the order of the sums.  With
bfloat16 q the outputs are rounded to bfloat16 from float32 values that
differ in that order only, so they may be one bfloat16 ulp apart (near zero,
where the sums cancel, by the float32 error of ~1e-7 too).
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ref as R_ref
from repro.kernels.decode_attention import decode_attention_int8 as R_k11
from repro.models.attention import _dequantize_kv as R_deq
from repro.models.attention import decode_attention as R_decode
from repro.models.attention import _quantize_kv as R_quant
from repro_torch import kernels as TK
from repro_torch.kernels import _common as C
from repro_torch.kernels import decode_attention as K11
from repro_torch.models.attention import _dequantize_kv, _quantize_kv

TOL = dict(rtol=2e-4, atol=2e-4)
#: the shapes of tests/test_kernels.py::test_decode_attention_int8_kernel
SHAPES = [
    (2, 512, 2, 3, 64, None),     # one chunk exactly
    (1, 1024, 4, 1, 128, None),   # multi-chunk
    (3, 640, 2, 2, 32, 256),      # ragged chunks + sliding window
    (2, 512, 1, 6, 64, 128),      # MQA grouping + window
]


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def bf16_close(got, want):
    """Within one bfloat16 ulp (8 bits of precision) of the larger of the
    two, plus 1e-6 for the float32 sums' own error, which near zero (a mean
    of +-v over many slots cancels) exceeds one ulp of the value."""
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                     np.finfo(np.float32).tiny)
    return np.all(np.abs(got - want) <= 2.0 ** (np.floor(np.log2(mag)) - 7)
                  + 1e-6)


def inputs(seed, B, S, KV, G, Dh):
    """The reference test's inputs: random codes, scales in [0, 0.02),
    each sequence filled to a random length in [S/2, S)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, KV, G, Dh)).astype(np.float32)
    k_q = rng.integers(-127, 128, (B, S, KV, Dh)).astype(np.int8)
    v_q = rng.integers(-127, 128, (B, S, KV, Dh)).astype(np.int8)
    k_s = (rng.random((B, S, KV)) * 0.02).astype(np.float32)
    v_s = (rng.random((B, S, KV)) * 0.02).astype(np.float32)
    lens = rng.integers(S // 2, S, size=B)
    key_pos = np.where(np.arange(S)[None, :] < lens[:, None],
                       np.arange(S)[None, :], -1).astype(np.int32)
    q_pos = (lens - 1).astype(np.int32)
    return q, k_q, k_s, v_q, v_s, key_pos, q_pos


def port(*arrays, q_dtype=torch.float32, s_dtype=torch.float32):
    q, k_q, k_s, v_q, v_s, key_pos, q_pos = (torch.from_numpy(a)
                                             for a in arrays)
    return (q.to(q_dtype), k_q, k_s.to(s_dtype), v_q, v_s.to(s_dtype),
            key_pos, q_pos)


def jax_kernel(q, k_q, k_s, v_q, v_s, key_pos, q_pos, window, s_chunk=512):
    """The reference kernel in interpret mode, padded to its chunk with
    empty slots as its own test does."""
    S = k_q.shape[1]
    pad = (-S) % min(s_chunk, S)

    def padz(a, fill=0):
        return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2),
                      constant_values=fill)
    return R_k11(jnp.asarray(q), jnp.asarray(padz(k_q)),
                 jnp.asarray(padz(k_s)), jnp.asarray(padz(v_q)),
                 jnp.asarray(padz(v_s)), jnp.asarray(padz(key_pos, -1)),
                 jnp.asarray(q_pos), window=window, s_chunk=s_chunk,
                 interpret=True)


@pytest.mark.parametrize("B,S,KV,G,Dh,window", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(B, S, KV, G, Dh, window):
    arrays = inputs(0, B, S, KV, G, Dh)
    want_k = jax_kernel(*arrays, window)
    want_r = R_ref.decode_attention_int8_ref(*map(jnp.asarray, arrays),
                                             window=window)
    got = K11.decode_attention_int8_plain(*port(*arrays), window=window)
    assert got.shape == (B, KV, G, Dh) and got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want_k), **TOL)
    np.testing.assert_allclose(f32(got), f32(want_r), **TOL)


@pytest.mark.parametrize("B,S,KV,G,Dh,window", SHAPES)
def test_wrapper_on_cpu_runs_the_plain_version(B, S, KV, G, Dh, window):
    arrays = inputs(1, B, S, KV, G, Dh)
    before = TK.launch_counts()["decode_attention_int8"]
    got = K11.decode_attention_int8(*port(*arrays), window=window)
    assert TK.launch_counts()["decode_attention_int8"] == before
    want = K11.decode_attention_int8_plain(*port(*arrays), window=window)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,S,KV,G,Dh,window", SHAPES)
def test_bf16_q_and_scales_within_one_ulp_of_oracle(B, S, KV, G, Dh, window):
    arrays = list(inputs(2, B, S, KV, G, Dh))
    # the cache layout's bf16 scales, the model's bf16 queries
    t = port(*arrays, q_dtype=torch.bfloat16, s_dtype=torch.bfloat16)
    got = K11.decode_attention_int8_plain(*t, window=window)
    assert got.dtype == torch.bfloat16
    j = [jnp.asarray(a) for a in arrays]
    for i in (0, 2, 4):
        j[i] = j[i].astype(jnp.bfloat16)
    want = f32(R_ref.decode_attention_int8_ref(*j, window=window))
    assert bf16_close(f32(got), want)


@pytest.mark.parametrize("softcap", [1.5, 30.0])
@pytest.mark.parametrize("B,S,KV,G,Dh,window", SHAPES)
def test_plain_with_softcap_matches_reference_decode(B, S, KV, G, Dh, window,
                                                     softcap):
    """With a logit softcap the reference's int8 decode dequantizes the
    cache and calls ``decode_attention(..., softcap=...)``
    (``repro/models/attention.py``); K11's plain version caps the scores in
    the same place, before the mask.  q is scaled so that scores reach
    several units and a cap of 1.5 bends them all."""
    arrays = list(inputs(8, B, S, KV, G, Dh))
    arrays[0] = arrays[0] * 40.0
    q, k_q, k_s, v_q, v_s, key_pos, q_pos = map(jnp.asarray, arrays)
    want = R_decode(q[:, None], R_deq(k_q, k_s), R_deq(v_q, v_s), key_pos,
                    q_pos, window=window, softcap=softcap)[:, 0]
    got = K11.decode_attention_int8_plain(*port(*arrays), window=window,
                                          softcap=softcap)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    same = K11.decode_attention_int8(*port(*arrays), window=window,
                                     softcap=softcap)
    assert torch.equal(same, got)
    if softcap < 2:
        uncapped = K11.decode_attention_int8_plain(*port(*arrays),
                                                   window=window)
        assert np.abs(f32(uncapped) - f32(got)).max() > 100 * TOL["atol"]


def test_plain_matches_model_decode_case():
    """tests/test_kernels.py::test_decode_attention_int8_matches_model_decode
    on the port: the model's quantizer feeds the kernel."""
    rng = np.random.default_rng(3)
    B, S, KV, G, Dh = 2, 512, 2, 2, 32
    k = rng.normal(size=(B, S, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, Dh)).astype(np.float32)
    q = rng.normal(size=(B, KV, G, Dh)).astype(np.float32)
    key_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    q_pos = np.asarray([S - 1, S // 2], np.int32)
    rk, rks = R_quant(jnp.asarray(k))
    rv, rvs = R_quant(jnp.asarray(v))
    want_k = R_k11(jnp.asarray(q), rk, rks, rv, rvs, jnp.asarray(key_pos),
                   jnp.asarray(q_pos), interpret=True)
    want_r = R_ref.decode_attention_int8_ref(jnp.asarray(q), rk, rks, rv, rvs,
                                             jnp.asarray(key_pos),
                                             jnp.asarray(q_pos))
    tk, tks = _quantize_kv(torch.from_numpy(k))
    tv, tvs = _quantize_kv(torch.from_numpy(v))
    got = K11.decode_attention_int8(torch.from_numpy(q), tk, tks, tv, tvs,
                                    torch.from_numpy(key_pos),
                                    torch.from_numpy(q_pos))
    np.testing.assert_allclose(f32(got), f32(want_k), **TOL)
    np.testing.assert_allclose(f32(got), f32(want_r), **TOL)


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------
def _ties():
    """Rows whose amax is 127 (scale exactly 1.0), so x / scale hits the
    halves exactly: round half to even decides them."""
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                    3.5, 4.5, -3.5, 0.0, -0.0, 64.5, -64.5], np.float32)
    return np.stack([row, -row, row[::-1]])


@pytest.mark.parametrize("case", ["normal", "ties", "wide", "zero_rows",
                                  "bf16"])
def test_quantize_kv_codes_and_scales_bit_for_bit(case):
    rng = np.random.default_rng(4)
    x = {"normal": lambda: rng.normal(size=(3, 7, 2, 32)),
         "ties": _ties,
         "wide": lambda: rng.normal(size=(2, 5, 64)) * 10.0 ** rng.integers(
             -8, 8, size=(2, 5, 1)),
         "zero_rows": lambda: np.concatenate(
             [np.zeros((2, 16)), 1e-9 * rng.normal(size=(2, 16)),
              rng.normal(size=(2, 16))]),
         "bf16": lambda: rng.normal(size=(4, 3, 16))}[case]()
    x = np.asarray(x, np.float32)
    if case == "bf16":
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    rq, rs = R_quant(jx)
    tq, ts = _quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(f32(ts), f32(rs))
    np.testing.assert_array_equal(f32(_dequantize_kv(tq, ts)),
                                  f32(R_deq(rq, rs)))
    if case == "ties":    # half to even, not half away from zero
        np.testing.assert_array_equal(
            tq.numpy()[0, :8], [127, 0, 2, 2, 0, -2, -2, 126])


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 4])
def test_fully_masked_row_gives_the_oracles_mean_of_v(window):
    """A row with no valid slot (empty cache, or q_pos before every key)
    weights every slot equally: the mean of V over all slots, finite."""
    arrays = list(inputs(5, 3, 96, 2, 2, 32))
    arrays[5][1] = -1                 # sequence 1: an empty cache
    arrays[6][2] = -1                 # sequence 2: q_pos before every key
    got = K11.decode_attention_int8(*port(*arrays), window=window)
    want = R_ref.decode_attention_int8_ref(*map(jnp.asarray, arrays),
                                           window=window)
    assert np.isfinite(f32(got)).all()
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    v = arrays[3].astype(np.float32) * arrays[4][..., None]
    mean_v = v.mean(axis=1)                       # (B, KV, Dh)
    for b in (1, 2):
        for g in range(2):
            np.testing.assert_allclose(f32(got)[b, :, g], mean_v[b], **TOL)


def test_window_masks_old_keys():
    """With a window, only the last ``window`` positions up to q_pos count:
    equal to the same query against a cache holding only those keys."""
    B, S, KV, G, Dh, W = 2, 128, 2, 2, 16, 10
    arrays = list(inputs(6, B, S, KV, G, Dh))
    arrays[5] = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    arrays[6] = np.array([100, 57], np.int32)
    got = K11.decode_attention_int8(*port(*arrays), window=W)
    cut = list(arrays)
    keep = (arrays[5] > arrays[6][:, None] - W) & \
        (arrays[5] <= arrays[6][:, None])
    cut[5] = np.where(keep, arrays[5], -1).astype(np.int32)
    want = K11.decode_attention_int8(*port(*cut))
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


# ---------------------------------------------------------------------------
# the wrapper's checks and the launch shape
# ---------------------------------------------------------------------------
def test_wrapper_rejects_bad_operands():
    arrays = inputs(7, 2, 64, 2, 2, 16)
    t = list(port(*arrays))
    bad = [(0, t[0].double()), (1, t[1].to(torch.int16)),
           (2, t[2][:, :-1]), (5, t[5].long()), (6, t[6][:1]),
           (0, t[0][:, :, :, :8])]
    for i, val in bad:
        args = list(t)
        args[i] = val
        with pytest.raises((TypeError, ValueError)):
            K11.decode_attention_int8(*args)
    empty = [a[:, :0] if i in (1, 2, 3, 4, 5) else a for i, a in enumerate(t)]
    with pytest.raises(ValueError):
        K11.decode_attention_int8(*empty)


@pytest.mark.parametrize("B,S,KV,G,Dh", [
    (8, 8192, 8, 2, 128),      # qwen3-1.7b served: B 8, max_len 8192
    (1, 1024, 4, 1, 128), (3, 640, 2, 6, 64), (2, 48, 2, 2, 16),
    (1, 100_000, 8, 4, 80), (64, 4096, 8, 2, 128), (1, 1_000_000, 1, 1, 64),
    (256, 32768, 8, 1, 128)])
def test_decode_launch_fills_the_card_and_covers_the_cache(B, S, KV, G, Dh):
    lanes, threads, g_tile, per_split, splits = C.decode_attention_launch(
        B, KV, G, S, Dh)
    assert lanes & (lanes - 1) == 0 and lanes * 16 >= Dh > lanes * 8
    assert threads % lanes == 0 and threads % 32 == 0 and threads <= 256
    assert g_tile in (1, 2, 4) and (g_tile >= G or g_tile == 4)
    assert splits * per_split >= S > (splits - 1) * per_split
    blocks = B * KV * -(-G // g_tile) * splits
    if S >= C.DECODE_MIN_KEYS * C.DECODE_BLOCKS_PER_SM * C.H100_SMS:
        assert blocks >= C.DECODE_BLOCKS_PER_SM * C.H100_SMS
    assert splits == 1 or per_split >= C.DECODE_MIN_KEYS
    # a split lists its valid slots in shared memory, 8 a thread; a block
    # of 4 query rows runs 128 threads, any other 256
    assert per_split <= C.DECODE_KEYS_PER_THREAD * threads
    assert threads == (128 if g_tile == 4 else 256)
    if (B, S, KV, G) == (8, 8192, 8, 2):          # the served shape
        assert blocks >= C.H100_SMS and splits > 1


@pytest.mark.parametrize("Dh", [8, 24, 1024])
def test_decode_launch_refuses_heads_the_kernel_cannot_read(Dh):
    with pytest.raises(ValueError):
        C.decode_attention_launch(2, 2, 2, 64, Dh)
