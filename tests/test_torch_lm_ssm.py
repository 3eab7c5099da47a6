"""Port vs reference: the Mamba-2 (SSD) block (``models/ssm.py``) — no
cache, prefill-and-fill over several chunks, one decode step, the caches
field by field, and the chunk-length assertion.

The same numpy weights and activations (from a seed) go through both
packages on the CPU in float32, zamba2's smoke config (d 64, d_in 128, two
heads of 64, state 16, conv 4).  Tolerance ``TOL`` (1e-4): both sides compute
in float32 and differ only in summation order (the chunked scan's einsums
against torch's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import ssm as RS
from repro_torch.models import ssm as TS
from test_torch_lm import TOL, configs, f32, t_


def mamba_case(seed, B=2, S=32):
    """Both configs, the block's weights (numpy; the reference's shapes, with
    non-trivial A_log, dt_bias, D and conv bias) and x (B, S, d)."""
    rcfg, tcfg = configs("zamba2-1.2b")
    rng = np.random.default_rng(seed)
    spec = TS.mamba_spec(tcfg)
    d, d_in = tcfg.d_model, tcfg.ssm_expand * tcfg.d_model
    scale = {"in_proj": 1 / np.sqrt(d), "out_proj": 1 / np.sqrt(d_in),
             "conv_w": 0.5, "conv_b": 0.1, "A_log": 0.5, "dt_bias": 0.5,
             "D": 1.0}
    w = {k: (rng.normal(size=s.shape) * scale[k]) if k in scale
         else 1.0 + 0.1 * rng.normal(size=s.shape) for k, s in spec.items()}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    return rcfg, tcfg, w, x


def both(w):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: t_(v) for k, v in w.items()})


def caches(rcfg, tcfg, B):
    return (RS.init_mamba_cache(rcfg, B, jnp.float32),
            TS.init_mamba_cache(tcfg, B, torch.float32, device="cpu"))


def assert_caches_equal(tc, rc):
    assert set(tc) == set(rc) == {"h", "conv"}
    for name in tc:
        assert tuple(tc[name].shape) == tuple(rc[name].shape), name
        np.testing.assert_allclose(f32(tc[name]), f32(rc[name]), **TOL,
                                   err_msg=name)


def test_mamba_spec_and_cache_match_reference():
    rcfg, tcfg = configs("zamba2-1.2b")
    rs, ts = RS.mamba_spec(rcfg), TS.mamba_spec(tcfg)
    assert {k: (v.shape, v.axes, v.init) for k, v in rs.items()} == \
        {k: (v.shape, v.axes, v.init) for k, v in ts.items()}
    rc, tc = caches(rcfg, tcfg, 3)
    for name in rc:
        assert tuple(tc[name].shape) == rc[name].shape
        assert not f32(tc[name]).any()
    assert tc["h"].dtype == torch.float32
    bf = TS.init_mamba_cache(tcfg, 1, torch.bfloat16, device="cpu")
    assert (bf["h"].dtype, bf["conv"].dtype) == (torch.float32,
                                                 torch.bfloat16)


@pytest.mark.parametrize("chunk", [8, 32, 256])
def test_mamba_apply_without_cache_matches_reference(chunk):
    """The chunked SSD over 4, 1 and 1 chunks (256 > S: one chunk of S)."""
    rcfg, tcfg, w, x = mamba_case(0)
    rp, tp = both(w)
    want, rnone = RS.mamba_apply(rp, jnp.asarray(x), rcfg, chunk=chunk)
    got, tnone = TS.mamba_apply(tp, t_(x), tcfg, chunk=chunk)
    assert rnone is None and tnone is None
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


def test_mamba_chunks_compute_one_function():
    rcfg, tcfg, w, x = mamba_case(1)
    _, tp = both(w)
    one, _ = TS.mamba_apply(tp, t_(x), tcfg, chunk=32)
    four, _ = TS.mamba_apply(tp, t_(x), tcfg, chunk=8)
    np.testing.assert_allclose(f32(four), f32(one), **TOL)


@pytest.mark.parametrize("chunk", [8, 16])
def test_mamba_prefill_fills_the_references_caches(chunk):
    """Prefill with a cache, S = 32 in chunks of 8 and 16: the output, the
    final SSM state ``h`` and the last three conv inputs; the cache is
    written in place."""
    rcfg, tcfg, w, x = mamba_case(2)
    rp, tp = both(w)
    rc, tc = caches(rcfg, tcfg, 2)
    h_before = tc["h"]
    want, rc = RS.mamba_apply(rp, jnp.asarray(x), rcfg, cache=rc, chunk=chunk)
    got, tc2 = TS.mamba_apply(tp, t_(x), tcfg, cache=tc, chunk=chunk)
    assert tc2 is tc and tc["h"] is h_before
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    assert_caches_equal(tc, rc)


@pytest.mark.parametrize("steps", [1, 3])
def test_mamba_decode_steps_match_reference(steps):
    """One-step decode after a prefill, ``steps`` times: each output and the
    caches after every step."""
    rcfg, tcfg, w, x = mamba_case(3, S=24)
    rp, tp = both(w)
    rc, tc = caches(rcfg, tcfg, 2)
    _, rc = RS.mamba_apply(rp, jnp.asarray(x[:, :16]), rcfg, cache=rc,
                           chunk=8)
    TS.mamba_apply(tp, t_(x[:, :16]), tcfg, cache=tc, chunk=8)
    for t in range(16, 16 + steps):
        want, rc = RS.mamba_apply(rp, jnp.asarray(x[:, t:t + 1]), rcfg,
                                  cache=rc)
        got, _ = TS.mamba_apply(tp, t_(x[:, t:t + 1]), tcfg, cache=tc)
        np.testing.assert_allclose(f32(got), f32(want), **TOL)
        assert_caches_equal(tc, rc)


def test_mamba_decode_continues_the_sequence():
    """Prefill of 16 then 8 decode steps gives the outputs of one pass over
    the 24 tokens (the recurrent and chunked forms agree)."""
    rcfg, tcfg, w, x = mamba_case(4, S=24)
    _, tp = both(w)
    full, _ = TS.mamba_apply(tp, t_(x), tcfg, chunk=8)
    _, tc = caches(rcfg, tcfg, 2)
    TS.mamba_apply(tp, t_(x[:, :16]), tcfg, cache=tc, chunk=8)
    steps = [TS.mamba_apply(tp, t_(x[:, t:t + 1]), tcfg, cache=tc)[0]
             for t in range(16, 24)]
    np.testing.assert_allclose(f32(torch.cat(steps, dim=1)),
                               f32(full[:, 16:]), **TOL)


def test_mamba_chunk_length_must_divide_the_sequence():
    """S = 40 in chunks of 16 fails in both (the reference's assertion; a
    prompt is not padded to a chunk)."""
    rcfg, tcfg, w, x = mamba_case(5, S=40)
    rp, tp = both(w)
    with pytest.raises(AssertionError):
        RS.mamba_apply(rp, jnp.asarray(x), rcfg, chunk=16)
    with pytest.raises(AssertionError):
        TS.mamba_apply(tp, t_(x), tcfg, chunk=16)
    got, _ = TS.mamba_apply(tp, t_(x), tcfg, chunk=8)      # 40 = 5 x 8
    want, _ = RS.mamba_apply(rp, jnp.asarray(x), rcfg, chunk=8)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


def test_mamba_masked_decay_does_not_leak_inf():
    """A strongly decaying head (large dt, A = -e^3): exp of the masked
    upper triangle overflows to inf; selecting (never multiplying by the
    mask) keeps every output finite and equal to the reference's."""
    rcfg, tcfg, w, x = mamba_case(6)
    w["A_log"][:] = 3.0
    w["dt_bias"][:] = 4.0
    rp, tp = both(w)
    want, _ = RS.mamba_apply(rp, jnp.asarray(x), rcfg, chunk=32)
    got, _ = TS.mamba_apply(tp, t_(x), tcfg, chunk=32)
    assert np.isfinite(f32(got)).all()
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


def test_mamba_bf16_decode_promotes_a_float32_conv_cache():
    """In bfloat16 with the engine's float32 conv cache the decode step's
    conv runs in float32, as the reference's einsum promotes; outputs agree
    to bfloat16's resolution (2^-8 relative, through the block's two
    projections)."""
    rcfg, tcfg, w, x = mamba_case(7, S=8)
    rcfg, tcfg = rcfg.replace(dtype="bfloat16"), tcfg.replace(
        dtype="bfloat16")
    rp, tp = both(w)
    tp = {k: v.to(torch.bfloat16) if v.ndim > 1 else v for k, v in
          tp.items()}
    rc, tc = caches(rcfg, tcfg, 2)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    _, rc = RS.mamba_apply(rp, xb[:, :7], rcfg, cache=rc)
    TS.mamba_apply(tp, t_(x[:, :7]).to(torch.bfloat16), tcfg, cache=tc)
    want, rc = RS.mamba_apply(rp, xb[:, 7:], rcfg, cache=rc)
    got, _ = TS.mamba_apply(tp, t_(x[:, 7:]).to(torch.bfloat16), tcfg,
                            cache=tc)
    assert got.dtype == torch.bfloat16 and tc["conv"].dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(f32(tc["h"]), f32(rc["h"]), rtol=3e-2,
                               atol=3e-2)
