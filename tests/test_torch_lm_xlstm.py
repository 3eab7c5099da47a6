"""Port vs reference: the xLSTM blocks (``models/xlstm.py``) — mLSTM and
sLSTM with no cache, prefill-and-fill and one decode step, with the caches
field by field.

The same numpy weights and activations (from a seed) go through both
packages on the CPU in float32, xlstm's smoke config (d 64, four heads;
mLSTM: d_in 128, dk 16, dv 32; sLSTM: dh 16).  Tolerance ``TOL`` (1e-4):
both sides compute in float32 and differ only in summation order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as RX
from repro_torch.models import xlstm as TX
from test_torch_lm import TOL, configs, f32, t_

KINDS = {
    "mlstm": (RX.mlstm_spec, RX.mlstm_apply, RX.init_mlstm_cache,
              TX.mlstm_spec, TX.mlstm_apply, TX.init_mlstm_cache),
    "slstm": (RX.slstm_spec, RX.slstm_apply, RX.init_slstm_cache,
              TX.slstm_spec, TX.slstm_apply, TX.init_slstm_cache),
}


def xlstm_case(kind, seed, B=2, S=20):
    """Both configs, the block's apply and cache init on both sides, its
    weights (numpy: the spec's scales, plus a non-zero conv bias) and x."""
    rcfg, tcfg = configs("xlstm-1.3b")
    r_spec, r_apply, r_init, t_spec, t_apply, t_init = KINDS[kind]
    rng = np.random.default_rng(seed)
    w = {}
    for name, s in t_spec(tcfg).items():
        if s.init == "ones":
            a = 1.0 + 0.1 * rng.normal(size=s.shape)
        elif s.init == "zeros":
            a = 0.1 * rng.normal(size=s.shape)
        else:
            a = rng.normal(size=s.shape) * (s.scale or 1 / np.sqrt(
                s.shape[-2]))
        w[name] = a.astype(np.float32)
    x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
    rp = {k: jnp.asarray(v) for k, v in w.items()}
    tp = {k: t_(v) for k, v in w.items()}
    return (rcfg, tcfg, r_apply, t_apply,
            lambda b: (r_init(rcfg, b, jnp.float32),
                       t_init(tcfg, b, torch.float32, device="cpu")),
            rp, tp, x)


def assert_caches_equal(tc, rc):
    assert set(tc) == set(rc)
    for name in tc:
        assert tuple(tc[name].shape) == tuple(rc[name].shape), name
        np.testing.assert_allclose(f32(tc[name]), f32(rc[name]), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_spec_and_cache_init_match_reference(kind):
    rcfg, tcfg, *_, init, _, _, _ = xlstm_case(kind, 0)
    r_spec, t_spec = KINDS[kind][0], KINDS[kind][3]
    assert {k: (v.shape, v.axes, v.init, v.scale)
            for k, v in r_spec(rcfg).items()} == \
        {k: (v.shape, v.axes, v.init, v.scale)
         for k, v in t_spec(tcfg).items()}
    rc, tc = init(3)
    assert_caches_equal(tc, rc)
    assert (f32(tc["m"]) == -1e30).all()
    assert all(t.dtype == torch.float32 for n, t in tc.items()
               if n != "conv")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", [1, 20])
def test_apply_without_cache_matches_reference(kind, S):
    rcfg, tcfg, r_apply, t_apply, _, rp, tp, x = xlstm_case(kind, 1, S=S)
    want, _ = r_apply(rp, jnp.asarray(x), rcfg)
    got, none = t_apply(tp, t_(x), tcfg)
    assert none is None
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_fills_the_references_caches(kind):
    """Prefill a cache over 20 steps: the output and every cache field
    (mLSTM C, n, m and the last three conv inputs; sLSTM c, n, h, m),
    written in place."""
    rcfg, tcfg, r_apply, t_apply, init, rp, tp, x = xlstm_case(kind, 2)
    rc, tc = init(2)
    before = {n: t for n, t in tc.items()}
    want, rc = r_apply(rp, jnp.asarray(x), rcfg, cache=rc)
    got, tc2 = t_apply(tp, t_(x), tcfg, cache=tc)
    assert tc2 is tc and all(tc[n] is t for n, t in before.items())
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    assert_caches_equal(tc, rc)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("m0", [-1e30, 0.0])
def test_decode_steps_match_reference(kind, m0):
    """Three decode steps after a prefill of 12, from a stabilizer that
    starts at -1e30 (the block's own cache) and at 0 (the zero-filled
    caches of the model's repeated layers, as the reference's
    ``init_caches`` makes them): outputs and caches after each step."""
    rcfg, tcfg, r_apply, t_apply, init, rp, tp, x = xlstm_case(kind, 3,
                                                                S=15)
    rc, tc = init(2)
    rc = dict(rc, m=jnp.full_like(rc["m"], m0))
    tc["m"].fill_(m0)
    _, rc = r_apply(rp, jnp.asarray(x[:, :12]), rcfg, cache=rc)
    t_apply(tp, t_(x[:, :12]), tcfg, cache=tc)
    for t in range(12, 15):
        want, rc = r_apply(rp, jnp.asarray(x[:, t:t + 1]), rcfg, cache=rc)
        got, _ = t_apply(tp, t_(x[:, t:t + 1]), tcfg, cache=tc)
        np.testing.assert_allclose(f32(got), f32(want), **TOL)
        assert_caches_equal(tc, rc)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_continues_the_sequence(kind):
    """Prefill of 12 then decode of 8 gives the outputs of one pass with no
    cache over the 20 steps."""
    rcfg, tcfg, r_apply, t_apply, init, rp, tp, x = xlstm_case(kind, 4)
    full, _ = t_apply(tp, t_(x), tcfg)
    _, tc = init(2)
    t_apply(tp, t_(x[:, :12]), tcfg, cache=tc)
    steps = [t_apply(tp, t_(x[:, t:t + 1]), tcfg, cache=tc)[0]
             for t in range(12, 20)]
    np.testing.assert_allclose(f32(torch.cat(steps, dim=1)),
                               f32(full[:, 12:]), **TOL)


def test_slstm_gates_are_interleaved_on_the_last_axis():
    """sLSTM's pre-activations are (…, H, dh, 4): gate g of unit j is
    column 4 j + g.  Reading the four gates as contiguous chunks of 4·dh
    instead moves the output."""
    rcfg, tcfg, r_apply, t_apply, _, rp, tp, x = xlstm_case("slstm", 5)
    want, _ = r_apply(rp, jnp.asarray(x), rcfg)
    got, _ = t_apply(tp, t_(x), tcfg)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    d = tcfg.d_model
    perm = np.arange(4 * d).reshape(4, d).T.reshape(-1)   # chunks -> interleave
    chunked = dict(tp, in_proj=tp["in_proj"][:, perm])
    other, _ = t_apply(chunked, t_(x), tcfg)
    assert np.abs(f32(other) - f32(want)).max() > 10 * TOL["atol"]


def test_slstm_recurrence_runs_in_float32():
    """``R`` is read in float32 whatever the compute dtype (the reference's
    ``.astype(float32)``); a bfloat16 block keeps it and its state so.  The
    outputs agree to bfloat16's resolution (2^-8 relative, through the
    block's two bfloat16 projections)."""
    rcfg, tcfg, r_apply, t_apply, init, rp, tp, x = xlstm_case("slstm", 6,
                                                               S=4)
    tcfg = tcfg.replace(dtype="bfloat16")
    tp = dict(tp, in_proj=tp["in_proj"].to(torch.bfloat16),
              out_proj=tp["out_proj"].to(torch.bfloat16))
    _, tc = init(2)
    got, _ = t_apply(tp, t_(x).to(torch.bfloat16), tcfg, cache=tc)
    assert got.dtype == torch.bfloat16
    assert tp["R"].dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in tc.values())
    want, _ = r_apply(rp, jnp.asarray(x).astype(jnp.bfloat16),
                      rcfg.replace(dtype="bfloat16"))
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2, atol=3e-2)
