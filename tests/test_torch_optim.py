"""The port's AdamW: the five properties of ``tests/test_optim.py`` on the
port (schedule shape, clipping, descent, mixed precision, bias
correction), and ``schedule``, ``update`` and ``update_mixed`` against the
reference's on one numpy tree (float32 on both sides, within 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro_torch.models import opt_state_from_jax
from repro_torch.optim import adamw
from repro_torch.sharding.rules import tree_leaves, tree_map

pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


def tree(seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return {"w": scale * torch.randn((8, 16), generator=g),
            "b": scale * torch.randn((16,), generator=g)}


CFG = adamw.AdamWConfig(lr=1e-2, warmup_steps=10, total_steps=100,
                        weight_decay=0.0)


def loss_grad(fn, params):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    loss = fn(tree_map(lambda _: next(it), params))
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def test_schedule_warmup_and_cosine():
    s = [float(adamw.schedule(CFG, torch.tensor(i))) for i in
         (0, 5, 10, 55, 100)]
    assert s[0] == 0.0
    assert s[1] == pytest.approx(CFG.lr * 0.5)
    assert s[2] == pytest.approx(CFG.lr)
    assert s[2] > s[3] > s[4]
    assert s[4] == pytest.approx(CFG.lr * CFG.min_lr_ratio, rel=1e-3)


def test_clipping_bounds_update():
    params = tree(0)
    state = adamw.init(params)
    huge = tree_map(lambda p: 1e6 * torch.ones_like(p), params)
    new_params, state, gnorm = adamw.update(CFG, huge, state, params)
    assert float(gnorm) > CFG.clip_norm
    # first-step Adam update magnitude is ~lr regardless of grad scale
    for p0, p1 in zip(tree_leaves(params), tree_leaves(new_params)):
        assert float((p1 - p0).abs().max()) < 2 * CFG.lr


@settings(deadline=None, max_examples=10)
@given(seed=st.integers(0, 2**31 - 1))
def test_property_descends_quadratic(seed):
    """Adam must reduce ||p||^2 from any start."""
    params = tree(seed, scale=2.0)
    state = adamw.init(params)

    def loss(p):
        return sum((x * x).sum() for x in tree_leaves(p))
    l0 = float(loss(params))
    for _ in range(20):
        _, grads = loss_grad(loss, params)
        params, state, _ = adamw.update(CFG, grads, state, params)
    assert float(loss(params)) < l0


def test_mixed_precision_tracks_full_precision():
    """bf16 params + f32 master track the f32 path closely over steps."""
    params32 = tree(1)
    s_full = adamw.init(params32)
    s_mixed = adamw.init_mixed(params32)
    p_full = params32
    p_bf16 = tree_map(lambda p: p.to(torch.bfloat16), params32)

    def sin_sum(q):
        return sum(torch.sin(x).sum() for x in tree_leaves(q))

    for _ in range(10):
        _, g_full = loss_grad(sin_sum, p_full)
        p_full, s_full, _ = adamw.update(CFG, g_full, s_full, p_full)
        _, g_mixed = loss_grad(sin_sum, tree_map(lambda x: x.float(),
                                                 p_bf16))
        p_bf16, s_mixed, _ = adamw.update_mixed(CFG, g_mixed, s_mixed)
    for a, b in zip(tree_leaves(p_full), tree_leaves(s_mixed.master)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-2,
                                   atol=5e-3)
    # working copies really are bf16
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(p_bf16))


def test_bias_correction_first_step():
    """After one step from zero moments, update direction == sign(grad)."""
    params = tree(2, scale=0.0)
    state = adamw.init(params)
    grads = tree_map(lambda p: torch.where(
        torch.arange(p.numel()).reshape(p.shape) % 2 == 0, 1.0, -1.0)
        * 1e-3, params)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                            weight_decay=0.0, clip_norm=1e9)
    new_params, _, _ = adamw.update(cfg, grads, state, params)
    for g, p1 in zip(tree_leaves(grads), tree_leaves(new_params)):
        assert torch.equal(torch.sign(-g), torch.sign(p1))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
def np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((8, 16))).astype(np.float32),
            "b": (scale * rng.standard_normal(16)).astype(np.float32),
            "nest": {"e": (scale * rng.standard_normal((3, 5, 7))
                           ).astype(np.float32)}}


def t_tree(t):
    return tree_map(torch.from_numpy, t)


def close(got, want):
    """Leaf by leaf, by key (the port keeps a dict's order, JAX sorts)."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k])
        return
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-6)


def test_schedule_matches_reference():
    for cfg in (CFG, adamw.AdamWConfig(), adamw.AdamWConfig(
            warmup_steps=0, total_steps=1)):
        rcfg = RA.AdamWConfig(**cfg.__dict__)
        for step in (0, 1, 3, 5, 10, 11, 55, 99, 100, 250, 10_000):
            got = float(adamw.schedule(cfg, torch.tensor(step)))
            want = float(RA.schedule(rcfg, jnp.asarray(step)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_update_matches_reference(clip):
    """Five steps of ``update`` from one tree and one gradient sequence
    (clipped, or not), weight decay on: params, moments and grad norm."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                            weight_decay=0.1, clip_norm=clip)
    rcfg = RA.AdamWConfig(**cfg.__dict__)
    p0 = np_tree(3)
    rp, rs = jax.tree.map(jnp.asarray, p0), RA.init(jax.tree.map(
        jnp.asarray, p0))
    tp = t_tree(p0)
    ts = adamw.init(tp)
    r_update = jax.jit(lambda g, s, p: RA.update(rcfg, g, s, p))
    for i in range(5):
        g = np_tree(10 + i, scale=0.5)
        rp, rs, rn = r_update(jax.tree.map(jnp.asarray, g), rs, rp)
        tp, ts, tn = adamw.update(cfg, t_tree(g), ts, tp)
        close(tp, rp)
        close(ts.m, rs.m)
        close(ts.v, rs.v)
        assert int(ts.step) == int(rs.step) == i + 1
        assert float(tn) == pytest.approx(float(rn), rel=1e-6)


def test_update_inplace_writes_the_given_tensors():
    """``inplace=True`` gives the same values as the functional update and
    writes them into the given parameters and moments."""
    p0 = np_tree(4)
    g = t_tree(np_tree(5, scale=0.5))
    want_p, want_s, _ = adamw.update(CFG, g, adamw.init(t_tree(p0)),
                                     t_tree(p0))
    tp = t_tree(p0)
    ts = adamw.init(tp)
    got_p, got_s, _ = adamw.update(CFG, g, ts, tp, inplace=True)
    for a, b in zip(tree_leaves(got_p), tree_leaves(tp)):
        assert a is b
    for a, b in zip(tree_leaves(got_s.m), tree_leaves(ts.m)):
        assert a is b
    for got, want in ((got_p, want_p), (got_s.m, want_s.m),
                      (got_s.v, want_s.v)):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)


def test_update_mixed_matches_reference():
    """Five mixed-precision steps (bf16 grads in, bf16 working params out,
    float32 master): the master, moments and working params equal the
    reference's."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20)
    rcfg = RA.AdamWConfig(**cfg.__dict__)
    p0 = np_tree(6)
    rs = RA.init_mixed(jax.tree.map(jnp.asarray, p0))
    ts = adamw.init_mixed(t_tree(p0))
    r_update = jax.jit(lambda g, s: RA.update_mixed(rcfg, g, s))
    for i in range(5):
        g = np_tree(20 + i, scale=0.5)
        rw, rs, rn = r_update(jax.tree.map(
            lambda a: jnp.asarray(a, jnp.bfloat16), g), rs)
        tw, ts, tn = adamw.update_mixed(cfg, tree_map(
            lambda t: t.to(torch.bfloat16), t_tree(g)), ts)
        close(ts.master, rs.master)
        close(ts.m, rs.m)
        close(ts.v, rs.v)
        close(tw, rw)
        assert all(x.dtype == torch.bfloat16 for x in tree_leaves(tw))
        assert float(tn) == pytest.approx(float(rn), rel=1e-6)
    assert isinstance(ts, adamw.AdamWMixedState) and int(ts.step) == 5


def test_opt_state_crosses_both_ways():
    """A reference AdamW state (plain and mixed) in the port and back."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import opt_state_to_jax
    from repro.configs import get_config as rget, smoke_config as rsmoke
    from repro.models import model as RM
    rcfg = rsmoke(rget("zamba2-1.2b"))
    tcfg = smoke_config(get_config("zamba2-1.2b"))
    rp = jax.tree.map(np.asarray, RM.init(rcfg, jax.random.PRNGKey(3)))
    for init in (RA.init, RA.init_mixed):
        rs = init(jax.tree.map(jnp.asarray, rp))
        rs = rs._replace(step=jnp.asarray(7, jnp.int32),
                         m=jax.tree.map(lambda a: a + 1.0, rs.m))
        ts = opt_state_from_jax(rs, tcfg, device="cpu")
        assert type(ts).__name__ == type(rs).__name__
        assert int(ts.step) == 7 and ts.step.dtype == torch.int32
        back = opt_state_to_jax(ts, tcfg)
        assert back._fields == rs._fields
        for a, b in zip(jax.tree.leaves(tuple(back)),
                        jax.tree.leaves(tuple(rs))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
