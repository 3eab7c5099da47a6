"""Port vs reference: the MoE block (``models/moe.py``) — the router, the
paper's ``D_mat`` statistic and off-line ``D*`` rule, the ELL (capacity,
drops) and CSR (dropless) dispatch, and ``moe_apply`` under ``"ell"``,
``"csr"`` and ``"auto"``.

The same numpy weights and activations (from a seed) go through both
packages on the CPU in float32, dbrx's smoke config (d 64, ff 128, 4 experts,
top 2).  Tolerance ``TOL`` (1e-4): both sides compute in float32 and differ
only in summation order.  Expert choices (integers) are compared exactly;
the seeded router logits hold no ties.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import moe as RMoE
from repro_torch.models import moe as TMoE
from test_torch_lm import TOL, configs, f32, t_


def moe_case(seed, B=2, S=16, **kw):
    """Both configs, the expert weights (numpy) and x (B, S, d)."""
    rcfg, tcfg = configs("dbrx-132b", **kw)
    rng = np.random.default_rng(seed)
    d, ff, E = tcfg.d_model, tcfg.d_ff, tcfg.n_experts
    w = {"router": rng.normal(size=(d, E)),
         "w_gate": rng.normal(size=(E, d, ff)) / np.sqrt(d),
         "w_up": rng.normal(size=(E, d, ff)) / np.sqrt(d),
         "w_down": rng.normal(size=(E, ff, d)) / np.sqrt(ff)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    return rcfg, tcfg, w, x


def both(w):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: t_(v) for k, v in w.items()})


def routed(rp, tp, x, rcfg, tcfg):
    B, S, d = x.shape
    r = RMoE.route(rp, jnp.asarray(x.reshape(B * S, d)), rcfg)
    t = TMoE.route(tp, t_(x.reshape(B * S, d)), tcfg)
    return r, t


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_matches_reference(seed):
    rcfg, tcfg, w, x = moe_case(seed)
    rp, tp = both(w)
    (r_ids, r_gate, r_aux), (t_ids, t_gate, t_aux) = routed(rp, tp, x, rcfg,
                                                            tcfg)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(r_ids))
    np.testing.assert_allclose(f32(t_gate), f32(r_gate), **TOL)
    np.testing.assert_allclose(float(t_aux), float(r_aux), **TOL)
    assert t_gate.dtype == torch.float32
    np.testing.assert_allclose(f32(t_gate).sum(-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("counts", [
    [8, 8, 8, 8],            # balanced: D_mat = 0
    [20, 6, 4, 2],           # skewed
    [32, 0, 0, 0],           # one expert takes all
    [1, 2, 3, 4, 5, 6, 7, 4]])
def test_dispatch_d_mat_is_the_population_deviation(counts):
    """``jnp.std`` is the population deviation; the sample one
    (``torch.std``'s default) would move D_mat across D* near it."""
    ids = np.repeat(np.arange(len(counts)), counts)
    ids = np.random.default_rng(3).permutation(ids).reshape(-1, 2)
    want = float(RMoE.dispatch_d_mat(jnp.asarray(ids), len(counts)))
    got = float(TMoE.dispatch_d_mat(t_(ids).long(), len(counts)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, np.std(counts) / np.mean(counts),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("capacity", [None, 1, 3, 8])
def test_moe_ell_matches_reference_drops_included(capacity):
    """The capacity buffers of ``moe_ell``: ``capacity=None`` takes the
    config's factor (1.25: 16 tokens x 2 choices over 4 experts give C = 10,
    above this input's busiest expert, 9); 1 and 3 drop most pairs, 8 the
    busiest expert's ninth.  The dropped pairs are the reference's (the same
    flattened order)."""
    rcfg, tcfg, w, x = moe_case(4)
    rp, tp = both(w)
    (r_ids, r_gate, _), (t_ids, t_gate, _) = routed(rp, tp, x, rcfg, tcfg)
    B, S, _ = x.shape
    k = tcfg.top_k
    want = RMoE.moe_ell(rp, jnp.asarray(x), r_ids.reshape(B, S, k),
                        r_gate.reshape(B, S, k), rcfg, capacity=capacity)
    got = TMoE.moe_ell(tp, t_(x), t_ids.reshape(B, S, k),
                       t_gate.reshape(B, S, k), tcfg, capacity=capacity)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    C = TMoE.capacity_of(tcfg, S, capacity)
    per_expert = np.stack([np.bincount(np.asarray(r_ids).reshape(B, -1)[b],
                                       minlength=tcfg.n_experts)
                           for b in range(B)])
    assert (per_expert > C).any() == (capacity is not None)   # drops
    if capacity == 1:                       # a token with no kept choice
        assert (np.abs(f32(got)).sum(-1) == 0).any()


def test_moe_ell_without_drops_equals_csr():
    """At ``capacity_factor = n_experts`` no pair is dropped, and the two
    layouts compute one function."""
    rcfg, tcfg, w, x = moe_case(5, capacity_factor=4.0)
    rp, tp = both(w)
    _, (t_ids, t_gate, _) = routed(rp, tp, x, rcfg, tcfg)
    B, S, d = x.shape
    k = tcfg.top_k
    ell = TMoE.moe_ell(tp, t_(x), t_ids.reshape(B, S, k),
                       t_gate.reshape(B, S, k), tcfg)
    csr = TMoE.moe_csr(tp, t_(x.reshape(B * S, d)), t_ids, t_gate, tcfg)
    np.testing.assert_allclose(f32(ell).reshape(B * S, d), f32(csr), **TOL)


@pytest.mark.parametrize("seed", [6, 7])
def test_moe_csr_matches_reference(seed):
    rcfg, tcfg, w, x = moe_case(seed)
    rp, tp = both(w)
    (r_ids, r_gate, _), (t_ids, t_gate, _) = routed(rp, tp, x, rcfg, tcfg)
    B, S, d = x.shape
    want = RMoE.moe_csr(rp, jnp.asarray(x.reshape(B * S, d)), r_ids, r_gate,
                        rcfg)
    got = TMoE.moe_csr(tp, t_(x.reshape(B * S, d)), t_ids, t_gate, tcfg)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


def test_moe_csr_skips_experts_with_no_token(monkeypatch):
    """A decode step of one token routes to top_k experts only: the CSR
    path multiplies with those experts' weights and no other."""
    rcfg, tcfg, w, x = moe_case(8, B=1, S=1)
    rp, tp = both(w)
    (r_ids, r_gate, _), (t_ids, t_gate, _) = routed(rp, tp, x, rcfg, tcfg)
    calls = []
    real = TMoE._swiglu
    monkeypatch.setattr(TMoE, "_swiglu",
                        lambda xs, *ws: calls.append(len(xs)) or real(xs, *ws))
    got = TMoE.moe_csr(tp, t_(x[0]), t_ids, t_gate, tcfg)
    assert calls == [1] * tcfg.top_k
    want = RMoE.moe_csr(rp, jnp.asarray(x[0]), r_ids, r_gate, rcfg)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


def branch_spy(monkeypatch):
    taken = []
    for name in ("moe_ell", "moe_csr"):
        real = getattr(TMoE, name)
        monkeypatch.setattr(TMoE, name, lambda *a, _n=name, _r=real, **kw:
                            taken.append(_n) or _r(*a, **kw))
    return taken


@pytest.mark.parametrize("dispatch,d_star,branch", [
    ("ell", 0.5, "moe_ell"), ("csr", 0.5, "moe_csr"),
    ("auto", 1e9, "moe_ell"),      # D_mat < D*: ELL
    ("auto", 0.0, "moe_csr")])     # D_mat >= D*: CSR
def test_moe_apply_matches_reference(monkeypatch, dispatch, d_star, branch):
    """Each dispatch, ``"auto"`` with ``D*`` set so that each branch is
    taken; the port runs that branch alone (the reference's ``lax.cond``
    picks the same one)."""
    rcfg, tcfg, w, x = moe_case(9, moe_dispatch=dispatch)
    rp, tp = both(w)
    taken = branch_spy(monkeypatch)
    want, r_aux = RMoE.moe_apply(rp, jnp.asarray(x), rcfg, d_star=d_star)
    got, t_aux = TMoE.moe_apply(tp, t_(x), tcfg, d_star=d_star)
    assert taken == [branch]
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    np.testing.assert_allclose(float(t_aux), float(r_aux), **TOL)


def test_moe_apply_auto_compares_d_mat_with_d_star():
    """The branch follows ``D_mat < D*`` on either side of this input's
    D_mat."""
    rcfg, tcfg, w, x = moe_case(10, moe_dispatch="auto")
    rp, tp = both(w)
    _, (t_ids, _, _) = routed(rp, tp, x, rcfg, tcfg)
    d_mat = float(TMoE.dispatch_d_mat(t_ids, tcfg.n_experts))
    assert 0.0 < d_mat
    for d_star, dispatch in ((d_mat * 1.01, "ell"), (d_mat * 0.99, "csr")):
        got, _ = TMoE.moe_apply(tp, t_(x), tcfg, d_star=d_star)
        want, _ = TMoE.moe_apply(tp, t_(x), tcfg.replace(
            moe_dispatch=dispatch))
        np.testing.assert_array_equal(f32(got), f32(want))
        ref, _ = RMoE.moe_apply(rp, jnp.asarray(x), rcfg, d_star=d_star)
        np.testing.assert_allclose(f32(got), f32(ref), **TOL)


def test_moe_apply_seq_chunk_matches_reference():
    """S = 32 in chunks of 8: capacity is per chunk (C = 5 of the 8-token
    chunk, not 20 of the sequence), so the drops differ from the unchunked
    call, and equal the reference's scan."""
    rcfg, tcfg, w, x = moe_case(11, S=32)
    rp, tp = both(w)
    want, _ = RMoE.moe_apply(rp, jnp.asarray(x), rcfg, seq_chunk=8)
    got, _ = TMoE.moe_apply(tp, t_(x), tcfg, seq_chunk=8)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    whole, _ = TMoE.moe_apply(tp, t_(x), tcfg)
    assert np.abs(f32(whole) - f32(got)).max() > 10 * TOL["atol"]
    odd, _ = TMoE.moe_apply(tp, t_(x), tcfg, seq_chunk=12)   # 32 % 12: whole
    np.testing.assert_array_equal(f32(odd), f32(whole))


def test_moe_decode_capacity_is_one():
    """At decode (S = 1) the capacity is 1: the top-k experts of a token are
    distinct, so nothing is dropped, and ELL equals CSR."""
    rcfg, tcfg, w, x = moe_case(12, B=3, S=1)
    assert TMoE.capacity_of(tcfg, 1) == 1
    rp, tp = both(w)
    got, _ = TMoE.moe_apply(tp, t_(x), tcfg)
    csr, _ = TMoE.moe_apply(tp, t_(x), tcfg.replace(moe_dispatch="csr"))
    np.testing.assert_allclose(f32(got), f32(csr), **TOL)
    want, _ = RMoE.moe_apply(rp, jnp.asarray(x), rcfg)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


POINTS = [(0.05, 1.0, 4.0, 0.00),   # balanced: ELL wins, no drops
          (0.50, 1.0, 4.0, 0.03),   # mild skew: still qualifies
          (0.90, 1.0, 4.0, 0.28),   # drops exceed budget
          (1.20, 5.0, 4.0, 0.35)]   # ELL slower AND droppy


@pytest.mark.parametrize("points,kw,want", [
    (POINTS, {}, 0.50),
    (POINTS, {"max_drop_frac": 0.3}, 0.90),
    ([(1.0, 5.0, 4.0, 0.5)], {}, 0.0),
    ([], {}, 0.0)])
def test_moe_learn_d_star(points, kw, want):
    """tests/test_models_smoke.py::test_moe_learn_d_star's cases (and no
    point at all), against the reference."""
    assert TMoE.learn_d_star(points, **kw) == want
    assert RMoE.learn_d_star(points, **kw) == want
    assert TMoE.DEFAULT_D_STAR == RMoE.DEFAULT_D_STAR


def test_moe_spec_matches_reference():
    rcfg, tcfg = configs("dbrx-132b")
    rs, ts = RMoE.moe_spec(rcfg), TMoE.moe_spec(tcfg)
    assert {k: (v.shape, v.axes, v.init) for k, v in rs.items()} == \
        {k: (v.shape, v.axes, v.init) for k, v in ts.items()}
