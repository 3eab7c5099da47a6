"""Port vs reference: the LM's prefill and decode steps (logits and caches)
and the ring cache's rollover, on the smoke configs in float32, with and
without the int8 KV cache.  Inputs, weights and the tolerance (1e-4 on the
logits, and why) are those of ``test_torch_lm.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro_torch.models import model as TM
from test_torch_lm import TOL, both_params, configs, f32, t_


def reference_caches(rc, rcfg):
    """The reference's stacked caches in the port's layout: one dict per
    layer, ``{block cache: {field: numpy array}}``, in the port's order."""
    out = []
    for r in range(rcfg.scan_reps):
        for i in range(rcfg.period):
            out.append({sub: {n: np.asarray(a[r]) for n, a in c.items()}
                        for sub, c in rc["scan"][f"pos{i}"].items()})
    for i in range(len(rcfg.remainder_pattern)):
        out.append({sub: {n: np.asarray(a) for n, a in c.items()}
                    for sub, c in rc["rem"][f"rem{i}"].items()})
    return out


def assert_caches_match(tc, rc, rcfg, quant):
    """Every cache field of every layer within ``TOL`` of the reference's;
    the int8 KV cache's codes and scales aside (``quant``: compared where
    they are written, with their own limits)."""
    for t, r in zip(tc["layers"], reference_caches(rc, rcfg)):
        for sub, fields in r.items():
            if quant and sub == "attn":
                continue
            for n, a in fields.items():
                np.testing.assert_allclose(f32(t[sub][n]), f32(a), **TOL,
                                           err_msg=f"{sub}/{n}")


def reference_fns(rcfg):
    """The reference's prefill, decode_step and forward, jitted (as its
    serving engine runs them)."""
    return (jax.jit(lambda p, b, c: RM.prefill(p, b, c, rcfg)),
            jax.jit(lambda p, t, c, n: RM.decode_step(p, t, c, n, rcfg)),
            jax.jit(lambda p, b: RM.forward(p, b, rcfg)))


MODELS = [("qwen3-1.7b", {}), ("h2o-danube-1.8b", {}),
          # gemma3's period-6 pattern (+ remainder, theta_global); with its
          # qk-norm on, the 14 smoke layers stay well conditioned
          ("gemma3-12b", {"n_layers": 14, "qk_norm": True}),
          # the MoE archs at capacity_factor = n_experts (no pair dropped),
          # as tests/test_models_smoke.py runs them: prefill's capacity
          # depends on the tokens, so drops would differ from forward's
          ("dbrx-132b", {"capacity_factor": 4.0}),
          ("mixtral-8x22b", {"capacity_factor": 4.0}),
          ("zamba2-1.2b", {}), ("xlstm-1.3b", {})]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch,kw", MODELS)
def test_prefill_and_decode_logits_match_reference(arch, kw, quant):
    rcfg, tcfg = configs(arch, kv_quant=quant, **kw)
    rp, tp = both_params(rcfg, tcfg)
    r_prefill, r_decode, r_forward = reference_fns(rcfg)
    B, S = 2, 32
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size,
                                             (B, S)).astype(np.int32)
    rc = RM.init_caches(rcfg, B, S + 4, jnp.float32)
    tc = TM.init_caches(tcfg, B, S + 4, torch.float32, device="cpu")
    want, rc = r_prefill(rp, {"tokens": jnp.asarray(toks[:, :-1])}, rc)
    got, tc = TM.prefill(tp, {"tokens": t_(toks[:, :-1]).long()}, tc, tcfg)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    ref_layers = reference_caches(rc, rcfg)
    assert [set(c) for c in tc["layers"]] == [set(r) for r in ref_layers]
    if quant:
        # an int8 code rounds the other way where the two packages' float32
        # keys straddle a half: at most one step, and rarely
        # (xLSTM has no attention layer, so no code)
        codes = [np.abs(f32(t["attn"][n]) - f32(r["attn"][n])).ravel()
                 for t, r in zip(tc["layers"], ref_layers) if "attn" in r
                 for n in ("k", "v")]
        diff = np.concatenate(codes or [np.zeros(1)])
        assert diff.max() <= 1 and np.count_nonzero(diff) <= 1e-3 * diff.size
        # decode from the reference's cache, so that one code rounded the
        # other way (~3e-4 on the logits) does not stand for the decode path
        for t, r in zip(tc["layers"], ref_layers):
            for n, a in r.get("attn", {}).items():
                t["attn"][n].copy_(torch.from_numpy(np.array(f32(a))))
    assert_caches_match(tc, rc, rcfg, quant)
    for step in range(3):
        tok = toks[:, -1:] if step == 0 else \
            np.asarray(np.argmax(f32(want)[:, -1], -1), np.int32)[:, None]
        pos = S - 1 + step
        want, rc = r_decode(rp, jnp.asarray(tok), rc,
                            jnp.asarray(pos, jnp.int32))
        got, tc = TM.decode_step(tp, t_(tok).long(), tc, pos, tcfg)
        np.testing.assert_allclose(f32(got), f32(want), **TOL)
    assert_caches_match(tc, rc, rcfg, quant)
    full, _ = TM.forward(tp, {"tokens": t_(toks).long()}, tcfg)
    rfull, _ = r_forward(rp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(f32(full), f32(rfull), **TOL)


@pytest.mark.parametrize("quant", [False, True])
def test_ring_cache_rollover_multistep_matches_reference(quant):
    """tests/test_models_smoke.py::test_ring_cache_rollover_multistep on the
    port: decode past the sliding window, so the ring cache wraps; every
    step's logits equal the reference's, and (exact cache) a fresh forward
    over the sequence, as the reference's test holds."""
    rcfg, tcfg = configs("h2o-danube-1.8b", window=16, kv_quant=quant)
    rp, tp = both_params(rcfg, tcfg)
    r_prefill, r_decode, _ = reference_fns(rcfg)
    B, S_total, S_pre = 2, 48, 24
    toks = np.random.default_rng(6).integers(0, tcfg.vocab_size,
                                             (B, S_total)).astype(np.int32)
    rc = RM.init_caches(rcfg, B, S_total, jnp.float32)
    tc = TM.init_caches(tcfg, B, S_total, torch.float32, device="cpu")
    assert tc["layers"][0]["attn"]["k"].shape[1] == 16
    _, rc = r_prefill(rp, {"tokens": jnp.asarray(toks[:, :S_pre])}, rc)
    _, tc = TM.prefill(tp, {"tokens": t_(toks[:, :S_pre]).long()}, tc, tcfg)
    for t in range(S_pre, S_total):
        want, rc = r_decode(rp, jnp.asarray(toks[:, t:t + 1]), rc,
                            jnp.asarray(t, jnp.int32))
        got, tc = TM.decode_step(tp, t_(toks[:, t:t + 1]).long(), tc, t, tcfg)
        np.testing.assert_allclose(f32(got), f32(want), **TOL,
                                   err_msg=f"step {t}")
        if not quant and t in (S_pre, S_pre + 15, S_total - 1):
            full, _ = TM.forward(tp, {"tokens": t_(toks[:, :t + 1]).long()},
                                 tcfg)
            np.testing.assert_allclose(f32(got[:, 0]), f32(full[:, -1]),
                                       rtol=3e-3, atol=3e-3)




def test_xlstm_cache_stabilizer_starts_as_the_references():
    """The reference's ``init_caches`` zero-fills the caches of the repeated
    layers, so xLSTM's stabilizer ``m`` starts at 0 there (at -1e30 in
    ``forward``), and its prefill differs from its forward.  The port keeps
    both starts: its prefill gives the reference's prefill, its forward
    the reference's forward, and the two differ as in the reference."""
    rcfg, tcfg = configs("xlstm-1.3b")
    rp, tp = both_params(rcfg, tcfg)
    r_prefill, _, r_forward = reference_fns(rcfg)
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size,
                                             (2, 24)).astype(np.int32)
    rc = RM.init_caches(rcfg, 2, 32, jnp.float32)
    tc = TM.init_caches(tcfg, 2, 32, torch.float32, device="cpu")
    for c, r in zip(tc["layers"], reference_caches(rc, rcfg)):
        for sub, fields in r.items():
            for n, a in fields.items():
                np.testing.assert_array_equal(f32(c[sub][n]), a)
    assert (f32(tc["layers"][0]["mlstm"]["m"]) == 0).all()
    want, _ = r_prefill(rp, {"tokens": jnp.asarray(toks)}, rc)
    got, _ = TM.prefill(tp, {"tokens": t_(toks).long()}, tc, tcfg)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    rfull, _ = r_forward(rp, {"tokens": jnp.asarray(toks)})
    full, _ = TM.forward(tp, {"tokens": t_(toks).long()}, tcfg)
    np.testing.assert_allclose(f32(full), f32(rfull), **TOL)
    assert np.abs(f32(full) - f32(got)).max() > 10 * TOL["atol"]
