"""Port vs reference: the LM serving path — configs, parameter specs and
their conversion, layers and attention (``test_torch_lm_model.py`` holds the
model's prefill and decode, ``test_torch_lm_serve.py`` the serving engine and
its launcher, both on this file's helpers).

The same weights (drawn by the JAX package and carried over by
``repro_torch.models.params_from_jax``) and the same numpy tokens go through
both packages on the CPU, in float32 (``smoke_config``).  The port's int8
decode branch runs K11's plain version here (CPU tensors); the CUDA kernel is
held against that plain version on the card.

Tolerance on logits: 1e-4 absolute, for logits of magnitude ~4.  Both sides
compute in float32 and differ only in summation order (XLA against oneDNN);
the smoke models without qk-norm amplify such differences: a 1e-7 relative
change of the weights moves h2o-danube's smoke logits by ~4e-5 within the
JAX package alone.  The models with qk-norm agree to ~2e-6.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as RM
from repro.sharding import rules as RR
from repro_torch import configs as TC
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params_from_jax
from repro_torch.sharding import rules as TR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
PORTED = RC.ARCH_IDS


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def t_(a):
    return torch.from_numpy(np.array(a))


def configs(arch, **kw):
    """The smoke config of ``arch`` in both packages, with ``kw`` set."""
    return (RC.smoke_config(RC.get_config(arch)).replace(**kw),
            TC.smoke_config(TC.get_config(arch)).replace(**kw))


@functools.lru_cache(maxsize=None)
def reference_params(rcfg, seed):
    """The reference's weights (the KV cache's layout is no part of them)."""
    return jax.jit(lambda k: RM.init(rcfg, k))(jax.random.PRNGKey(seed))


def both_params(rcfg, tcfg, seed=0):
    rp = reference_params(rcfg.replace(kv_quant=False), seed)
    return rp, params_from_jax(jax.tree.map(np.array, rp), tcfg,
                               device="cpu")


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_configs_are_the_references(arch):
    r, t = RC.get_config(arch), TC.get_config(arch)
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    rs, ts = RC.smoke_config(r), TC.smoke_config(t)
    assert dataclasses.asdict(rs) == dataclasses.asdict(ts)
    for a, b in ((r, t), (rs, ts)):
        assert (a.head_dim, a.q_per_kv, a.period, a.scan_reps,
                a.remainder_pattern, a.sub_quadratic) == \
            (b.head_dim, b.q_per_kv, b.period, b.scan_reps,
             b.remainder_pattern, b.sub_quadratic)
        assert b.compute_dtype == {"bfloat16": torch.bfloat16,
                                   "float32": torch.float32}[b.dtype]
    assert TC.get_config(arch.replace("-", "_").replace(".", "_")) == t
    assert dataclasses.asdict(t.resolve_for_tp(16)) == \
        dataclasses.asdict(r.resolve_for_tp(16))


def by_path(tree, prefix=""):
    """``{"a/b": leaf}`` of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in by_path(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_and_layer_shapes_match_reference(arch):
    r, t = RC.get_config(arch), TC.get_config(arch)
    assert TM.n_params(t) == RM.n_params(r)
    rspec, tspec = RM.model_spec(r), TM.model_spec(t)
    assert len(tspec["layers"]) == t.n_layers == len(TM.layer_kinds(t))
    for i, kind in enumerate(t.layer_pattern):
        stacked = by_path(rspec["scan"][f"pos{i}"])
        mine = by_path(tspec["layers"][i])
        assert sorted(stacked) == sorted(mine)
        for path, s in mine.items():
            assert (stacked[path].shape[1:], stacked[path].axes[1:],
                    stacked[path].init) == (s.shape, s.axes, s.init), path
    assert ("shared" in tspec) == ("shared" in rspec) == \
        ("mamba_attn" in t.layer_pattern)
    for name in ("embed", "final_norm", "head", "shared"):
        want = {p: (s.shape, s.axes, s.init)
                for p, s in by_path(rspec.get(name, {})).items()}
        assert want == {p: (s.shape, s.axes, s.init)
                        for p, s in by_path(tspec.get(name, {})).items()}


@pytest.mark.parametrize("scale", ["full", "smoke"])
@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_n_active_params_matches_reference(arch, scale):
    """Active parameters per token: all of them, but for the MoE archs,
    whose experts count top_k / n_experts."""
    r, t = RC.get_config(arch), TC.get_config(arch)
    if scale == "smoke":
        r, t = RC.smoke_config(r), TC.smoke_config(t)
    assert TM.n_active_params(t) == RM.n_active_params(r)
    assert (TM.n_active_params(t) < TM.n_params(t)) == bool(t.n_experts)


def test_every_block_kind_builds_and_caches():
    """Every architecture builds, initialises and fills its caches with
    finite prefill and decode logits (no kind is left to port)."""
    for arch in RC.ARCH_IDS:
        cfg = TC.smoke_config(TC.get_config(arch))
        p = TM.init(cfg, torch.Generator().manual_seed(1), device="cpu")
        caches = TM.init_caches(cfg, 1, 16, torch.float32, device="cpu")
        toks = torch.arange(8)[None] % cfg.vocab_size
        logits, _ = TM.prefill(p, {"tokens": toks}, caches, cfg)
        step, _ = TM.decode_step(p, toks[:, -1:], caches, 8, cfg)
        assert torch.isfinite(logits).all() and torch.isfinite(step).all()


@pytest.mark.parametrize("arch,leaf", [("dbrx-132b", ("moe", "router")),
                                       ("mixtral-8x22b", ("moe", "router")),
                                       ("xlstm-1.3b", ("slstm", "R"))])
def test_bf16_config_stores_float32_read_leaves_in_float32(arch, leaf):
    """The MoE router and sLSTM's recurrent ``R`` are read in float32 from
    float32 masters in the reference; a bfloat16 model stores them in
    float32 (their specs say ``float32``), by ``init`` and by
    ``params_from_jax``, so that the router's logits (and the top-k they
    pick) are the reference's.  The other matrices are bfloat16."""
    rcfg, tcfg = configs(arch, dtype="bfloat16")
    rp, tp = both_params(rcfg, tcfg)
    i = next(n for n, layer in enumerate(tp["layers"]) if leaf[0] in layer)
    drawn = TM.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for params in (tp, drawn):
        block = params["layers"][i][leaf[0]]
        assert block[leaf[1]].dtype == torch.float32
        assert all(v.dtype == torch.bfloat16 for k, v in block.items()
                   if k != leaf[1] and v.ndim > 1)
    pos = f"pos{i % tcfg.period}"
    np.testing.assert_array_equal(
        f32(tp["layers"][i][leaf[0]][leaf[1]]),
        np.asarray(rp["scan"][pos][leaf[0]][leaf[1]][i // tcfg.period]))


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_only_the_flagged_matrices_are_stored_in_float32(arch):
    """A bfloat16 model stores a matrix in float32 only where its spec says
    so — the MoE router and sLSTM's ``R``, which the reference reads in
    float32 — and ``stack_spec`` keeps that flag."""
    _, tcfg = configs(arch, dtype="bfloat16")
    p = TM.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    trees = {f"/layers/{i}": layer for i, layer in enumerate(p["layers"])}
    trees.update({f"/{k}": v for k, v in p.items() if k != "layers"})
    leaves = {path: t for name, tree in trees.items()
              for path, t in by_path(tree, name).items()}
    found = {path for path, t in leaves.items()
             if t.ndim > 1 and t.dtype == torch.float32}
    assert found == {path for path in leaves
                     if path.endswith(("/moe/router", "/slstm/R"))}
    assert bool(found) == (arch in ("dbrx-132b", "mixtral-8x22b",
                                    "xlstm-1.3b"))
    for layer in TM.model_spec(tcfg)["layers"]:
        flagged = {path for path, s in by_path(layer).items() if s.float32}
        stacked = by_path(TR.stack_spec(layer, 3, "layers"))
        assert flagged == {path for path, s in stacked.items() if s.float32}


def test_params_from_jax_carries_zamba2s_shared_block():
    """zamba2's shared attention block is one set, not stacked: it comes
    across as it is, and every mamba_attn layer reads that one set."""
    rcfg, tcfg = configs("zamba2-1.2b")
    rp, tp = both_params(rcfg, tcfg)
    assert set(tp["shared"]) == {"ln1", "attn", "ln2", "mlp"}
    for path, a in by_path(tp["shared"]).items():
        ref = rp["shared"]
        for key in path.strip("/").split("/"):
            ref = ref[key]
        np.testing.assert_array_equal(f32(a), np.asarray(ref))
    assert "attn" not in tp["layers"][0]
    bad = jax.tree.map(np.array, rp)
    del bad["shared"]
    with pytest.raises(KeyError, match="shared"):
        params_from_jax(bad, tcfg, device="cpu")


def test_stack_spec_and_param_count_match_reference():
    spec = {"a": RR.ParamSpec((3, 4), ("embed", None)),
            "b": {"c": RR.ParamSpec((5,), (None,), init="ones")}}
    tspec = {"a": TR.ParamSpec((3, 4), ("embed", None)),
             "b": {"c": TR.ParamSpec((5,), (None,), init="ones")}}
    rs, ts = RR.stack_spec(spec, 7, "layers"), TR.stack_spec(tspec, 7,
                                                             "layers")
    assert ts["a"] == TR.ParamSpec((7, 3, 4), ("layers", "embed", None))
    assert ts["b"]["c"].init == "ones"
    assert TR.param_count(ts) == RR.param_count(rs) == 7 * 17


def test_init_params_draws_each_kind_from_its_distribution():
    spec = {"ones": TR.ParamSpec((64,), (None,), init="ones"),
            "zeros": TR.ParamSpec((64,), (None,), init="zeros"),
            "normal": TR.ParamSpec((400, 300), ("embed", None)),
            "scaled": TR.ParamSpec((400, 300), ("embed", None), scale=0.5),
            "embed": TR.ParamSpec((400, 300), ("vocab", "embed"),
                                  init="embed"),
            "list": [TR.ParamSpec((2, 3), (None, None))]}
    p = TR.init_params(torch.Generator().manual_seed(3), spec,
                       device="cpu")
    assert torch.equal(p["ones"], torch.ones(64))
    assert torch.equal(p["zeros"], torch.zeros(64))
    for name, std in (("normal", 1 / np.sqrt(400)), ("scaled", 0.5),
                      ("embed", 1.0)):
        assert abs(float(p[name].std()) / std - 1) < 0.02, name
        assert abs(float(p[name].mean())) < 0.02 * std, name
    again = TR.init_params(torch.Generator().manual_seed(3), spec,
                           device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(TR.tree_leaves(p),
                                                 TR.tree_leaves(again)))
    other = TR.init_params(torch.Generator().manual_seed(4), spec,
                           device="cpu")
    assert not torch.equal(p["normal"], other["normal"])
    assert TR.init_params(torch.Generator(), spec, torch.bfloat16,
                          "cpu")["normal"].dtype == torch.bfloat16


def test_model_init_stores_matmul_weights_in_compute_dtype():
    cfg = TC.smoke_config(TC.get_config("qwen3-1.7b")).replace(
        dtype="bfloat16")
    p = TM.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    layer = p["layers"][0]
    assert layer["attn"]["wq"].dtype == torch.bfloat16
    assert layer["attn"]["wq"].shape == (64, 4, 16)
    assert layer["ln1"]["scale"].dtype == torch.float32
    assert layer["attn"]["q_norm"].dtype == torch.float32
    assert p["final_norm"]["scale"].dtype == torch.float32
    assert p["embed"]["tok"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# parameter conversion
# ---------------------------------------------------------------------------
def test_params_from_jax_unstacks_layers_in_the_references_order():
    """gemma3's pattern has period 6 (five local layers, one global); with
    14 layers it runs two repetitions and a remainder of two."""
    rcfg, tcfg = configs("gemma3-12b", n_layers=14)
    assert TM.layer_kinds(tcfg) == (["local"] * 5 + ["attn"]) * 2 + \
        ["local"] * 2
    rp, tp = both_params(rcfg, tcfg)
    assert len(tp["layers"]) == 14
    for r in range(2):
        for i in range(6):
            np.testing.assert_array_equal(
                f32(tp["layers"][6 * r + i]["attn"]["wq"]),
                np.asarray(rp["scan"][f"pos{i}"]["attn"]["wq"][r]))
    for i in range(2):
        np.testing.assert_array_equal(
            f32(tp["layers"][12 + i]["mlp"]["w_down"]),
            np.asarray(rp["rem"][f"rem{i}"]["mlp"]["w_down"]))


def test_params_from_jax_casts_once_to_the_compute_dtype():
    rcfg, tcfg = configs("qwen3-1.7b", dtype="bfloat16")
    rp, tp = both_params(rcfg, tcfg)
    wq = tp["layers"][1]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        f32(wq), f32(rp["scan"]["pos0"]["attn"]["wq"][1].astype(
            jnp.bfloat16)))
    assert tp["layers"][1]["attn"]["k_norm"].dtype == torch.float32
    assert params_from_jax(jax.tree.map(np.array, rp), tcfg, device="cpu",
                           dtype=torch.float32)["head"]["w"].dtype == \
        torch.float32
    bad = jax.tree.map(np.array, rp)
    bad["head"]["w"] = bad["head"]["w"][:, :-1]
    with pytest.raises(ValueError, match="head/w"):
        params_from_jax(bad, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_frontend_embeddings_are_projected_and_prepended_as_in_reference():
    """internvl2's stub vision frontend: precomputed patch embeddings go
    through ``frontend_proj`` and precede the text, in forward and in the
    cache-filling prefill."""
    rcfg, tcfg = configs("internvl2-2b")
    rp, tp = both_params(rcfg, tcfg)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    fe = rng.normal(size=(2, tcfg.frontend_len, 64)).astype(np.float32)
    want, _ = RM.forward(rp, {"tokens": jnp.asarray(toks),
                              "frontend_embeds": jnp.asarray(fe)}, rcfg)
    batch = {"tokens": t_(toks).long(), "frontend_embeds": t_(fe)}
    got, _ = TM.forward(tp, batch, tcfg)
    assert got.shape == (2, 12 + tcfg.frontend_len, tcfg.vocab_size)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    caches = TM.init_caches(tcfg, 2, 32, torch.float32, device="cpu")
    filled, _ = TM.prefill(tp, batch, caches, tcfg)
    np.testing.assert_allclose(f32(filled), f32(got), **TOL)


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    np.testing.assert_allclose(
        f32(TL.rms_norm({"scale": t_(scale)}, t_(x), 1e-5)),
        f32(RL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5)),
        rtol=1e-6, atol=1e-6)
    xr = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [40, 900, 8191, 8192, 3, 2, 1]],
                   np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            f32(TL.apply_rope(t_(xr), t_(pos), theta)),
            f32(RL.apply_rope(jnp.asarray(xr), jnp.asarray(pos), theta)),
            rtol=2e-5, atol=2e-5)
    rcfg, tcfg = configs("qwen3-1.7b", vocab_size=250)
    mlp = {k: rng.normal(size=s).astype(np.float32) * 0.1 for k, s in
           (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    np.testing.assert_allclose(
        f32(TL.mlp_apply({k: t_(v) for k, v in mlp.items()}, t_(x), tcfg)),
        f32(RL.mlp_apply({k: jnp.asarray(v) for k, v in mlp.items()},
                         jnp.asarray(x), rcfg)), **TOL)
    assert TL.padded_vocab(tcfg) == RL.padded_vocab(rcfg) == 256
    w = rng.normal(size=(64, 256)).astype(np.float32)
    tok = rng.normal(size=(256, 64)).astype(np.float32)
    for tie in (False, True):
        rc, tc = rcfg.replace(tie_embeddings=tie), tcfg.replace(
            tie_embeddings=tie)
        got = TL.lm_head_apply({"w": t_(w)}, {"tok": t_(tok)}, t_(x), tc)
        want = RL.lm_head_apply({"w": jnp.asarray(w)},
                                {"tok": jnp.asarray(tok)}, jnp.asarray(x), rc)
        np.testing.assert_allclose(f32(got), f32(want), **TOL)
        assert (f32(got)[..., 250:] == -1e30).all()
    ids = rng.integers(0, 250, (2, 5))
    np.testing.assert_array_equal(
        f32(TL.embed_tokens({"tok": t_(tok)}, t_(ids), tcfg)),
        f32(RL.embed_tokens({"tok": jnp.asarray(tok)}, jnp.asarray(ids),
                            rcfg)))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _qkv(rng, B=2, Sq=64, Sk=64, KV=2, G=2, Dh=16):
    return (rng.normal(size=(B, Sq, KV, G, Dh)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, Dh)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, Dh)).astype(np.float32))


@pytest.mark.parametrize("window,softcap,q_offset,chunk", [
    (None, 0.0, 0, 64), (None, 0.0, 0, 16), (8, 0.0, 0, 16),
    (None, 5.0, 0, 32), (12, 3.0, 16, 16)])
def test_flash_attention_matches_reference(window, softcap, q_offset, chunk):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, Sq=48 if q_offset else 64)
    got = TA.flash_attention(t_(q), t_(k), t_(v), q_offset=q_offset,
                             window=window, softcap=softcap, kv_chunk=chunk)
    want = RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              q_offset=q_offset, window=window,
                              softcap=softcap, kv_chunk=chunk)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(AssertionError):
        TA.flash_attention(t_(q), t_(k[:, :40]), t_(v[:, :40]), kv_chunk=32)


def test_flash_attention_swa_matches_reference():
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, Sq=256, Sk=256)
    got = TA.flash_attention_swa(t_(q), t_(k), t_(v), window=64, q_chunk=32)
    want = RA.flash_attention_swa(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=64, q_chunk=32)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        f32(got), f32(TA.flash_attention(t_(q), t_(k), t_(v), window=64,
                                         kv_chunk=32)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,softcap", [(None, 0.0), (5, 0.0),
                                            (None, 4.0)])
def test_decode_attention_matches_reference(window, softcap):
    rng = np.random.default_rng(3)
    B, S, KV, G, Dh = 3, 40, 2, 3, 16
    q = rng.normal(size=(B, 1, KV, G, Dh)).astype(np.float32)
    kc = rng.normal(size=(B, S, KV, Dh)).astype(np.float32)
    vc = rng.normal(size=(B, S, KV, Dh)).astype(np.float32)
    key_pos = np.where(np.arange(S) < np.array([[10], [40], [0]]),
                       np.arange(S), -1).astype(np.int32)
    q_pos = np.array([9, 39, 3], np.int32)
    got = TA.decode_attention(t_(q), t_(kc), t_(vc), t_(key_pos), t_(q_pos),
                              window=window, softcap=softcap)
    want = RA.decode_attention(*map(jnp.asarray, (q, kc, vc, key_pos, q_pos)),
                               window=window, softcap=softcap)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("slots", [64, 16])      # linear, ring
def test_attention_apply_branches_match_reference(quant, slots):
    """The three branches of attention_apply (no cache; prefill-and-fill;
    one decode step) give the reference's outputs, and the filled caches
    hold the reference's values (int8 codes within one step of each other:
    the codes round the same float32 keys computed in another order)."""
    rcfg, tcfg = configs("qwen3-1.7b", kv_quant=quant)
    rp, tp = both_params(rcfg, tcfg)
    ra = jax.tree.map(np.array, rp["scan"]["pos0"]["attn"])
    ra = jax.tree.map(lambda a: a[0], ra)
    ta = tp["layers"][0]["attn"]
    rng = np.random.default_rng(4)
    B, S = 2, 24
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    window = 16 if slots == 16 else None
    kw = dict(window=window)
    got, _ = TA.attention_apply(ta, t_(x), tcfg, **kw)
    want, _ = RA.attention_apply(ra, jnp.asarray(x), rcfg, **kw)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)

    rc = RA.init_kv_cache(rcfg, B, slots, jnp.float32)
    tc = TA.init_kv_cache(tcfg, B, slots, torch.float32, device="cpu")
    got, tc2 = TA.attention_apply(ta, t_(x), tcfg, cache=tc, **kw)
    want, rc = RA.attention_apply(ra, jnp.asarray(x), rcfg, cache=rc, **kw)
    assert tc2 is tc
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    for name in tc:
        if name in ("k", "v") and quant:
            assert np.abs(f32(tc[name]) - f32(rc[name])).max() <= 1
        elif name in ("k_s", "v_s"):      # bfloat16: one ulp
            np.testing.assert_allclose(f32(tc[name]), f32(rc[name]),
                                       rtol=2 ** -7, atol=0)
        else:
            np.testing.assert_allclose(f32(tc[name]), f32(rc[name]), **TOL)

    x1 = rng.normal(size=(B, 1, 64)).astype(np.float32)
    lens = np.array([S, S - 5], np.int32)
    got, _ = TA.attention_apply(ta, t_(x1), tcfg, cache=tc, cache_len=t_(lens),
                                **kw)
    want, rc = RA.attention_apply(ra, jnp.asarray(x1), rcfg, cache=rc,
                                  cache_len=jnp.asarray(lens), **kw)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)


def test_int8_decode_applies_the_logit_softcap_as_the_reference():
    """The int8 decode step with ``attn_logit_softcap`` set: the port caps
    the scores inside K11 (its plain version here), the reference after
    dequantizing the cache (``decode_attention(..., softcap=...)``); both
    decode from the same filled cache and give the same logits, which the
    cap moves."""
    from test_torch_lm_model import reference_caches, reference_fns
    rcfg, tcfg = configs("qwen3-1.7b", kv_quant=True, attn_logit_softcap=30.0)
    rp, tp = both_params(rcfg, tcfg)
    r_prefill, r_decode, _ = reference_fns(rcfg)
    B, S = 2, 24
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size,
                                             (B, S)).astype(np.int32)
    rc = RM.init_caches(rcfg, B, S + 2, jnp.float32)
    tc = TM.init_caches(tcfg, B, S + 2, torch.float32, device="cpu")
    _, rc = r_prefill(rp, {"tokens": jnp.asarray(toks[:, :-1])}, rc)
    for t, r in zip(tc["layers"], reference_caches(rc, rcfg)):
        for n, a in r["attn"].items():
            t["attn"][n].copy_(torch.from_numpy(np.array(f32(a))))
    uncapped = [{"attn": {n: a.clone() for n, a in c["attn"].items()}}
                for c in tc["layers"]]
    pos = S - 1
    want, _ = r_decode(rp, jnp.asarray(toks[:, -1:]), rc,
                       jnp.asarray(pos, jnp.int32))
    got, _ = TM.decode_step(tp, t_(toks[:, -1:]).long(), tc, pos, tcfg)
    np.testing.assert_allclose(f32(got), f32(want), **TOL)
    plain, _ = TM.decode_step(tp, t_(toks[:, -1:]).long(),
                              {"layers": uncapped}, pos,
                              tcfg.replace(attn_logit_softcap=0.0))
    assert np.abs(f32(plain) - f32(got)).max() > 10 * TOL["atol"]


@pytest.mark.parametrize("quant", [False, True])
def test_int8_branch_calls_k11_and_the_plain_branch_does_not(monkeypatch,
                                                             quant):
    calls = []
    real = TA.decode_attention_int8

    def spy(*args, **kw):
        calls.append(kw.get("window"))
        return real(*args, **kw)
    monkeypatch.setattr(TA, "decode_attention_int8", spy)
    cfg = TC.smoke_config(TC.get_config("h2o-danube-1.8b")).replace(
        kv_quant=quant)
    p = TM.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    caches = TM.init_caches(cfg, 2, 8, torch.float32, device="cpu")
    _, out = TM.decode_step(p, torch.zeros((2, 1), dtype=torch.long), caches,
                            3, cfg)
    assert out is caches
    assert calls == ([cfg.window] * cfg.n_layers if quant else [])
