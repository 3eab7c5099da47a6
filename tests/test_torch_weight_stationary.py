"""Port vs reference: weight-stationary decode and context parallelism.

``launch/steps.py:jitted_step_for_cell`` runs a decode cell
weight-stationary by default, as the reference does (``RULES_SERVE``): no
parameter is gathered, each rank reads its ``data`` x ``model`` shard of
every weight, the tokens are the global batch on every rank, the residual
stream is the rank's columns of ``d`` (each product that contracts ``d``
summed over ``data``), and a block reads the cache rows the rank holds —
or, where the batch does not split over ``data`` (B = 1), its range of
the cache's slots: the attention runs K11 on them and merges the partial
softmaxes over ``data`` by their log-sum-exps (context parallelism).

One ``gloo`` world of 4 CPU ranks (``tests/torch_worlds.py
weight_stationary``) runs, on a 2x2 and a 4x1 ``(data, model)`` mesh, a
prefill and then a decode step of qwen3 (int8 and bf16 caches; one case
with a weight-stationary prefill), gemma3 (local layers, ring caches,
softcap) and xlstm (mLSTM and sLSTM) —
``test_torch_weight_stationary_families.py``: dbrx (MoE, ELL and
``"auto"``) and zamba2 (Mamba-2 and its shared block) — at B = 4 (a batch
split over ``data``) and B = 1.  Held against the port's one-device steps and the
reference's, at ``test_torch_tensor_parallel_serve.py``'s tolerances: the
tokens equal; the decode step's logits within ``test_torch_lm.py``'s
``TOL``; the caches after it (int8 codes within one step, every other
leaf within ``CACHE_TOL``).  The chokepoint: the decode step gathers
nothing over ``data`` but the attention and recurrent outputs of the
rank's batch rows (B x its heads' columns), at B = 1 nothing at all (no
cache's sequence), and it merges the softmaxes there.
The same decode step with its parameters gathered
(``serve_weight_stationary=False``) is held to the same checks: at B = 1
it runs context-parallel too.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.launch import steps as RS
from repro.models import model as RM

from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import model as TM
from repro_torch.sharding.rules import tree_leaves, tree_map
from test_torch_lm import TOL
from test_torch_tensor_parallel import (LAYERS, TP, case_configs,
                                        params_from_jax, reference_params,
                                        run_world)
from test_torch_tensor_parallel_serve import CACHE_TOL

#: logits read from int8 caches: a code one step off (``CACHE_TOL``'s
#: rule; the prefill's sums taken in another order round some codes the
#: other way) moves them by up to 1.4e-3 on gemma3's smoke model (read,
#: one device against the reference), 1e-2 of their spread
LOGIT_TOL = dict(rtol=1e-2, atol=5e-3)
#: the prompt; the caches' length (divides 2 and 4: the sequence splits
#: over ``data`` at B = 1; gemma3's 32-slot ring caches too); xlstm's, whose
#: prefill is a loop over time and whose caches have no sequence: shorter
SP, MAX_LEN = 38, 40
SHORT = {"xlstm-1.3b": (6, 8)}
MESHES = ("2x2", "4x1")


def ws_case(arch, B, kw=None, kv_quant=True, ws_prefill=None, seed=11):
    kw = {"n_layers": LAYERS.get(arch, 2), **(kw or {})}
    sp, max_len = SHORT.get(arch, (SP, MAX_LEN))
    case = {"arch": arch, "kw": kw, "tp": TP, "meshes": MESHES,
            "kv_quant": kv_quant, "ws_prefill": ws_prefill,
            "max_len": max_len}
    rcfg, tcfg = case_configs(case)
    case["rp"] = reference_params(rcfg, seed)
    case["params"] = params_from_jax(jax.tree.map(np.asarray, case["rp"]),
                                     tcfg, device="cpu",
                                     dtype=torch.float32)
    rng = np.random.default_rng(seed)
    case["prompt"] = {"tokens": rng.integers(0, 256, (B, sp)).astype(
        np.int32)}
    return case


#: name -> ws_case arguments past the batch: this module's and
#: ``test_torch_weight_stationary_families.py``'s (a module a world, so
#: the two run on two workers)
CASES = {
    "qwen3": ("qwen3-1.7b", {}),
    "qwen3_bf16": ("qwen3-1.7b", {"kv_quant": False}),
    "gemma3": ("gemma3-12b", {}),
    "xlstm": ("xlstm-1.3b", {}),
}
FAMILY_CASES = {
    "dbrx_ell": ("dbrx-132b", {"kw": {"moe_dispatch": "ell"}}),
    "dbrx_auto": ("dbrx-132b", {"kw": {"moe_dispatch": "auto"}}),
    "zamba2": ("zamba2-1.2b", {}),
}
KEYS = [(name, B) for name in CASES for B in (4, 1)]
#: a qwen3 case whose prefill runs weight-stationary too
WS_PREFILL = ("qwen3_ws_prefill", 4)


def key_id(key):
    return f"{key[0]}-B{key[1]}"


def cases_of(table):
    return {(name, B): ws_case(table[name][0], B, **table[name][1])
            for name in table for B in (4, 1)}


@pytest.fixture(scope="module")
def inputs():
    out = cases_of(CASES)
    out[WS_PREFILL] = ws_case("qwen3-1.7b", 4, ws_prefill=True)
    return out


def world_of(tmp_path_factory, inputs):
    sent = {k: {f: v for f, v in c.items() if f != "rp"}
            for k, c in inputs.items()}
    return run_world("weight_stationary",
                     tmp_path_factory.mktemp("weight_stationary"),
                     {"cases": sent})


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    return world_of(tmp_path_factory, inputs)


def one_device(case):
    """(port tokens, port logits, port caches, reference tokens,
    reference logits) of the prefill and the decode step on one
    device."""
    rcfg, tcfg = case_configs(case)
    rcfg = rcfg.replace(kv_quant=case["kv_quant"])
    tcfg = tcfg.replace(kv_quant=case["kv_quant"])
    B, SP = case["prompt"]["tokens"].shape
    MAX_LEN = case["max_len"]
    prompt = {"tokens": torch.from_numpy(case["prompt"]["tokens"]).long()}
    caches = TM.init_caches(tcfg, B, MAX_LEN, torch.float32, device="cpu")
    tok, caches = make_prefill_step(tcfg)(case["params"], prompt, caches)
    with torch.no_grad():
        logits, _ = TM.decode_step(case["params"], tok,
                                   tree_map(torch.clone, caches), SP, tcfg)
    nxt, caches = make_serve_step(tcfg)(case["params"], tok, caches, SP)
    r_caches = RM.init_caches(rcfg, B, MAX_LEN, jnp.float32)
    r_tok, r_caches = jax.jit(RS.make_prefill_step(rcfg))(
        case["rp"], jax.tree.map(jnp.asarray, case["prompt"]), r_caches)
    r_logits, _ = jax.jit(lambda p, t, c: RM.decode_step(p, t, c, SP, rcfg))(
        case["rp"], r_tok, r_caches)
    r_nxt, _ = jax.jit(RS.make_serve_step(rcfg))(case["rp"], r_tok,
                                                 r_caches, SP)
    vocab = tcfg.vocab_size
    return ((tok.numpy(), nxt.numpy()), logits[:, -1, :vocab].numpy(),
            [(t.float().numpy(), t.dtype) for t in tree_leaves(caches)],
            (np.asarray(r_tok), np.asarray(r_nxt)),
            np.asarray(r_logits[:, -1, :vocab], np.float32))


def expected_gathers(case, mesh):
    """The leading dim of every tensor a decode step may gather over
    ``data``: the rank's batch rows (none at B = 1: nothing splits)."""
    B = case["prompt"]["tokens"].shape[0]
    dp = int(mesh.split("x")[0])
    return None if B % dp else B // dp


#: one_device's results by case key (both decode steps are held to them)
_ONE_DEVICE = {}


def assert_decode(world, inputs, key, gathered=False):
    """The case's tokens, logits and caches on each mesh against one
    device's and the reference's (``gathered``: of the decode step with
    its parameters gathered over ``data``)."""
    case = inputs[key]

    def result(r, mesh):
        got = r[key, mesh]
        return {**got, **got["gathered"]} if gathered else got
    tol = LOGIT_TOL if case["kv_quant"] else TOL
    if key not in _ONE_DEVICE:
        _ONE_DEVICE[key] = one_device(case)
    toks, logits, caches, r_toks, r_logits = _ONE_DEVICE[key]
    for a, b in zip(toks, r_toks, strict=True):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(logits, r_logits, **tol)
    vocab = logits.shape[-1]
    for mesh in MESHES:
        for r in world:
            got = result(r, mesh)
            np.testing.assert_array_equal(got["prefill"], toks[0],
                                          err_msg=mesh)
            np.testing.assert_array_equal(got["decode"], toks[1],
                                          err_msg=mesh)
            np.testing.assert_allclose(got["logits"][:, :vocab], logits,
                                       **tol, err_msg=mesh)
            np.testing.assert_allclose(got["logits"][:, :vocab], r_logits,
                                       **tol, err_msg=mesh)
        got = result(world[0], mesh)["caches"]
        for a, (b, dtype) in zip(got, caches, strict=True):
            if dtype == torch.int8:
                assert np.abs(a - b).max() <= 1.0, mesh
            else:
                np.testing.assert_allclose(a, b, **CACHE_TOL, err_msg=mesh)


def assert_no_parameter_gathered(world, inputs, key):
    """Over ``data`` the decode step gathers only tensors of the rank's
    batch rows (B = 4), or nothing at all (B = 1: every rank holds the
    batch, and a cache's sequence stays split); it all-reduces there (the
    partial products, and at B = 1 the softmax merge)."""
    case = inputs[key]
    for mesh in MESHES:
        rows = expected_gathers(case, mesh)
        for r in world:
            got = r[key, mesh]
            if rows is None:
                assert got["data_gathers"] == [], mesh
                assert got["calls"].get(("all_gather", "data"), 0) == 0
            else:
                assert got["data_gathers"], mesh
                assert {s[0] for s in got["data_gathers"]} == {rows}, (
                    mesh, got["data_gathers"])
            assert got["calls"].get(("all_reduce", "data"), 0) > 0


@pytest.mark.parametrize("key", KEYS + [WS_PREFILL], ids=key_id)
def test_weight_stationary_decode_matches_one_device_and_the_reference(
        world, inputs, key):
    assert_decode(world, inputs, key)


@pytest.mark.parametrize("key", KEYS, ids=key_id)
def test_gathered_decode_matches_one_device_and_the_reference(
        world, inputs, key):
    """``serve_weight_stationary=False``: the parameters gathered, the
    rank's batch rows (B = 4) or, at B = 1, every row over its slot range
    with the softmaxes merged (context parallelism under gathered
    parameters)."""
    assert_decode(world, inputs, key, gathered=True)


@pytest.mark.parametrize("key", KEYS, ids=key_id)
def test_the_decode_step_gathers_no_parameter_over_data(world, inputs, key):
    assert_no_parameter_gathered(world, inputs, key)


def test_a_cache_leaf_the_step_did_not_place_raises():
    """A block reads a cache leaf's batch rows or slot range from the
    serving step's record of its view; a leaf cloned or rebuilt on the way
    raises rather than being read as whole.  Outside a serving step every
    leaf is whole."""
    from repro_torch.sharding.rules import MeshContext
    split, whole = torch.zeros(2, 4), torch.zeros(2, 4)
    sp = (1, 4, 8, 8, ())
    mc = MeshContext(spans={id(split): sp, id(whole): None})
    assert mc.span(split) == sp and mc.span(whole) is None
    for t in (split.clone(), split.contiguous() + 0):
        with pytest.raises(LookupError, match="placed"):
            mc.span(t)
    assert MeshContext().span(split.clone()) is None


def test_caches_keep_their_placements(world):
    """At B = 1 the attention caches' sequence is split over ``data``
    (``Shard(dim=1)`` on it) and stays so after the decode step; at B = 4
    their batch rows."""
    for mesh in MESHES:
        one = world[0][("qwen3", 1), mesh]["placements"]
        four = world[0][("qwen3", 4), mesh]["placements"]
        assert all(p.startswith("(Shard(dim=1)") for p in one), one
        assert all(p.startswith("(Shard(dim=0)") for p in four), four
