"""Port vs reference: prefill and decode tensor-parallel over ``model``.

``launch/steps.py:jitted_step_for_cell``'s prefill and decode cells on a
1x4 and a 2x2 ``(data, model)`` mesh of one ``gloo`` world of 4 CPU ranks
(``tests/torch_worlds.py tensor_parallel_serve``): each rank runs its
``model`` shard of every parameter on its batch rows, writes its KV heads
and state heads of the int8-KV caches (``cache_sharding``), and the next
token is the argmax of the logits gathered over ``model``.  For each of
the ten architectures' smoke configs (resolved for a model axis of 4): the
prefill's token and two decode steps' tokens are the port's one-device
steps' and the reference's ``make_prefill_step`` / ``make_serve_step``'s,
and the caches after them the port's one-device caches (int8 codes within
one step, every other leaf within 1e-2 as in
``tests/test_torch_mesh_train.py``).
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
from repro_torch.sharding.rules import tree_leaves
from test_torch_tensor_parallel import (ARCHS, LAYERS, TP, case_configs,
                                        params_from_jax, reference_params,
                                        run_world)

B, SP, STEPS = 4, 12, 2
#: a cache leaf's tolerance (int8 codes: within one step)
CACHE_TOL = dict(rtol=1e-2, atol=1e-6)


def serve_case(arch, kw=None, meshes=("1x4", "2x2"), seed=5):
    kw = {"n_layers": LAYERS.get(arch, 2), **(kw or {})}
    case = {"arch": arch, "kw": kw, "tp": TP, "meshes": meshes,
            "steps": STEPS}
    rcfg, tcfg = case_configs(case)
    case["rp"] = reference_params(rcfg, seed)
    case["params"] = params_from_jax(jax.tree.map(np.asarray, case["rp"]),
                                     tcfg, device="cpu",
                                     dtype=torch.float32)
    rng = np.random.default_rng(seed)
    case["prompt"] = {"tokens": rng.integers(0, 256, (B, SP)).astype(
        np.int32)}
    if tcfg.frontend:
        case["prompt"]["frontend_embeds"] = rng.standard_normal(
            (B, tcfg.frontend_len, tcfg.d_model)).astype(np.float32)
    return case


@pytest.fixture(scope="module")
def inputs():
    out = {a: serve_case(a) for a in ARCHS}
    # 2 heads on 4: mLSTM's recurrence whole on each rank, its caches
    # replicated; sLSTM on each head's units
    out["xlstm_2_heads"] = serve_case("xlstm-1.3b", {"n_heads": 2,
                                                     "n_kv_heads": 2},
                                      meshes=("1x4",))
    # 2 experts on 4: each expert's ffn split
    out["ffn_split"] = serve_case("mixtral-8x22b", {"n_experts": 2,
                                                    "top_k": 1},
                                  meshes=("1x4",))
    # the paper's rule per call: D_mat from the global batch's counts, so
    # every rank of a model group takes the same branch
    out["moe_auto"] = serve_case("dbrx-132b", {"moe_dispatch": "auto"})
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    sent = {k: {f: v for f, v in c.items() if f != "rp"}
            for k, c in inputs.items()}
    return run_world("tensor_parallel_serve",
                     tmp_path_factory.mktemp("tensor_parallel_serve"),
                     {"cases": sent})


def one_device(case):
    """(port tokens, port caches, reference tokens) of the case's prefill
    and decode steps on one device."""
    rcfg, tcfg = case_configs(case)
    rcfg, tcfg = rcfg.replace(kv_quant=True), tcfg.replace(kv_quant=True)
    F = tcfg.frontend_len if tcfg.frontend else 0
    max_len = SP + F + STEPS
    prompt = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in case["prompt"].items()}
    caches = TM.init_caches(tcfg, B, max_len, torch.float32, device="cpu")
    tok, caches = make_prefill_step(tcfg)(case["params"], prompt, caches)
    toks = [tok.numpy()]
    step = make_serve_step(tcfg)
    for i in range(STEPS):
        tok, caches = step(case["params"], tok, caches, SP + F + i)
        toks.append(tok.numpy())
    r_caches = RM.init_caches(rcfg, B, max_len, jnp.float32)
    r_tok, r_caches = jax.jit(RS.make_prefill_step(rcfg))(
        case["rp"], jax.tree.map(jnp.asarray, case["prompt"]), r_caches)
    r_toks = [np.asarray(r_tok)]
    r_step = jax.jit(RS.make_serve_step(rcfg))
    for i in range(STEPS):
        r_tok, r_caches = r_step(case["rp"], r_tok, r_caches, SP + F + i)
        r_toks.append(np.asarray(r_tok))
    return toks, [(t.float().numpy(), t.dtype)
                  for t in tree_leaves(caches)], r_toks


def assert_serving(world, inputs, key):
    case = inputs[key]
    toks, caches, r_toks = one_device(case)
    for a, b in zip(toks, r_toks, strict=True):
        np.testing.assert_array_equal(a, b)
    for mesh in case["meshes"]:
        for r in world:
            got = r[key, mesh]
            for a, b in zip(got["tokens"], toks, strict=True):
                np.testing.assert_array_equal(a, b, err_msg=mesh)
        got = world[0][key, mesh]["caches"]
        for a, (b, dtype) in zip(got, caches, strict=True):
            if dtype == torch.int8:
                assert np.abs(a - b).max() <= 1.0
            else:
                np.testing.assert_allclose(a, b, **CACHE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_prefill_and_decode_match_one_device(world, inputs,
                                                             arch):
    """The prefill's token, two decode steps' tokens and the caches after
    them, on 1x4 and 2x2: one device's and the reference's tokens, one
    device's caches."""
    assert_serving(world, inputs, arch)


@pytest.mark.parametrize("key", ["xlstm_2_heads", "ffn_split", "moe_auto"])
def test_tensor_parallel_serving_layouts_match_one_device(world, inputs,
                                                          key):
    assert_serving(world, inputs, key)


def test_caches_hold_the_ranks_model_shards(world):
    """Attention K/V over KV heads, Mamba-2's ``h`` over heads, mLSTM's
    states over heads and sLSTM's over units: each cache leaf the rank
    keeps is its ``model`` shard where the blocks compute so (zamba2's 2
    SSM heads on the 2x2 mesh's model axis of 2); the mamba conv cache
    replicated."""
    places = {arch: world[0][arch, mesh]["model_shards"]
              for arch, mesh in (("qwen3-1.7b", "1x4"), ("zamba2-1.2b", "2x2"),
                                 ("xlstm-1.3b", "1x4"))}
    assert all("Shard(dim=2)" in p for p in places["qwen3-1.7b"])
    assert any("Shard(dim=1)" in p for p in places["zamba2-1.2b"])
    assert any(p.endswith("Replicate())") for p in places["zamba2-1.2b"])
    assert any("Shard(dim=1)" in p for p in places["xlstm-1.3b"])
    assert any("Shard(dim=2)" in p for p in places["xlstm-1.3b"])
