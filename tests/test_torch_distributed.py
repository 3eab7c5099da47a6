"""Port vs reference: the five multi-device cases of
``tests/test_distributed.py``, in one ``gloo`` world of 8 CPU ranks.

The reference runs each case under 8 forced XLA host devices; the port
runs all five in one world (``tests/torch_worlds.py distributed``, one
subprocess for the module with its own wall limit, then a world of one for
the 1x1 mesh), and each case here reads the ranks' results and holds them
against the reference computed in this process:

  * GPipe (two 4-stage pipelines on a 2x4 ``(data, pipe)`` mesh) against
    the port's and the reference's ``reference_forward``, and
    ``bubble_fraction``;
  * the int8 compressed all-reduce, each rank its row of the stacked
    trees, against the reference's ``compressed_psum_mean`` under
    ``jax.vmap(..., axis_name="data")`` — the same means and error state,
    twice (the second step re-injects the error) — and the reference's
    0.02 bound against the exact mean;
  * the elastic re-shard: saved on a 4x2 mesh and restored on 8 as
    ``(None, "data")``, read by the reference's ``restore`` here; saved on
    8 and restored on 4x2; a checkpoint the reference wrote restored on 8;
  * the rules: ``spec_for`` against the reference's for every parameter
    of the ten configs' smoke spec on 1x1, 2x2x2, 8x1 and 8 meshes (a
    stand-in mesh: the rule reads only the axis names and sizes), and the
    placements by ``distribute_tensor`` on those meshes in the world;
  * dbrx's MoE at smoke size on a (2, 4) mesh against the reference's
    one-device ``forward``.
"""
import os
import types

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint import restore as r_restore, save as r_save
from repro.configs import ARCH_IDS
from repro.models import model as RM
from repro.optim.compress import compressed_psum_mean as r_compressed
from repro.pipeline import reference_forward as r_reference_forward
from repro.sharding import rules as RR

from repro_torch.checkpoint.ckpt import _leaf_paths
from repro_torch.models import params_from_jax
from repro_torch.models.convert import jax_spec
from repro_torch.pipeline import bubble_fraction, reference_forward
from repro_torch.sharding import rules as TR
from test_torch_lm import configs, reference_params
from test_torch_shard_map import run_world

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "8": ((8,), ("data",))}
#: leaves placed in the world, by logical axes and shape
RULES_SHAPES = [(("batch", "seq", "embed"), (16, 32, 64)),
                (("embed", "ffn"), (64, 128)),
                (("vocab", "embed"), (256, 64)),
                (("layers", "embed", "heads"), (3, 64, 8))]


def standin(shape, axes):
    """What ``spec_for`` reads of a mesh, in the reference's spelling."""
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 shape=dict(zip(axes, shape)))


@pytest.fixture(scope="module")
def moe_setup():
    rcfg, tcfg = configs("dbrx-132b", n_layers=2, capacity_factor=4.0)
    rp = reference_params(rcfg, 0)
    tokens = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (4, 32)).astype(np.int32)
    want, _ = RM.forward(rp, {"tokens": jnp.asarray(tokens)}, rcfg)
    tp = params_from_jax(jax.tree.map(np.array, rp), tcfg, device="cpu")
    return tp, tokens, np.asarray(want, np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory, moe_setup):
    work = tmp_path_factory.mktemp("distributed")
    rng = np.random.default_rng(0)
    pipe_params = {"w": (rng.normal(size=(4, 16, 16)) * 0.3)
                   .astype(np.float32),
                   "b": (rng.normal(size=(4, 16)) * 0.1).astype(np.float32)}
    grads = {"w": rng.normal(size=(8, 64, 32)).astype(np.float32),
             "b": rng.normal(size=(8, 32)).astype(np.float32)}
    ref_ckpt = str(work / "ref_ckpt")
    r_save(ref_ckpt, 3, {"z": jnp.arange(64.0).reshape(8, 8) * 7.0})
    tp, tokens, _ = moe_setup
    inputs = {"pipe_params": pipe_params,
              "pipe_x": rng.normal(size=(6, 2, 16)).astype(np.float32),
              "grads": grads, "ckpt": str(work / "ckpt"),
              "ref_ckpt": ref_ckpt, "rules_shapes": RULES_SHAPES,
              "moe_params": tp, "moe_tokens": tokens}
    got = run_world("distributed", work, inputs)
    return inputs, got["ranks"], got["one"]


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------
def test_pipeline_parallel_matches_sequential(world):
    inputs, ranks, _ = world
    p = inputs["pipe_params"]
    x = inputs["pipe_x"]
    want = np.asarray(r_reference_forward(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        stage_fn=lambda q, h: jnp.tanh(h @ q["w"] + q["b"])))
    mine = reference_forward({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x),
                             stage_fn=lambda q, h: torch.tanh(
                                 h @ q["w"] + q["b"])).numpy()
    np.testing.assert_allclose(mine, want, rtol=2e-5, atol=2e-5)
    for r in ranks:
        np.testing.assert_allclose(r["pipe"], want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["pipe"], mine, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["pipe_sequential"], mine, rtol=0,
                                   atol=0)
    assert abs(bubble_fraction(4, 6) - 3 / 9) < 1e-9


# ---------------------------------------------------------------------------
# the compressed all-reduce
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_compressed(world):
    inputs, _, _ = world
    grads = jax.tree.map(jnp.asarray, inputs["grads"])
    step = jax.vmap(lambda g, e: r_compressed(g, e, "data"),
                    axis_name="data")
    err0 = jax.tree.map(lambda g: jnp.zeros_like(g, jnp.float32), grads)
    mean, err = step(grads, err0)
    mean2, err2 = step(grads, err)
    return {k: jax.tree.map(np.asarray, v) for k, v in
            (("mean", mean), ("err", err), ("mean2", mean2),
             ("err2", err2))}


@pytest.mark.parametrize("what", ("mean", "err", "mean2", "err2"))
def test_compressed_allreduce_is_the_references_under_vmap(
        world, reference_compressed, what):
    _, ranks, _ = world
    for rank, r in enumerate(ranks):
        for k, got in r["compress"][what].items():
            want = reference_compressed[what][k][rank]
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 1e-6 * scale, (what, k)


def test_int8_compressed_allreduce_close_to_exact(world):
    inputs, ranks, _ = world
    for r in ranks:
        for k, got in r["compress"]["mean"].items():
            want = inputs["grads"][k].mean(0)
            rel = np.abs(got - want).max() / np.abs(want).max()
            assert rel < 0.02, rel      # int8 quantization error bound
        assert any(np.abs(e).max() > 0
                   for e in r["compress"]["err"].values())


# ---------------------------------------------------------------------------
# elastic re-shard
# ---------------------------------------------------------------------------
def test_elastic_checkpoint_reshard(world):
    """Saved under a 4x2 mesh, restored under 8 ranks as ``(None,
    "data")``; the reference reads the same checkpoint whole."""
    inputs, ranks, _ = world
    want = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for r in ranks:
        e = r["elastic"]
        np.testing.assert_array_equal(e["full"], want)
        assert e["placements"] and e["local"] == (8, 1)
    got, _ = r_restore(inputs["ckpt"], 1, {"x": jax.ShapeDtypeStruct(
        (8, 8), jnp.float32)}, verify=True)
    np.testing.assert_array_equal(np.asarray(got["x"]), want)


def test_elastic_checkpoint_reshard_the_other_way(world):
    """Saved under 8 ranks, restored under 4x2; and a checkpoint the
    reference wrote restored under 8 ranks."""
    inputs, ranks, _ = world
    want = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for r in ranks:
        e = r["elastic"]
        np.testing.assert_array_equal(e["back"], want * 3.0)
        assert e["back_placements"]
        np.testing.assert_array_equal(e["ref"], want * 7.0)
    got, _ = r_restore(inputs["ckpt"], 2, {"y": jax.ShapeDtypeStruct(
        (8, 8), jnp.float32)}, verify=True)
    np.testing.assert_array_equal(np.asarray(got["y"]), want * 3.0)


# ---------------------------------------------------------------------------
# the rules across mesh shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", tuple(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_is_the_references(arch, mesh):
    """Every parameter of the smoke spec (the reference's layout, leaf by
    leaf) gets the reference's spec on this mesh shape."""
    rcfg, tcfg = configs(arch)
    shape, axes = MESHES[mesh]
    m = standin(shape, axes)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        RM.model_spec(rcfg), is_leaf=lambda x: isinstance(x, RR.ParamSpec))
    want = {jax.tree_util.keystr(p): tuple(RR.rules_for_mesh(m).spec_for(
        s.axes, m, s.shape)) for p, s in flat}
    got = {k: TR.rules_for_mesh(m).spec_for(s.axes, m, s.shape)
           for k, s in _leaf_paths(jax_spec(tcfg))}
    assert got == want
    for name in ("RULES_SERVE", "RULES_ZERO1", "RULES_2POD"):
        for _, s in flat:
            assert getattr(TR, name).spec_for(s.axes, m, s.shape) == \
                tuple(getattr(RR, name).spec_for(s.axes, m, s.shape))


@pytest.mark.parametrize("mesh", tuple(MESHES))
def test_rules_elastic_across_mesh_shapes(world, mesh):
    """The same logical rules place on 1x1, 2x2x2, 8x1 and 8 meshes:
    ``distribute_tensor`` takes each sharding, the local shard has the
    shape the spec says, and the whole tensor comes back."""
    _, ranks, one = world
    shape, axes = MESHES[mesh]
    size = dict(zip(axes, shape))
    results = [one] if mesh == "1x1" else [r["rules"][mesh] for r in ranks]
    for got in results:
        for case, (names, full) in zip(got, RULES_SHAPES, strict=True):
            spec = TR.RULES_1POD.spec_for(names, standin(shape, axes), full)
            assert case["spec"] == spec
            assert case["spec"] == tuple(RR.RULES_1POD.spec_for(
                names, standin(shape, axes), full))
            parts = [int(np.prod([size[a] for a in
                                  (e if isinstance(e, tuple) else (e,))]))
                     if e else 1 for e in spec]
            assert case["local"] == tuple(n // p for n, p in
                                          zip(full, parts))
            assert case["round_trip"]


# ---------------------------------------------------------------------------
# MoE on a mesh
# ---------------------------------------------------------------------------
def test_moe_dispatch_sharded_equivalence(world, moe_setup):
    """dbrx's MoE layers on a (2, 4) ``(data, model)`` mesh: parameters
    placed by the rules, each rank its batch shard, the logits gathered —
    against the reference's one-device ``forward``."""
    _, ranks, _ = world
    _, _, want = moe_setup
    for r in ranks:
        np.testing.assert_allclose(r["moe"], want, rtol=2e-3, atol=2e-3)
