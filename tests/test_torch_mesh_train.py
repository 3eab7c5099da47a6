"""Port vs reference: train steps on a 2x2 ``(data, model)`` mesh.

``launch/steps.py:jitted_step_for_cell`` on a ``gloo`` world of 4 CPU ranks
(``tests/torch_worlds.py mesh_train``, one subprocess for the module with
its own wall limit): parameters and moments placed by the rules, each
rank its batch shard, the gradients summed over the data axis.  Two steps
in float32 and two mixed-precision steps, on batches whose masked labels
differ across the shards, held against the port's one-device steps and
the reference's ``make_train_step`` at the tolerances of
``tests/test_torch_launch_train.py``; and the launcher on a 2x2 mesh.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.launch import steps as RS
from repro.models import model as RM
from repro.optim import adamw as RA

from repro_torch.launch.steps import (make_prefill_step,
                                     make_serve_step, make_train_step)
from repro_torch.models import model as TM
from repro_torch.models import params_from_jax, params_to_jax
from repro_torch.optim import adamw
from repro_torch.sharding.rules import tree_leaves, tree_map
from test_torch_lm import ROOT, configs
from test_torch_shard_map import WALL_S, run_world

OPT = {"warmup_steps": 1, "total_steps": 10}
STEPS, B, S = 2, 4, 32
#: the serving cells' cache length (a 12-token prompt, then a step)
SERVE_MAX_LEN = 16
#: a loss and a grad norm against the reference's (test_torch_launch_train)
LOSS_RTOL, GNORM_RTOL = 1e-5, 1e-4
#: a parameter after two steps (the masters' tolerance there)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
#: mixed precision: the bfloat16 gradient of a shard, summed, rounds other
#: than the whole batch's, and Adam's first steps move a parameter by about
#: ``lr * sign(g)``: where ``g`` is within a bfloat16 ulp of zero the sign
#: may flip, and such an element may differ by two steps' worth of ``lr``.
#: The rest hold ``PARAM_TOL``: at least this quantile of a leaf's elements
FLIP_QUANTILE = 0.99


def batches():
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 256, (STEPS, B, S)).astype(np.int32)
    labels = rng.integers(0, 256, (STEPS, B, S)).astype(np.int32)
    # masked labels, differing across the two data shards (rows 0-1, 2-3)
    labels[:, 1, :20] = -1
    labels[:, 3, :5] = -1
    labels[1, 2, :] = -1
    return tokens, labels


@pytest.fixture(scope="module")
def setup():
    rcfg, tcfg = configs("qwen3-1.7b", n_layers=2)
    rp = RM.init(rcfg, jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu",
                         dtype=torch.float32)
    return rcfg, tcfg, rp, tp


@pytest.fixture(scope="module")
def world(tmp_path_factory, setup):
    _, _, _, tp = setup
    tokens, labels = batches()
    got = run_world("mesh_train", tmp_path_factory.mktemp("mesh_train"),
                    {"params": tp, "tokens": tokens, "labels": labels,
                     "opt": OPT, "serve_tokens": serve_tokens(),
                     "serve_max_len": SERVE_MAX_LEN})
    return got["ranks"]


def serve_tokens():
    return np.random.default_rng(4).integers(0, 256, (B, 12)).astype(
        np.int32)


@pytest.fixture(scope="module")
def one_device(setup):
    """The port's 1x1 steps and the reference's, float32 and mixed."""
    rcfg, tcfg, rp, tp = setup
    tokens, labels = batches()
    out = {}
    for mixed in (False, True):
        r_step = jax.jit(RS.make_train_step(rcfg, RA.AdamWConfig(**OPT),
                                            mixed_precision=mixed))
        t_step = make_train_step(tcfg, adamw.AdamWConfig(**OPT),
                                 mixed_precision=mixed)
        if mixed:
            r_p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), rp)
            r_s = RA.init_mixed(rp)
            t_s = adamw.init_mixed(tree_map(torch.clone, tp))
            t_p = tree_map(lambda t: t.to(torch.bfloat16), tp)
        else:
            r_p, r_s = rp, RA.init(rp)
            t_p = tree_map(torch.clone, tp)
            t_s = adamw.init(t_p)
        r_m, t_m = [], []
        for i in range(STEPS):
            batch = {"tokens": tokens[i], "labels": labels[i]}
            r_p, r_s, rm = r_step(r_p, r_s, jax.tree.map(jnp.asarray,
                                                         batch))
            t_p, t_s, tm = t_step(t_p, t_s, {
                k: torch.from_numpy(v).long() for k, v in batch.items()})
            r_m.append((float(rm["loss"]), float(rm["grad_norm"])))
            t_m.append((float(tm["loss"]), float(tm["grad_norm"])))
        r_kept = r_s.master if mixed else r_p
        t_kept = t_s.master if mixed else t_p
        out["mixed" if mixed else "f32"] = {
            "ref": (r_m, [np.asarray(a, np.float32)
                          for a in jax.tree.leaves(r_kept)]),
            "port": (t_m, [t.float().numpy() for t in tree_leaves(t_kept)])}
    return out


def reference_order(leaves, tcfg):
    """A port tree's leaves in the reference's layout and order."""
    it = iter(leaves)
    tree = tree_map(lambda _: torch.from_numpy(next(it)),
                    TM.model_spec(tcfg))
    return [np.asarray(a) for a in jax.tree.leaves(params_to_jax(tree,
                                                                 tcfg))]


@pytest.mark.parametrize("kind", ("f32", "mixed"))
def test_mesh_steps_match_one_device_and_the_reference(world, one_device,
                                                       setup, kind):
    """Losses and grad norms of both steps, and every parameter (the
    float32 masters when mixed) after them."""
    _, tcfg, _, _ = setup
    r_metrics, r_params = one_device[kind]["ref"]
    t_metrics, t_params = one_device[kind]["port"]
    for r in world:
        got = r[kind]
        assert got["step"] == STEPS
        for (gl, gn), (tl, tn), (rl, rn) in zip(
                got["metrics"], t_metrics, r_metrics, strict=True):
            assert gl == pytest.approx(tl, rel=LOSS_RTOL)
            assert gl == pytest.approx(rl, rel=LOSS_RTOL)
            assert gn == pytest.approx(tn, rel=GNORM_RTOL)
            assert gn == pytest.approx(rn, rel=GNORM_RTOL)
        for a, b in zip(got["params"], t_params, strict=True):
            assert_params_close(a, b, kind)
        for a, b in zip(reference_order(got["params"], tcfg), r_params,
                        strict=True):
            assert_params_close(a, b, kind)


def assert_params_close(got, want, kind):
    if kind == "f32":
        np.testing.assert_allclose(got, want, **PARAM_TOL)
        return
    off = ~np.isclose(got, want, **PARAM_TOL)
    assert off.mean() <= 1 - FLIP_QUANTILE, off.mean()
    lr = adamw.AdamWConfig(**OPT).lr
    assert np.abs(got - want).max() <= 2 * lr * STEPS + 1e-5


def test_mesh_params_and_moments_are_sharded_by_the_rules(world):
    """The embedding is FSDP-sharded over ``data`` and its vocab dim over
    ``model``; norm scales are replicated."""
    for r in world:
        places = r["f32"]["placements"]
        assert "Shard(dim=0)" in places[0] or "Shard(dim=1)" in places[0]
        assert any("Replicate()" in p for p in places)


def test_masked_labels_differ_across_the_shards():
    """The two data shards of each batch count different label tokens, so
    a mean of per-shard means would not be the reference's loss."""
    _, labels = batches()
    for step in labels:
        counts = [(step[:2] >= 0).sum(), (step[2:] >= 0).sum()]
        assert counts[0] != counts[1]


def test_cli_trains_on_a_2x2_mesh_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--scale", "smoke", "--steps", "3", "--seq", "32",
         "--batch", "4", "--mesh", "2x2", "--device", "cpu",
         "--ckpt-dir", str(tmp_path)],
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=WALL_S)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert len([ln for ln in lines if ln.startswith("finished")]) == 1
    assert lines[-1].startswith("finished at step 3; final loss")


def test_mesh_serving_cells_match_one_device(world, setup):
    """``jitted_step_for_cell``'s prefill and decode cells on the 2x2
    mesh (int8 KV caches placed by ``cache_sharding``: batch over
    ``data``, KV heads over ``model``): the same next tokens as the
    port's one-device ``make_prefill_step`` / ``make_serve_step``, and the
    same caches (int8 codes within one step, their scales within 1e-2)."""
    _, tcfg, _, tp = setup
    cfg = tcfg.replace(kv_quant=True)
    caches = TM.init_caches(cfg, B, SERVE_MAX_LEN, torch.float32,
                            device="cpu")
    tok, caches = make_prefill_step(cfg)(
        tp, {"tokens": torch.from_numpy(serve_tokens()).long()}, caches)
    nxt, caches = make_serve_step(cfg)(tp, tok, caches,
                                       serve_tokens().shape[1])
    want = [t.float().numpy() for t in tree_leaves(caches)]
    kinds = [t.dtype for t in tree_leaves(caches)]
    for r in world:
        got = r["serve"]
        np.testing.assert_array_equal(got["prefill"], tok.numpy())
        np.testing.assert_array_equal(got["decode"], nxt.numpy())
        assert any("Shard(dim=2)" in p for p in got["placements"])
        for a, b, kind in zip(got["caches"], want, kinds, strict=True):
            if kind == torch.int8:
                assert np.abs(a - b).max() <= 1.0
            else:
                np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-6)


def test_mesh_steps_without_donation_leave_their_arguments(world):
    """``jitted_step_for_cell(donate=False)``: the train step returns new
    parameters and moments and leaves the given ones, with the losses, grad
    norms and parameters of the in-place (donated) step; a decode step
    leaves the given caches and emits the donated step's tokens."""
    for rank in world:
        mine, donated = rank["f32_not_donated"], rank["f32"]
        assert mine["given_kept"]
        assert mine["metrics"] == donated["metrics"]
        for a, b in zip(mine["params"], donated["params"], strict=True):
            np.testing.assert_array_equal(a, b)
        serve = rank["serve"]
        assert serve["decode_not_donated"]["given_kept"]
        np.testing.assert_array_equal(serve["decode_not_donated"]["decode"],
                                      serve["decode"])
