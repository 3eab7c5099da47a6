"""Port vs reference: train steps tensor-parallel over the ``model`` axis
(the dense architectures; ``test_torch_tensor_parallel_families.py`` the
MoE, SSM and xLSTM ones).

``launch/steps.py:jitted_step_for_cell`` on a ``gloo`` world of 4 CPU
ranks (``tests/torch_worlds.py tensor_parallel``, one subprocess for the
module with its own wall limit), on a 1x4 and a 2x2 ``(data, model)`` mesh
of that world: each rank computes with its ``model`` shard of every
parameter (column- and row-parallel heads and ``d_ff``, expert
parallelism, the SSM/xLSTM ``inner`` dim, vocabulary-parallel logits and
cross-entropy).  One float32 step and one mixed-precision step of each
architecture's smoke config (resolved for a model axis of 4, which 2
divides too) are held against the port's one-device step of the same
config and the reference's ``make_train_step``, at the tolerances of
``tests/test_torch_mesh_train.py``: the loss, the grad norm, each leaf's
clipped gradient (Adam's first moment after the step, at a tolerance
relative to the leaf's largest) and each parameter; every leaf replicated
over ``model`` must be bitwise the same on the ranks of a ``model`` group.
Here also ``remat`` full and dots on
a mesh, and unit cases of the vocabulary-parallel cross-entropy and of
each collective's backward.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as r_get, smoke_config as r_smoke
from repro.launch import steps as RS
from repro.models import model as RM
from repro.optim import adamw as RA

from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as TM, params_from_jax
from repro_torch.optim import adamw
from repro_torch.sharding.rules import tree_leaves, tree_map, tree_paths
from test_torch_lm import ROOT
from test_torch_train_model import GEMMA3_REL, GRAD_REL, SSM_LOOSE
from test_torch_mesh_train import (GNORM_RTOL, LOSS_RTOL, OPT, PARAM_TOL,
                                   reference_order)
from test_torch_shard_map import WORLDS
from torch_worlds import (COLLECTIVES, collective_input, collective_weight,
                          vocab_case)

ARCHS = ("qwen3-1.7b", "gemma3-12b", "h2o-danube-1.8b", "internvl2-2b",
         "minitron-8b", "musicgen-medium", "dbrx-132b", "mixtral-8x22b",
         "zamba2-1.2b", "xlstm-1.3b")
#: the model axis the configs are resolved for (the 2x2 mesh's 2 divides
#: every head count so resolved)
TP = 4
#: one period of a long layer pattern; two layers of the others
LAYERS = {"gemma3-12b": 6, "xlstm-1.3b": 8, "zamba2-1.2b": 6}
B, S = 4, 16
#: the subprocess's wall limit, seconds (the world's own is smaller)
WALL_S = 240
#: the first moment after one step is ``(1 - b1)`` times the clipped
#: gradient: each leaf of the mesh's is held against one device's (and the
#: reference's) at ``GRAD_REL`` of the leaf's max |g| in float32 and at
#: ``BF16_NOISE`` of it in mixed precision (one bfloat16 rounding of each
#: shard's gradient, see below); gemma3 and zamba2's per-channel SSM
#: leaves at the looser bounds ``test_torch_train_model.py`` reads there,
#: the conv's bias among them in mixed precision (its gradient, too, a sum
#: over every position: it read 7.1e-3 of its max on 2x2 against
#: ``BF16_NOISE``'s 7.8e-3; the junit XML's ``grad_rel_err`` property).
#: A parameter after Adam's first step moves by ``lr * g / (|g| + eps)``,
#: ``lr * sign(g)`` but within a few ``eps`` of zero.  Where the clipped
#: gradient ``g`` is within rounding noise of zero, a sum taken in another
#: order may flip that sign, moving the update by up to ``2 * lr``; such
#: elements are held to that, every other one to ``PARAM_TOL``.  The noise:
#: float32, ~1e-9 on these leaves (largest gradients ~1e-2; read), so
#: under ``SIGN_OF_NOISE``; mixed precision, a bfloat16 gradient of each
#: batch shard (one rounding, 2^-9 of a partial sum no larger than the
#: leaf's largest gradient) summed, so under ``BF16_NOISE`` of the leaf's
#: largest gradient
SIGN_OF_NOISE = 1e-6
BF16_NOISE = 2.0 ** -7
#: gemma3's smoke model (qk-norm off) amplifies float32 rounding: its
#: gradients move by up to ``GEMMA3_REL`` of a leaf's largest under a
#: one-ulp change (``test_torch_train_model.py``), so that is its noise
ARCH_NOISE = {"gemma3-12b": GEMMA3_REL}


def run_world(world, work, inputs):
    """Run one world of ``tests/torch_worlds.py`` on ``inputs``; its
    per-rank results."""
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, WORLDS, world, str(work)],
                         capture_output=True, text=True, env=env,
                         timeout=WALL_S)
    assert out.returncode == 0, out.stderr[-4000:]
    return torch.load(os.path.join(work, "results.pt"),
                      weights_only=False)["ranks"]


def case_configs(case):
    """(reference config, port config) of a case: the smoke config with
    its keywords, resolved for its model axis."""
    from repro_torch.configs import get_config, smoke_config
    return (r_smoke(r_get(case["arch"])).replace(**case["kw"])
            .resolve_for_tp(case["tp"]),
            smoke_config(get_config(case["arch"])).replace(**case["kw"])
            .resolve_for_tp(case["tp"]))


def reference_params(rcfg, seed):
    return jax.jit(lambda k: RM.init(rcfg, k))(jax.random.PRNGKey(seed))


def train_batch(cfg, seed, rows=B, skew=False):
    """Tokens and labels whose masked labels differ across batch shards;
    ``skew``: each quarter of the rows draws its tokens from its own
    quarter of the vocabulary (so the shards route differently)."""
    rng = np.random.default_rng(seed)
    F = cfg.frontend_len if cfg.frontend else 0
    tokens = rng.integers(0, 256, (rows, S - F)).astype(np.int32)
    if skew:
        for q in range(4):
            part = slice(q * rows // 4, (q + 1) * rows // 4)
            tokens[part] = rng.integers(64 * q, 64 * q + 64,
                                        tokens[part].shape)
    labels = rng.integers(0, 256, (rows, S - F)).astype(np.int32)
    labels[1, :7] = -1
    labels[-1, :3] = -1
    out = {"tokens": tokens, "labels": labels}
    if F:
        out["frontend_embeds"] = rng.standard_normal(
            (rows, F, cfg.d_model)).astype(np.float32)
    return out


def make_case(arch, kw=None, meshes=("1x4", "2x2"), precisions=(False, True),
              microbatches=1, rows=B, skew=False, reference=True, seed=3):
    kw = {"n_layers": LAYERS.get(arch, 2), **(kw or {})}
    case = {"arch": arch, "kw": kw, "tp": TP, "meshes": meshes,
            "precisions": precisions, "microbatches": microbatches,
            "reference": reference}
    rcfg, tcfg = case_configs(case)
    case["rp"] = reference_params(rcfg, seed)
    case["params"] = params_from_jax(jax.tree.map(np.asarray, case["rp"]),
                                     tcfg, device="cpu",
                                     dtype=torch.float32)
    case["batch"] = train_batch(tcfg, seed, rows, skew)
    return case


#: the special cases of either module: name -> its ``make_case`` arguments
SPECIAL = {
    # the MoE auxiliary loss over shards that route differently
    "dbrx_routing": dict(arch="dbrx-132b", meshes=("2x2", "4x1", "1x4"),
                         precisions=(False,), skew=True),
    # 16 rows in 8 microbatches: 2 a microbatch over 4 batch shards
    "padded": dict(arch="dbrx-132b", meshes=("4x1", "2x2"),
                   precisions=(False,), microbatches=8, rows=16, skew=True),
    # 2 experts on a model axis of 4: each expert's ffn split
    "ffn_split": dict(arch="mixtral-8x22b", kw={"n_experts": 2, "top_k": 1},
                      meshes=("1x4",), precisions=(False,), reference=False),
    # 2 heads on 4: mLSTM's recurrence whole on each rank
    "xlstm_2_heads": dict(arch="xlstm-1.3b", kw={"n_heads": 2,
                                                 "n_kv_heads": 2},
                          meshes=("1x4",), precisions=(False,),
                          reference=False),
    # the dropless dispatch: each rank's experts over its slice of rows
    "moe_csr": dict(arch="dbrx-132b", kw={"moe_dispatch": "csr"},
                    meshes=("1x4", "2x2"), precisions=(False,),
                    reference=False),
    **{f"remat_{r}": dict(arch="qwen3-1.7b", kw={"remat": r},
                          meshes=("1x4",), precisions=(False,),
                          reference=False) for r in ("full", "dots")},
}
#: this module's architectures and special cases (the MoE, SSM and xLSTM
#: families' are in ``test_torch_tensor_parallel_families.py``: a module
#: a world, so the two run on two workers)
HERE = ARCHS[:6]
HERE_SPECIAL = ("remat_full", "remat_dots")


def cases(archs, special):
    out = {a: make_case(a) for a in archs}
    for key in special:
        out[key] = make_case(**SPECIAL[key])
    return out


@pytest.fixture(scope="module")
def inputs():
    return cases(HERE, HERE_SPECIAL)


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    return world_of(tmp_path_factory, inputs)


def world_of(tmp_path_factory, inputs):
    sent = {k: {f: v for f, v in c.items() if f != "rp"}
            for k, c in inputs.items()}
    return run_world("tensor_parallel",
                     tmp_path_factory.mktemp("tensor_parallel"),
                     {"cases": sent, "opt": OPT})


def one_device(case, mixed):
    """(port metrics, port params, reference metrics, reference params)
    after the case's one train step on one device."""
    rcfg, tcfg = case_configs(case)
    mb = case["microbatches"]
    t_step = make_train_step(tcfg, adamw.AdamWConfig(**OPT),
                             microbatches=mb, mixed_precision=mixed)
    tp = tree_map(torch.clone, case["params"])
    if mixed:
        t_s = adamw.init_mixed(tree_map(torch.clone, tp))
        tp = tree_map(lambda t: t.to(torch.bfloat16), tp)
    else:
        t_s = adamw.init(tp)
    tp, t_s, tm = t_step(tp, t_s, {k: torch.from_numpy(v).long()
                                   if v.dtype == np.int32 else
                                   torch.from_numpy(v)
                                   for k, v in case["batch"].items()})
    port = ((float(tm["loss"]), float(tm["grad_norm"])),
            [t.float().numpy() for t in tree_leaves(
                t_s.master if mixed else tp)],
            [t.numpy() for t in tree_leaves(t_s.m)])
    if not case["reference"]:
        return port, None
    rp = case["rp"]
    r_step = jax.jit(RS.make_train_step(rcfg, RA.AdamWConfig(**OPT),
                                        microbatches=mb,
                                        mixed_precision=mixed))
    if mixed:
        r_p, r_s = jax.tree.map(lambda a: a.astype(jnp.bfloat16), rp), \
            RA.init_mixed(rp)
    else:
        r_p, r_s = rp, RA.init(rp)
    r_p, r_s, rm = r_step(r_p, r_s, jax.tree.map(jnp.asarray,
                                                 case["batch"]))
    ref = ((float(rm["loss"]), float(rm["grad_norm"])),
           [np.asarray(a, np.float32) for a in jax.tree.leaves(
               r_s.master if mixed else r_p)],
           [np.asarray(a, np.float32) for a in jax.tree.leaves(r_s.m)],
           [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(r_s.m)[0]])
    return port, ref


def grad_rel(kind, arch, path):
    """A gradient leaf's tolerance, relative to its max |g| (see
    ``BF16_NOISE``); zamba2's per-channel SSM leaves, whose sums cancel,
    keep their float32 factor over ``GRAD_REL`` in mixed precision too."""
    rel = GRAD_REL if kind == "f32" else BF16_NOISE
    loose = dict(SSM_LOOSE) if kind == "f32" else {
        **SSM_LOOSE, "['mamba']['conv_b']": max(SSM_LOOSE.values())}
    if arch == "zamba2-1.2b":
        rel *= max([1.0] + [v / GRAD_REL for k, v in loose.items()
                            if path.endswith(k)])
    return max(rel, ARCH_NOISE.get(arch, 0.0))


def assert_moments(got, want, kind, arch, paths):
    """Each leaf's first moment (the clipped gradient, scaled) within
    :func:`grad_rel` of the leaf's max |g|; the largest such share."""
    worst = (0.0, "")
    for a, b, path in zip(got, want, paths, strict=True):
        err = float(np.abs(a - b).max()) / max(float(np.abs(b).max()),
                                               1e-30)
        assert err <= grad_rel(kind, arch, path), (path, err)
        worst = max(worst, (err, path))
    return worst


def assert_close(got, want, kind, g, arch):
    """``PARAM_TOL`` for every element whose gradient is clear of rounding
    noise, ``2 * lr`` for the rest (see ``SIGN_OF_NOISE``); the share of
    elements in the second class."""
    rel = max(ARCH_NOISE.get(arch, 0.0), 0.0 if kind == "f32"
              else BF16_NOISE)
    noise = max(SIGN_OF_NOISE, rel * float(np.abs(g).max()))
    off = ~np.isclose(got, want, **PARAM_TOL)
    clear = np.abs(g) >= noise
    assert not (off & clear).any(), (np.abs(got - want)[off & clear].max(),
                                     np.abs(g)[off & clear].min())
    lr = adamw.AdamWConfig(**OPT).lr
    assert np.abs(got - want).max() <= 2 * lr + PARAM_TOL["atol"]
    return int((~clear).sum())


def assert_replicas(world, key, mesh, kind):
    """Every leaf replicated over ``model``: its parameter and first moment
    bitwise the same on each rank of a ``model`` group."""
    groups = {}
    for r in world:
        got = r[key, mesh, kind]
        groups.setdefault(got["peers"], []).append(got["replicated"])
    for reps in groups.values():
        assert len(reps) > 1 or mesh.endswith("x1")
        for other in reps[1:]:
            assert other.keys() == reps[0].keys()
            for i, (p, m) in reps[0].items():
                assert np.array_equal(p, other[i][0]), (key, mesh, i)
                assert np.array_equal(m, other[i][1]), (key, mesh, i)


def assert_step(world, inputs, key, record_property=None):
    case = inputs[key]
    _, tcfg = case_configs(case)
    paths = ["".join(f"[{k!r}]" for k in path)
             for path in tree_paths(TM.model_spec(tcfg))]
    b1 = 1 - adamw.AdamWConfig(**OPT).b1
    for mixed in case["precisions"]:
        kind = "mixed" if mixed else "f32"
        port, ref = one_device(case, mixed)
        grads = [m / b1 for m in port[2]]
        for mesh in case["meshes"]:
            for r in world:
                got = r[key, mesh, kind]
                assert got["model_shards"], (key, mesh)
                assert got["loss"] == pytest.approx(port[0][0],
                                                    rel=LOSS_RTOL), mesh
                assert got["grad_norm"] == pytest.approx(port[0][1],
                                                         rel=GNORM_RTOL)
                if ref is not None:
                    assert got["loss"] == pytest.approx(ref[0][0],
                                                        rel=LOSS_RTOL)
                    assert got["grad_norm"] == pytest.approx(
                        ref[0][1], rel=GNORM_RTOL)
            assert_replicas(world, key, mesh, kind)
            params = world[0][key, mesh, kind]["params"]
            moment = world[0][key, mesh, kind]["moment"]
            err = assert_moments(moment, port[2], kind, case["arch"], paths)
            noisy = sum(assert_close(a, b, kind, g, case["arch"])
                        for a, b, g in zip(params, port[1], grads,
                                           strict=True))
            if record_property is not None:
                record_property(f"{mesh}/{kind}/sign_noise_share",
                                noisy / sum(g.size for g in grads))
                record_property(f"{mesh}/{kind}/grad_rel_err", err[0])
                record_property(f"{mesh}/{kind}/grad_worst_leaf", err[1])
            if ref is not None:
                assert_moments(reference_order(moment, tcfg), ref[2], kind,
                               case["arch"], ref[3])
                for a, b, g in zip(reference_order(params, tcfg), ref[1],
                                   reference_order(grads, tcfg),
                                   strict=True):
                    assert_close(a, b, kind, g, case["arch"])


@pytest.mark.parametrize("arch", HERE)
def test_tensor_parallel_train_step_matches_one_device_and_the_reference(
        world, inputs, arch, record_property):
    """Loss, grad norm, every leaf's clipped gradient and every parameter
    (the float32 masters when mixed) after one step on 1x4 and 2x2,
    float32 and mixed precision; each rank computed with its ``model``
    shards, and its replicated leaves are its group's bit for bit."""
    assert_step(world, inputs, arch, record_property)


@pytest.mark.parametrize("key", HERE_SPECIAL)
def test_tensor_parallel_layouts_match_one_device(world, inputs, key,
                                                  record_property):
    """qwen3 under ``remat="full"`` and ``"dots"`` (the collectives
    recomputed in the backward): one device's step."""
    assert_step(world, inputs, key, record_property)


# ---------------------------------------------------------------------------
# unit cases (their rank halves ran in the same world, on the 1x4 mesh)
# ---------------------------------------------------------------------------
def test_vocabulary_parallel_cross_entropy_is_the_whole_vocabs(world):
    """The LM head and cross-entropy on 4 ranks of a model axis, the
    vocabulary 200 padded to 256 (the last rank's 64 columns: 8 real, 56
    pad, masked by their global index): the summed NLL and count, the
    hidden state's gradient and each rank's slice of the head's gradient
    equal the whole-vocabulary loss on one rank; no logit is gathered."""
    want = vocab_case(None)
    for r in world:
        got = r["vocab"]
        assert got["nll"] == pytest.approx(want["nll"], rel=1e-6)
        assert got["count"] == want["count"]
        np.testing.assert_allclose(got["d_x"], want["d_x"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(got["d_head"], want["d_head"][
            :, got["lo"]:got["hi"]], rtol=1e-5, atol=1e-7)
        assert got["gathers"] == 0


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_each_collectives_backward_is_autograd_through_the_gather(world,
                                                                 name):
    """Each rank's forward and input gradient of ``name`` on 4 ranks
    against autograd of the same computation written on every rank's
    tensors in one process (``torch_worlds.COLLECTIVES`` says how each
    rank uses the result)."""
    _, own, shared, whole = COLLECTIVES[name]
    xs = [collective_input(0 if shared else r) for r in range(4)]
    leaves = [x.clone().requires_grad_() for x in (xs[:1] if shared
                                                   else xs)]
    outs = [whole(leaves, r) for r in range(4)]
    loss = (sum((o * collective_weight(r, o.shape)).sum()
                for r, o in enumerate(outs)) if own
            else (outs[0] * collective_weight(0, outs[0].shape)).sum())
    grads = torch.autograd.grad(loss, leaves)
    for r, res in enumerate(world):
        y, g = res["collectives"][name]
        np.testing.assert_allclose(y, outs[r].detach().numpy(), rtol=1e-6)
        np.testing.assert_allclose(g, grads[0 if shared else r].numpy(),
                                   rtol=1e-6)
