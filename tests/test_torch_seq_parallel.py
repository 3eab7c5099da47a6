"""Port vs reference: sequence parallelism of the residual stream.

Where a config asks for it (``use_seq_sp``, the reference's default; zamba2
and xlstm turn it off) and the rules map ``seq_sp`` to ``model``, a train
step or a prefill on a mesh keeps the residual stream between the
embedding and the final norm as the rank's shard of the sequence: each
attention, MLP and MoE block all-gathers it before its column-parallel
products and reduce-scatters its row-parallel partial sums back (in place
of the all-reduce of a ``(B, S, d)`` activation), the embedding's
vocabulary-parallel partial sums are reduce-scattered, and the normed
stream is gathered once for the head.

One ``gloo`` world of 4 CPU ranks (``tests/torch_worlds.py
seq_parallel``), on a 1x4 and a 2x2 ``(data, model)`` mesh: one float32
train step and one prefill of qwen3, gemma3 and dbrx with ``use_seq_sp``
on and off.  Held against the same mesh without it, the port's one
device and the reference at ``test_torch_tensor_parallel.py``'s rules
(the loss and grad norm, each leaf's clipped gradient relative to its
largest, each parameter, the replicas bitwise alike); the prefill's token
equal.  The chokepoint: per block a reduce-scatter and an all-gather on
``model``, and no all-reduce there of anything the size of an activation.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.launch import steps as RS
from repro.models import model as RM

from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.sharding.rules import tree_paths
from test_torch_mesh_train import GNORM_RTOL, LOSS_RTOL, OPT
from test_torch_tensor_parallel import (assert_close, assert_moments,
                                        assert_step, case_configs,
                                        make_case, one_device, run_world)

ARCHS = ("qwen3-1.7b", "gemma3-12b", "dbrx-132b")
MESHES = ("1x4", "2x2")


@pytest.fixture(scope="module")
def inputs():
    out = {}
    for arch in ARCHS:
        out[arch] = make_case(arch, meshes=MESHES, precisions=(False,))
        out[arch, "off"] = make_case(arch, kw={"use_seq_sp": False},
                                     meshes=MESHES, precisions=(False,),
                                     reference=False)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    sent = {k: {f: v for f, v in c.items() if f != "rp"}
            for k, c in inputs.items()}
    return run_world("seq_parallel", tmp_path_factory.mktemp("seq_parallel"),
                     {"cases": sent, "opt": OPT})


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_parallel_train_step_matches_one_device_and_the_reference(
        world, inputs, arch):
    assert inputs[arch]["kw"].get("use_seq_sp", True)
    assert_step(world, inputs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_parallel_train_step_matches_the_mesh_without_it(world, inputs,
                                                             arch):
    """The same mesh with ``use_seq_sp=False``: the loss, the grad norm,
    each leaf's clipped gradient and each parameter."""
    case = inputs[arch]
    _, tcfg = case_configs(case)
    paths = ["".join(f"[{k!r}]" for k in path)
             for path in tree_paths(TM.model_spec(tcfg))]
    port, _ = one_device(case, False)
    grads = [m / (1 - adamw.AdamWConfig(**OPT).b1) for m in port[2]]
    for mesh in MESHES:
        on = world[0][arch, mesh, "f32"]
        off = world[0][(arch, "off"), mesh, "f32"]
        assert on["loss"] == pytest.approx(off["loss"], rel=LOSS_RTOL)
        assert on["grad_norm"] == pytest.approx(off["grad_norm"],
                                                rel=GNORM_RTOL)
        assert_moments(on["moment"], off["moment"], "f32", arch, paths)
        for a, b, g in zip(on["params"], off["params"], grads, strict=True):
            assert_close(a, b, "f32", g, arch)


def one_device_prefill(case):
    """(port token, reference token) of a prefill of the case's tokens."""
    rcfg, tcfg = case_configs(case)
    rcfg, tcfg = rcfg.replace(kv_quant=True), tcfg.replace(kv_quant=True)
    tokens = case["batch"]["tokens"]
    B, S = tokens.shape
    caches = TM.init_caches(tcfg, B, S, torch.float32, device="cpu")
    tok, _ = make_prefill_step(tcfg)(
        case["params"], {"tokens": torch.from_numpy(tokens).long()}, caches)
    r_tok, _ = jax.jit(RS.make_prefill_step(rcfg))(
        case["rp"], {"tokens": jnp.asarray(tokens)},
        RM.init_caches(rcfg, B, S, jnp.float32))
    return tok.numpy(), np.asarray(r_tok)


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_parallel_prefill_matches(world, inputs, arch):
    """The prefill's token on each mesh, with and without sequence
    parallelism, is one device's and the reference's."""
    tok, r_tok = one_device_prefill(inputs[arch])
    np.testing.assert_array_equal(tok, r_tok)
    for mesh in MESHES:
        for r in world:
            for key in (arch, (arch, "off")):
                np.testing.assert_array_equal(
                    r[key, mesh, "prefill"]["token"], tok, err_msg=mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_reduce_scatter_and_all_gather_over_model(world, inputs,
                                                         arch):
    """Each of the L blocks' two sub-blocks gathers the sequence and
    reduce-scatters its partial sums (forward) and does the reverse
    (backward); the embedding reduce-scatters and the head's input is
    gathered once: 4 L + 2 reduce-scatters on ``model`` in a train step,
    2 L + 1 in a prefill, as many all-gathers at least.  All-reduces on
    ``model`` total less than one ``(B_local, S, d)`` float32 activation
    (norm scales' gradients, the cross-entropy's statistics); without
    sequence parallelism the blocks all-reduce at least 2 L + 1
    activations and reduce-scatter nothing."""
    case = inputs[arch]
    _, tcfg = case_configs(case)
    L = tcfg.n_layers
    B, S = case["batch"]["tokens"].shape
    for mesh in MESHES:
        act = B // int(mesh.split("x")[0]) * S * tcfg.d_model * 4
        for r in world:
            train = r[arch, mesh, "f32"]["calls"]
            pre = r[arch, mesh, "prefill"]
            assert train["calls"][("reduce_scatter", "model")] == 4 * L + 2
            assert train["calls"][("all_gather", "model")] >= 4 * L + 2
            assert train["bytes"].get(("all_reduce", "model"), 0) < act
            assert pre["calls"][("reduce_scatter", "model")] == 2 * L + 1
            assert pre["calls"][("all_gather", "model")] >= 2 * L + 1
            assert pre["bytes"].get(("all_reduce", "model"), 0) < act
            off = r[(arch, "off"), mesh, "f32"]["calls"]
            assert ("reduce_scatter", "model") not in off["calls"]
            assert off["bytes"][("all_reduce", "model")] >= \
                (2 * L + 1) * act
