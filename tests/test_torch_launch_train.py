"""The port's training launcher and its step helpers: input and cache
specs, the microbatch rule, the closed-form step costs and model FLOPs
against the reference's for every arch and shape, and the CLI at smoke
size on the CPU (a mesh: test_torch_mesh_train.py; the dry run:
test_torch_dryrun.py)."""
import dataclasses
import os
import subprocess
import sys

import jax
import pytest
torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS, SHAPES as R_SHAPES, get_config as r_get
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.launch import analytic as RAn
from repro.launch import steps as RS
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.launch import analytic as TAn
from repro_torch.launch import dryrun as TD
from repro_torch.launch.steps import (cache_specs, default_microbatches,
                                      input_specs)
from test_torch_lm import ROOT
from test_torch_train_model import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch", ["internvl2-2b", "musicgen-medium",
                                  "qwen3-1.7b"])
def test_input_specs_cover_seq_len(arch):
    cfg = get_config(arch)
    for shape in SHAPES.values():
        specs = input_specs(cfg, shape)
        want = RS.input_specs(r_get(arch), R_SHAPES[shape.name])
        assert {k: s.shape for k, s in specs.items()} == \
            {k: s.shape for k, s in want.items()}
        if shape.kind == "decode":
            assert specs["tokens"].shape == (shape.global_batch, 1)
            continue
        total = specs["tokens"].shape[1]
        if cfg.frontend:
            total += specs["frontend_embeds"].shape[1]
        assert total == shape.seq_len
        assert specs["tokens"].shape[0] == shape.global_batch
        assert specs["tokens"].dtype == torch.int32


def test_microbatch_policy_scales_with_model():
    small = get_config("qwen3-1.7b")
    big = get_config("dbrx-132b")
    t = SHAPES["train_4k"]
    assert default_microbatches(small, t) <= default_microbatches(big, t)
    assert default_microbatches(big, SHAPES["decode_32k"]) == 1
    assert SHAPES["train_4k"].global_batch % \
        default_microbatches(big, t) == 0
    for arch in ARCH_IDS:
        for name, shape in SHAPES.items():
            assert default_microbatches(get_config(arch), shape) == \
                RS.default_microbatches(r_get(arch), R_SHAPES[name])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma3-12b", "zamba2-1.2b",
                                  "xlstm-1.3b"])
def test_cache_specs_are_the_references_per_layer(arch):
    """Every layer's cache leaf: the reference's stacked shape without its
    repetition axis, and its dtype; nothing allocated (the ``meta``
    device)."""
    cfg, rcfg = get_config(arch), r_get(arch)
    mine = cache_specs(cfg, ShapeConfig("d", 64, 2, "decode"))
    want = RS.cache_specs(rcfg, RShapeConfig("d", 64, 2, "decode"))
    layers = []
    for r in range(rcfg.scan_reps):
        for i in range(rcfg.period):
            layers.append(jax.tree.map(lambda s: (s.shape[1:], str(s.dtype)),
                                       want["scan"][f"pos{i}"]))
    for i in range(len(rcfg.remainder_pattern)):
        layers.append(jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                                   want["rem"][f"rem{i}"]))
    got = [{k: {n: (s.shape, str(s.dtype).replace("torch.", ""))
                for n, s in sub.items()} for k, sub in layer.items()}
           for layer in mine["layers"]]
    assert got == layers


def reference_dryrun():
    """The reference's ``launch/dryrun.py``, imported with this process's
    JAX backend already up and ``XLA_FLAGS`` put back: at import it sets
    the flags for 512 placeholder devices, which must reach neither this
    worker's JAX (other test files share it) nor its later subprocesses."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def test_analytic_costs_and_model_flops_are_the_references():
    RD = reference_dryrun()
    assert len(jax.devices()) == 1
    for arch in ARCH_IDS:
        cfg, rcfg = get_config(arch), r_get(arch)
        for name, shape in SHAPES.items():
            for mesh in ((1, 1, 1), (256, 16, 16)):
                got = TAn.analytic_costs(cfg, shape, *mesh)
                want = RAn.analytic_costs(rcfg, R_SHAPES[name], *mesh)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                    (arch, name, mesh)
            assert TD.model_flops_for(cfg, shape) == \
                RD.model_flops_for(rcfg, R_SHAPES[name])
            assert TD.skip_reason(cfg, shape) == \
                RD.skip_reason(rcfg, R_SHAPES[name])
        un, run = TD.unrolled_cfg(cfg), RD.unrolled_cfg(rcfg)
        assert (un.layer_pattern, un.n_layers) == \
            (run.layer_pattern, run.n_layers)


def run_cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        cwd=ROOT, env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
                       "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("flags", [[], ["--mixed-precision"]])
def test_cli_trains_at_smoke_size_on_the_cpu(tmp_path, flags):
    out = run_cli("--arch", "qwen3-1.7b", "--scale", "smoke", "--steps",
                  "3", "--seq", "32", "--batch", "4", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path), *flags)
    assert out.returncode == 0, out.stderr
    assert "finished at step 3; final loss" in out.stdout


@pytest.mark.parametrize("flags", [["--mesh", "2x1"], ["--dry-run"]])
def test_cli_refuses_multi_device_work(flags, monkeypatch, capsys):
    """A ``--mesh`` of more ranks than the host has cards refuses, naming
    both counts, rather than run on the CPU (a mesh on the CPU:
    test_torch_mesh_train.py).  ``--dry-run`` needs no card: on a 2x1
    mesh it traces rank 0's step on fake CPU tensors and prints its
    memory and costs (the flags' step: a smoke model, B 4 x S 32)."""
    from repro_torch.launch import train
    if "--dry-run" in flags:
        got = train.main(["--arch", "qwen3-1.7b", "--seq", "32", "--batch",
                          "4", "--mesh", "2x1", "--device", "cpu", *flags])
        out = capsys.readouterr().out
        assert got is None and "peak_bytes" in out and "'flops'" in out
        return
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks over NCCL.*1 card"):
        train.main(["--arch", "qwen3-1.7b", *flags])


def test_mixed_precision_train_step_matches_reference():
    """``make_train_step(mixed_precision=True)``: bfloat16 working params in,
    the float32 master updated in the optimizer state, fresh bfloat16
    params out — two steps against the reference's."""
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import smoke_config as r_smoke
    from repro.models import model as RM
    from repro.optim import adamw as RA
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import opt_state_to_jax, params_from_jax
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import tree_leaves, tree_map
    rcfg = r_smoke(r_get("qwen3-1.7b")).replace(n_layers=2)
    tcfg = smoke_config(get_config("qwen3-1.7b")).replace(n_layers=2)
    opt = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
    rp32 = RM.init(rcfg, jax.random.PRNGKey(2))
    r_step = jax.jit(RS.make_train_step(rcfg, RA.AdamWConfig(
        **opt.__dict__), mixed_precision=True))
    r_params = jax.tree.map(lambda a: a.astype(jnp.bfloat16), rp32)
    r_state = RA.init_mixed(rp32)
    t_master = params_from_jax(jax.tree.map(np.asarray, rp32), tcfg,
                               device="cpu", dtype=torch.float32)
    t_params = tree_map(lambda t: t.to(torch.bfloat16), t_master)
    t_state = adamw.init_mixed(t_master)
    t_step = make_train_step(tcfg, opt, mixed_precision=True)
    rng = np.random.default_rng(8)
    for _ in range(2):
        toks = rng.integers(0, tcfg.vocab_size, (2, 17)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        r_params, r_state, rm = r_step(
            r_params, r_state, jax.tree.map(jnp.asarray, batch))
        t_params, t_state, tm = t_step(t_params, t_state, {
            k: torch.from_numpy(v).long() for k, v in batch.items()})
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)
    assert {t.dtype for t in tree_leaves(t_params)} == {torch.bfloat16}
    mine = opt_state_to_jax(t_state, tcfg)
    for a, b in zip(jax.tree.leaves(mine.master),
                    jax.tree.leaves(r_state.master)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


def test_prefill_and_serve_steps_emit_the_references_tokens():
    """``make_prefill_step`` and ``make_serve_step`` on the smoke qwen3:
    the first token after the prompt and the next one, as the
    reference's."""
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import smoke_config as r_smoke
    from repro.models import model as RM
    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import model as TM
    from repro_torch.models import params_from_jax
    rcfg = r_smoke(r_get("qwen3-1.7b"))
    tcfg = smoke_config(get_config("qwen3-1.7b"))
    rp = RM.init(rcfg, jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, rp), tcfg, device="cpu")
    toks = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    r_tok, r_c = RS.make_prefill_step(rcfg)(
        rp, {"tokens": jnp.asarray(toks)},
        RM.init_caches(rcfg, 2, 16, jnp.float32))
    t_tok, t_c = make_prefill_step(tcfg)(
        tp, {"tokens": torch.from_numpy(toks).long()},
        TM.init_caches(tcfg, 2, 16, torch.float32, device="cpu"))
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(r_tok))
    r_next, _ = RS.make_serve_step(rcfg)(rp, r_tok, r_c,
                                         jnp.asarray(12, jnp.int32))
    t_next, _ = make_serve_step(tcfg)(tp, t_tok, t_c, 12)
    np.testing.assert_array_equal(t_next.numpy(), np.asarray(r_next))
