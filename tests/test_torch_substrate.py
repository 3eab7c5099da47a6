"""The port's training substrate: the ten training cases of
``tests/test_substrate.py`` (data pipeline, checkpoints, the fault-tolerant
trainer, the watchdog) run on the port, and the port against the reference:
the same synthetic batches, the same trajectory from one parameter tree
(with and without gradient accumulation), and checkpoints that either
package restores from the other."""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.checkpoint import restore as r_restore
from repro.configs import get_config as r_get, smoke_config as r_smoke
from repro.data import SyntheticLM as RSyntheticLM
from repro.data import data_config_for as r_data_config_for
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.train import TrainConfig as RTrainConfig, Trainer as RTrainer
from repro.train.loop import TrainState as RTrainState
from repro_torch.checkpoint import (AsyncCheckpointer, available_steps,
                                    latest_step, restore, save)
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import (DataConfig, Prefetcher, SyntheticLM,
                              data_config_for)
from repro_torch.models import params_from_jax, params_to_jax
from repro_torch.sharding.rules import tree_leaves
from repro_torch.train import TrainConfig, Trainer, run_with_restarts
from test_torch_train_model import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------
def test_data_deterministic_and_seekable():
    dc = DataConfig(vocab_size=128, seq_len=64, global_batch=8)
    src = SyntheticLM(dc)
    b5a = src.batch_at(5)
    b5b = src.batch_at(5)
    np.testing.assert_array_equal(b5a["tokens"], b5b["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(b5a["tokens"][:, 1:], b5a["labels"][:, :-1])
    assert b5a["tokens"].shape == (8, 64)


def test_data_host_sharding_partitions_global_batch():
    dc = DataConfig(vocab_size=128, seq_len=32, global_batch=8)
    full = SyntheticLM(dc).batch_at(3)["tokens"]
    shards = [SyntheticLM(dc, host_id=h, num_hosts=4).batch_at(3)["tokens"]
              for h in range(4)]
    assert all(s.shape == (2, 32) for s in shards)
    # host shards are distinct streams (different rng per host)
    assert not np.array_equal(shards[0], shards[1])
    assert full.shape == (8, 32)


def test_prefetcher_resumes_from_step():
    dc = DataConfig(vocab_size=64, seq_len=16, global_batch=2)
    src = SyntheticLM(dc)
    pf = Prefetcher(src, start_step=7)
    s, b = pf.next()
    pf.close()
    assert s == 7
    np.testing.assert_array_equal(b["tokens"], src.batch_at(7)["tokens"])


@pytest.mark.parametrize("arch,host", [("qwen3-1.7b", (0, 1)),
                                       ("internvl2-2b", (0, 1)),
                                       ("qwen3-1.7b", (3, 4))])
def test_synthetic_batches_are_the_references(arch, host):
    """Byte for byte, frontend embeddings and host shards included."""
    tdc = data_config_for(smoke_config(get_config(arch)), 48, 8, seed=5)
    rdc = r_data_config_for(r_smoke(r_get(arch)), 48, 8, seed=5)
    assert tdc.__dict__ == rdc.__dict__
    mine, ref = SyntheticLM(tdc, *host), RSyntheticLM(rdc, *host)
    for step in (0, 1, 17):
        a, b = mine.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes(), (k, step)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nest": {"b": torch.arange(10, dtype=torch.int32),
                     "c": torch.ones((3,), dtype=torch.bfloat16)}}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 42, t, extra={"step": 42})
    assert latest_step(str(tmp_path)) == 42
    got, extra = restore(str(tmp_path), 42, t, verify=True, device="cpu")
    assert extra["step"] == 42
    for a, b in zip(tree_leaves(t), tree_leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_atomicity_ignores_uncommitted(tmp_path):
    t = _tree()
    save(str(tmp_path), 1, t)
    # simulate a crash mid-write: step_2 exists but has no COMMIT
    bad = tmp_path / "step_000000002"
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert latest_step(str(tmp_path)) == 1


def test_checkpoint_gc_and_async(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save_async(s, _tree(s))
    ck.wait()
    assert available_steps(str(tmp_path)) == [2, 3]


def test_checkpoint_format_is_the_references(tmp_path):
    """The port's manifest of a tree is the reference's for the same tree
    (keys, order, files, shapes, dtypes, hashes) — a bfloat16 leaf
    included — and each package restores the other's."""
    import json
    from repro.checkpoint import save as r_save
    t = _tree(4)
    rt = {"a": jnp.asarray(t["a"].numpy()),
          "nest": {"b": jnp.asarray(t["nest"]["b"].numpy()),
                   "c": jnp.ones((3,), jnp.bfloat16)}}
    save(str(tmp_path / "port"), 3, t, extra={"step": 3})
    r_save(str(tmp_path / "ref"), 3, rt, extra={"step": 3})

    def manifest(d):
        with open(tmp_path / d / "step_000000003" / "manifest.json") as f:
            return json.load(f)
    assert manifest("port") == manifest("ref")
    got, _ = restore(str(tmp_path / "ref"), 3, t, verify=True, device="cpu")
    for a, b in zip(tree_leaves(t), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    back, _ = r_restore(str(tmp_path / "port"), 3, rt, verify=True)
    for a, b in zip(jax.tree.leaves(rt), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    # shardings= places each leaf over a mesh (a DTensor): collectives of a
    # world (test_torch_distributed.py); a tree of them that does not pair
    # with the target's leaves raises
    with pytest.raises(ValueError, match="shorter"):
        restore(str(tmp_path / "port"), 3, t, shardings={"one": None},
                device="cpu")


# ---------------------------------------------------------------------------
# fault-tolerant training
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_setup():
    cfg = smoke_config(get_config("qwen3-1.7b")).replace(n_layers=2)
    dc = data_config_for(cfg, seq_len=32, global_batch=4)
    return cfg, SyntheticLM(dc)


def test_train_loop_runs_and_checkpoints(tiny_setup, tmp_path):
    cfg, data = tiny_setup
    tc = TrainConfig(steps=6, ckpt_every=3, ckpt_dir=str(tmp_path),
                     log_every=100)
    tr = Trainer(cfg, data, tc, device="cpu")
    state = tr.run(tr.init_state())
    assert state.step == 6
    assert latest_step(str(tmp_path)) == 6
    losses = [m["loss"] for m in tr.metrics]
    assert all(np.isfinite(losses))


def test_failure_injection_restores_and_resumes(tiny_setup, tmp_path):
    cfg, data = tiny_setup
    tc = TrainConfig(steps=8, ckpt_every=2, ckpt_dir=str(tmp_path),
                     log_every=100)
    boom = {"armed": True}

    def failure_hook(step):
        if step == 5 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected node failure")

    tr = Trainer(cfg, data, tc, failure_hook=failure_hook, device="cpu")
    state = run_with_restarts(tr, max_restarts=2)
    assert state.step == 8
    # the restart resumed from the last committed step (4), not scratch
    steps_seen = [m["step"] for m in tr.metrics]
    assert steps_seen.count(5) >= 1 and steps_seen[-1] == 8
    assert steps_seen == [1, 2, 3, 4, 5, 5, 6, 7, 8]


def test_restart_trajectory_bit_exact(tiny_setup, tmp_path):
    """A restarted run must match an uninterrupted run exactly
    (seekable data + deterministic step)."""
    cfg, data = tiny_setup
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    tr1 = Trainer(cfg, data, TrainConfig(steps=6, ckpt_every=2, ckpt_dir=d1,
                                         log_every=100), device="cpu")
    s_full = tr1.run(tr1.init_state())
    # run 2: stop at 4, then resume in a new Trainer to 6
    tr2 = Trainer(cfg, data, TrainConfig(steps=6, ckpt_every=2, ckpt_dir=d2,
                                         log_every=100), device="cpu")
    tr2.run(tr2.init_state(), until=4)
    tr2.ckpt.wait()
    tr3 = Trainer(cfg, data, TrainConfig(steps=6, ckpt_every=2, ckpt_dir=d2,
                                         log_every=100), device="cpu")
    s_resumed = tr3.run(tr3.try_restore())
    for a, b in zip(tree_leaves(s_full.params),
                    tree_leaves(s_resumed.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)


def test_async_checkpoint_is_its_steps_state(tiny_setup, tmp_path,
                                             monkeypatch):
    """The writer thread is held while the next step overwrites the
    parameters and moments in place: the step-2 checkpoint still holds step
    2's state byte for byte (``save_async`` copies before it returns)."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.models.convert import jax_spec, opt_state_from_jax
    from repro_torch.optim import adamw
    cfg, data = tiny_setup
    release = threading.Event()
    real_save = ckpt.save

    def held_save(directory, step, tree, extra=None):
        if step == 2:
            assert release.wait(timeout=300), "step 3 never ran"
        return real_save(directory, step, tree, extra)

    monkeypatch.setattr(ckpt, "save", held_save)
    snap = {}

    def hook(step):
        if step == 2:           # step 2's state, before step 3 runs
            snap["params"] = [t.clone() for t in tree_leaves(state.params)]
            snap["opt"] = [t.clone() for t in
                           tree_leaves(state.opt_state.m) +
                           tree_leaves(state.opt_state.v)]
        if step == 3:           # step 3 has written into the same tensors
            release.set()

    tr = Trainer(cfg, data, TrainConfig(steps=4, ckpt_every=2,
                                        ckpt_dir=str(tmp_path),
                                        log_every=100),
                 failure_hook=hook, device="cpu")
    state = tr.init_state()
    tr.run(state)
    assert not all(torch.equal(a, b) for a, b in
                   zip(snap["params"], tree_leaves(state.params)))
    spec = jax_spec(cfg)
    template = {"params": spec, "opt": adamw.AdamWState(
        step=np.zeros((), np.int32), m=spec, v=spec)}
    tree, extra = restore(str(tmp_path), 2, template, verify=True,
                          device="cpu")
    assert extra["step"] == 2
    params = params_from_jax(tree["params"], cfg, device="cpu",
                             dtype=torch.float32)
    opt = opt_state_from_jax(tree["opt"], cfg, device="cpu")
    for a, b in zip(snap["params"], tree_leaves(params)):
        assert torch.equal(a, b)
    for a, b in zip(snap["opt"], tree_leaves(opt.m) + tree_leaves(opt.v)):
        assert torch.equal(a, b)
    assert int(opt.step) == 2


def test_mixed_precision_trainer_resumes_bit_exact(tiny_setup, tmp_path):
    """``TrainConfig(mixed_precision=True)``: bfloat16 working parameters,
    the float32 masters in the optimizer state, both written to and read
    from the checkpoint — a run resumed at step 2 ends where an
    uninterrupted one does."""
    cfg, data = tiny_setup

    def trainer(name):
        return Trainer(cfg, data, TrainConfig(
            steps=4, ckpt_every=2, ckpt_dir=str(tmp_path / name),
            log_every=100, mixed_precision=True), device="cpu")
    tr = trainer("a")
    full = tr.run(tr.init_state())
    assert all(np.isfinite([m["loss"] for m in tr.metrics]))
    assert {t.dtype for t in tree_leaves(full.params)} == {torch.bfloat16}
    half = trainer("b")
    half.run(half.init_state(), until=2)
    half.ckpt.wait()
    rest = trainer("b")
    resumed = rest.try_restore()
    assert resumed.step == 2 and type(resumed.opt_state).__name__ == \
        "AdamWMixedState"
    resumed = rest.run(resumed)
    for a, b in zip(tree_leaves(full.opt_state.master) +
                    tree_leaves(full.params),
                    tree_leaves(resumed.opt_state.master) +
                    tree_leaves(resumed.params)):
        assert torch.equal(a, b)


def test_straggler_watchdog():
    from repro_torch.train.loop import StragglerWatchdog
    wd = StragglerWatchdog(factor=3.0)
    flags = [wd.observe(i, dt) for i, dt in
             enumerate([1.0, 1.0, 1.0, 10.0, 1.0])]
    assert flags == [False, False, False, True, False]
    assert wd.flagged == [3]


# ---------------------------------------------------------------------------
# the port's trainer against the reference's
# ---------------------------------------------------------------------------
#: a step's loss and the parameters after it, port against reference: both
#: float32, sums in other orders, the first AdamW steps near sign(g) · lr
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def both_setups():
    rcfg = r_smoke(r_get("qwen3-1.7b")).replace(n_layers=2)
    tcfg = smoke_config(get_config("qwen3-1.7b")).replace(n_layers=2)
    rdc = r_data_config_for(rcfg, seq_len=32, global_batch=4)
    tdc = data_config_for(tcfg, seq_len=32, global_batch=4)
    rp0 = jax.tree.map(np.asarray, RM.init(rcfg, jax.random.PRNGKey(0)))
    return rcfg, tcfg, RSyntheticLM(rdc), SyntheticLM(tdc), rp0


def _r_state(rp0):
    """The reference Trainer's state from ``rp0`` (its ``init_state``
    draws its own)."""
    params = jax.tree.map(jnp.asarray, rp0)
    return RTrainState(params=params, opt_state=RA.init(params), step=0)


def port_params(rp0, tcfg):
    return params_from_jax(rp0, tcfg, device="cpu", dtype=torch.float32)


def assert_params_close(tparams, rparams, tcfg, tol=PARAM_TOL):
    got = params_to_jax(tparams, tcfg)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(rparams)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), **tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_trainer_trajectory_matches_reference(both_setups, tmp_path,
                                              microbatches):
    """Three steps from one parameter tree: the port's losses and grad
    norms are the reference Trainer's, and so are its parameters after
    them — with one batch, and accumulated over two microbatches (which
    also agree with one batch)."""
    rcfg, tcfg, rdata, tdata, rp0 = both_setups
    rtc = RTrainConfig(steps=3, ckpt_every=100, log_every=100,
                       ckpt_dir=str(tmp_path / "r"),
                       microbatches=microbatches)
    rtr = RTrainer(rcfg, rdata, rtc)
    rstate = rtr.run(_r_state(rp0))
    tc = TrainConfig(steps=3, ckpt_every=100, log_every=100,
                     ckpt_dir=str(tmp_path / "t"), microbatches=microbatches)
    tr = Trainer(tcfg, tdata, tc, device="cpu")
    state = tr.run(tr.init_state(port_params(rp0, tcfg)))
    for mine, ref in zip(tr.metrics, rtr.metrics):
        assert mine["step"] == ref["step"]
        np.testing.assert_allclose(mine["loss"], ref["loss"], **LOSS_TOL)
        np.testing.assert_allclose(mine["grad_norm"], ref["grad_norm"],
                                   **LOSS_TOL)
    assert_params_close(state.params, rstate.params, tcfg)
    if microbatches == 2:
        one = Trainer(tcfg, tdata, TrainConfig(
            steps=3, ckpt_every=100, log_every=100,
            ckpt_dir=str(tmp_path / "one")), device="cpu")
        s1 = one.run(one.init_state(port_params(rp0, tcfg)))
        for a, b in zip(tree_leaves(state.params), tree_leaves(s1.params)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **PARAM_TOL)


def test_checkpoint_interchange_reference_to_port(both_setups, tmp_path):
    """The reference Trainer stops at step 4 and checkpoints; the port's
    Trainer restores that checkpoint and runs to 6; it ends within 1e-5 of
    the reference's uninterrupted 6 steps."""
    rcfg, tcfg, rdata, tdata, rp0 = both_setups
    d = str(tmp_path / "ck")

    def rtc(ckpt_dir):
        return RTrainConfig(steps=6, ckpt_every=2, log_every=100,
                            ckpt_dir=ckpt_dir)
    full = RTrainer(rcfg, rdata, rtc(str(tmp_path / "full")))
    r_full = full.run(_r_state(rp0))
    half = RTrainer(rcfg, rdata, rtc(d))
    half.run(_r_state(rp0), until=4)
    half.ckpt.wait()
    tr = Trainer(tcfg, tdata, TrainConfig(steps=6, ckpt_every=2,
                                          log_every=100, ckpt_dir=d),
                 device="cpu")
    resumed = tr.try_restore()
    assert resumed.step == 4
    state = tr.run(resumed)
    assert state.step == 6 and [m["step"] for m in tr.metrics] == [5, 6]
    assert_params_close(state.params, r_full.params, tcfg)


def test_checkpoint_interchange_port_to_reference(both_setups, tmp_path):
    """The reverse: the port's Trainer stops at 4 and checkpoints, the
    reference's restores and runs to 6, within 1e-5 of the port's
    uninterrupted run."""
    rcfg, tcfg, rdata, tdata, rp0 = both_setups
    d = str(tmp_path / "ck")

    def tc(ckpt_dir):
        return TrainConfig(steps=6, ckpt_every=2, log_every=100,
                           ckpt_dir=ckpt_dir)
    full = Trainer(tcfg, tdata, tc(str(tmp_path / "full")), device="cpu")
    t_full = full.run(full.init_state(port_params(rp0, tcfg)))
    half = Trainer(tcfg, tdata, tc(d), device="cpu")
    half.run(half.init_state(port_params(rp0, tcfg)), until=4)
    half.ckpt.wait()
    assert os.path.exists(os.path.join(d, "step_000000004", "COMMIT"))
    rtr = RTrainer(rcfg, rdata, RTrainConfig(steps=6, ckpt_every=2,
                                             log_every=100, ckpt_dir=d))
    resumed = rtr.try_restore()
    assert resumed.step == 4
    r_state = rtr.run(resumed)
    assert r_state.step == 6
    assert_params_close(t_full.params, r_state.params, tcfg)


def test_checkpoint_without_zstandard(tmp_path, monkeypatch):
    """Without ``zstandard`` leaves are written uncompressed (codec
    ``none``) and restore; a zstd leaf then raises, as the reference's
    restore does."""
    from repro_torch.checkpoint import ckpt
    if not ckpt.HAVE_ZSTD:
        pytest.skip("needs zstandard to write the zstd checkpoint")
    t = _tree(5)
    save(str(tmp_path / "zstd"), 1, t)
    monkeypatch.setattr(ckpt, "HAVE_ZSTD", False)
    save(str(tmp_path / "none"), 1, t)
    assert sorted(os.listdir(tmp_path / "none" / "step_000000001"))[0] == \
        "COMMIT"
    got, _ = restore(str(tmp_path / "none"), 1, t, verify=True, device="cpu")
    for a, b in zip(tree_leaves(t), tree_leaves(got)):
        assert torch.equal(a, b)
    with pytest.raises(RuntimeError, match="zstandard"):
        restore(str(tmp_path / "zstd"), 1, t, device="cpu")
