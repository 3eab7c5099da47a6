#!/usr/bin/env python3
"""How far float32 evaluations of the training gradients sit apart, beside
the port's distance from the reference — on the CPU.  The readings set the
tolerances of ``tests/test_torch_train_model.py`` (``GRAD_ARCHS``) and of
``chip_smoke.py``'s held steps (``TRAIN_HELD``).

For each entry of ``GRAD_ARCHS`` (the smoke configs in float32, the
reference's weights, the test's batch) it takes the reference's
``jax.value_and_grad`` of ``loss_fn`` twice, jitted and op by op
(``jax.disable_jit``: another order of the float32 sums), and the port's
(autograd).  It also takes the port's grads after a one-ulp perturbation of
every master (each entry times 1 + 2^-23 * N(0, 1), ``DRAWS`` draws), at
the test's setup and at ``chip_smoke.py``'s held step (the port's own
``init`` from seed 1, a batch from ``numpy`` seed 1): how far rounding
alone moves them.  Every distance is a leaf's largest |difference| over
that leaf's largest |g|.  One JSON line a model: the three losses, the
largest of each distance over all leaves, and each leaf whose jit-vs-eager
spread passes 5e-5.

Run from the root of a checkout (needs the JAX package; ~4 min)::

    JAX_PLATFORMS=cpu PYTHONPATH=src:tests python3 experiments/torch_train_grad_spread.py
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]

import jax                      # noqa: E402
import jax.numpy as jnp         # noqa: E402
import numpy as np              # noqa: E402
import torch                    # noqa: E402

from repro.models import model as RM                     # noqa: E402
from repro_torch.launch.steps import value_and_grad      # noqa: E402
from repro_torch.models import model as TM               # noqa: E402
from repro_torch.sharding.rules import tree_map          # noqa: E402
import test_torch_train_model as T                       # noqa: E402

DRAWS = 3


def rel_dist(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def perturbation_spread(params, batch, cfg) -> float:
    """The largest move of a grad leaf under a one-ulp perturbation of
    the masters, over ``DRAWS`` draws."""
    _, g0 = value_and_grad(params, batch, cfg)
    worst = 0.0
    for seed in range(DRAWS):
        gen = torch.Generator().manual_seed(100 + seed)
        moved = tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.randn(
            t.shape, generator=gen)), params)
        _, g1 = value_and_grad(moved, batch, cfg)
        worst = max(worst, max(rel_dist(a, b) for a, b in zip(g1, g0)))
    return worst


def held_step_setup(cfg):
    """chip_smoke.py's held step: the port's masters from seed 1 and a
    (2, 32) batch from numpy seed 1."""
    params = TM.init(cfg, torch.Generator().manual_seed(1), device="cpu",
                     dtype=torch.float32)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
             for k in ("tokens", "labels")}
    return params, batch


def main() -> None:
    for arch, kw, rel, loose in T.GRAD_ARCHS:
        rcfg, tcfg = T.configs(arch, **kw)
        rp, tp = T.masters(rcfg, tcfg)
        batch = T.make_batch(tcfg, seed=2)
        loss_jit, jit = T.reference_value_and_grad(rp, batch, rcfg)
        loss_port, port = T.port_value_and_grad(tp, batch, tcfg)
        with jax.disable_jit():
            loss_eager, eager = jax.value_and_grad(lambda p: RM.loss_fn(
                p, jax.tree.map(jnp.asarray, batch), rcfg))(rp)
        rows, worst = {}, {"jit_vs_eager": 0.0, "port_vs_jit": 0.0}
        for (path, w), e, g in zip(
                jax.tree_util.tree_flatten_with_path(jit)[0],
                jax.tree_util.tree_leaves(eager),
                jax.tree_util.tree_leaves(port)):
            w = torch.from_numpy(np.array(w))
            row = {"jit_vs_eager": rel_dist(torch.from_numpy(
                       np.array(e)), w),
                   "port_vs_jit": rel_dist(torch.from_numpy(g), w)}
            worst = {k: max(worst[k], row[k]) for k in worst}
            if row["jit_vs_eager"] > 5e-5:
                rows[jax.tree_util.keystr(path)] = row
        worst["perturbed_test_setup"] = perturbation_spread(
            tp, T.on_port(batch), tcfg)
        worst["perturbed_held_step"] = perturbation_spread(
            *held_step_setup(tcfg), tcfg)
        print(json.dumps({
            "arch": arch, **kw, "tol": rel, "tol_by_key": loose,
            "loss_jit": loss_jit, "loss_eager": float(loss_eager),
            "loss_port": loss_port, "worst": worst, "leaves": rows}),
            flush=True)


if __name__ == "__main__":
    main()
