"""The port's rematerialization modes against each other, and float32
masters through every block kind (helpers: ``test_torch_train_model.py``).
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.launch.steps import value_and_grad
from repro_torch.models import model as TM
from repro_torch.sharding.rules import tree_leaves
from test_torch_train_model import (configs, make_batch,
                                    one_torch_thread,  # noqa: F401
                                    on_port)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "dbrx-132b", "zamba2-1.2b",
                                  "xlstm-1.3b"])
def test_remat_modes_agree(arch):
    """``none``, ``dots`` and ``full`` keep different activations and
    recompute the rest: the same loss and grads (dbrx with ``"auto"``: a
    recompute reads the group sizes and D_mat again and takes the same
    branch)."""
    _, tcfg = configs(arch, moe_dispatch="auto") if arch == "dbrx-132b" \
        else configs(arch)
    tp = TM.init(tcfg, torch.Generator().manual_seed(4), device="cpu",
                 dtype=torch.float32)
    # xLSTM's loop over time is a Python step a token, recomputed under
    # the checkpoints: 16 tokens keep its three backward passes short
    S = 16 if arch == "xlstm-1.3b" else 32
    batch = on_port(make_batch(tcfg, seed=4, S=S))
    runs = {mode: value_and_grad(tp, batch, tcfg.replace(remat=mode))
            for mode in ("none", "dots", "full")}
    loss0, g0 = runs["none"]
    for mode in ("dots", "full"):
        loss, g = runs[mode]
        assert float(loss) == pytest.approx(float(loss0), rel=1e-6, abs=0)
        for a, b in zip(g, g0):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_float32_masters_train_every_block_kind():
    """``init(..., dtype=float32)`` and ``params_from_jax(...,
    dtype=float32)`` give every leaf in float32, and with a bfloat16
    compute dtype each block casts its weights on the call: the loss is
    finite and every gradient is a float32 tensor of its master's shape."""
    for arch in ("qwen3-1.7b", "dbrx-132b", "zamba2-1.2b", "xlstm-1.3b"):
        _, tcfg = configs(arch, dtype="bfloat16")
        tp = TM.init(tcfg, torch.Generator().manual_seed(8), device="cpu",
                     dtype=torch.float32)
        assert {p.dtype for p in tree_leaves(tp)} == {torch.float32}
        loss, grads = value_and_grad(tp, on_port(make_batch(tcfg, seed=8)),
                                      tcfg)
        assert np.isfinite(float(loss)), arch
        for p, g in zip(tree_leaves(tp), grads):
            assert g.dtype == torch.float32 and g.shape == p.shape, arch
            assert torch.isfinite(g).all(), arch
    serving = TM.init(tcfg, torch.Generator().manual_seed(8), device="cpu")
    assert torch.bfloat16 in {p.dtype for p in tree_leaves(serving)}
