"""Port vs reference: the LM's training gradients, leaf by leaf in the
reference's layout, for the five archs whose grads the reference's smoke
test takes, and dbrx's under every MoE dispatch (helpers, batches and
tolerances: ``test_torch_train_model.py``)."""
import pytest

from repro.models import moe as RMoE
torch = pytest.importorskip("torch")
from repro_torch.models import moe as TMoE
from test_torch_train_model import (GRAD_ARCHS, LOSS_RTOL,
                                    assert_grads_match, configs, make_batch,
                                    masters, one_torch_thread,  # noqa: F401
                                    port_value_and_grad,
                                    reference_value_and_grad)


@pytest.mark.parametrize("arch,kw,rel,loose", GRAD_ARCHS)
def test_grads_match_reference(arch, kw, rel, loose):
    rcfg, tcfg = configs(arch, **kw)
    rp, tp = masters(rcfg, tcfg)
    batch = make_batch(tcfg, seed=2)
    want_loss, want = reference_value_and_grad(rp, batch, rcfg)
    got_loss, got = port_value_and_grad(tp, batch, tcfg)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert_grads_match(got, want, rel, loose)


@pytest.mark.parametrize("dispatch,d_star,branch", [
    ("ell", 0.5, "moe_ell"), ("csr", 0.5, "moe_csr"),
    ("auto", 1e9, "moe_ell"),      # D_mat < D*: ELL
    ("auto", 0.0, "moe_csr")])     # D_mat >= D*: CSR
def test_moe_grads_match_reference_per_dispatch(monkeypatch, dispatch,
                                                d_star, branch):
    """dbrx's grads under each dispatch, ``"auto"`` with ``D*`` set so that
    each branch is taken in every layer (the default ``D*`` of both
    packages' ``moe_apply`` is moved, and the port's branches counted)."""
    rcfg, tcfg = configs("dbrx-132b", moe_dispatch=dispatch)
    for fn in (RMoE.moe_apply, TMoE.moe_apply):
        monkeypatch.setattr(fn, "__defaults__", (d_star, 4096))
    taken = []
    for name in ("moe_ell", "moe_csr"):
        real = getattr(TMoE, name)
        monkeypatch.setattr(TMoE, name, lambda *a, _n=name, _r=real, **kw:
                            taken.append(_n) or _r(*a, **kw))
    rp, tp = masters(rcfg, tcfg)
    batch = make_batch(tcfg, seed=3)
    want_loss, want = reference_value_and_grad(rp, batch, rcfg)
    got_loss, got = port_value_and_grad(tp, batch, tcfg)
    assert taken == [branch] * tcfg.n_layers
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert_grads_match(got, want)
