"""Port vs reference: the port's user entry points, ``examples/torch_*.py``,
each held against its twin in ``examples/`` on the CPU.

The same numpy inputs go through both: the CG solver's band matrix field by
field and its solution within the reference's own check (``rtol=1e-3``,
``atol=1e-4``); the quickstart's plans from one ``TuningDB`` JSON loaded by
both packages (so that no decision depends on a timing), ``D_mat`` within
1e-6 and ``y`` within 1e-5 of the reference's relative to ``Σ|a·x|`` (both
sum in float32, in other orders); the MoE example's ``D_mat`` within 1e-5
and its logits within the MoE tests' 1e-4 on carried weights; the served
tokens equal; the training example's parameter count exact.  Then each
example's ``main`` runs with ``--device cpu``, refuses to run without a
card when no device is given, and imports neither ``jax`` nor ``repro``.
Examples load by path; nothing here starts a process; the port's ops run
on one torch thread (``one_torch_thread``: the test workers share the
host's cores).
"""
import ast
import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import autotune as RA
from repro.core.formats import MatrixStats as RMatrixStats
from repro.core.plan import Planner as RPlanner
from repro.core.spmv import spmv as r_spmv
from repro.core.suite import TABLE1 as R_TABLE1
from repro.core.suite import synthesize as r_synthesize
from repro.models import forward as r_forward
from repro.models.model import n_params as r_n_params
from repro.models.moe import dispatch_d_mat as r_dispatch_d_mat
from repro.models.moe import route as r_route
from repro.serve import ServeEngine as RServeEngine
from repro_torch.core.autotune import TuningDB
from test_torch_lm import ROOT, TOL, both_params, configs, f32
from test_torch_train_model import one_torch_thread  # noqa: F401

EXAMPLES = ("quickstart", "cg_solver", "moe_autotune", "serve_lm",
            "train_lm")
#: two solutions of the CG example agree (the reference's own check)
CG_TOL = dict(rtol=1e-3, atol=1e-4)
#: a product against the reference's, relative to sum |a x|
Y_REL_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def example(name):
    """``examples/<name>.py`` as a module (the port's are ``torch_<name>``);
    the ``__main__`` guard keeps its work from running."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port(name):
    return example(f"torch_{name}")


def csr_fields(m):
    return {"data": np.asarray(m.data), "cols": np.asarray(m.cols),
            "indptr": np.asarray(m.indptr)}


# ---------------------------------------------------------------------------
# cg_solver
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,band", [(2000, 9), (2000, 8), (7, 9)])
def test_cg_band_matrix_is_the_references(n, band):
    """The vectorized construction against the reference's row loop
    (``csr_from_rows(..., pad=8)``), field by field; an even band and a
    band wider than the matrix too."""
    want = example("cg_solver").spd_band_matrix(n, band)
    got = port("cg_solver").spd_band_matrix(n, band, device="cpu")
    assert (got.shape, got.nnz) == (want.shape, want.nnz)
    for k, w in csr_fields(want).items():
        g = getattr(got, k).numpy()
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_cg_solutions_are_the_references():
    """The port's CG over its CRS product (the CSR kernel's plain version
    here) and over a forced ELL-Row plan give the reference's CG solution
    over its jitted CRS SpMV, and run as many iterations."""
    ref, cg = example("cg_solver"), port("cg_solver")
    A_r = ref.spd_band_matrix(2000)
    b_r = jnp.ones((A_r.n_cols,), jnp.float32)
    jit_crs = jax.jit(r_spmv)
    x_r, res_r = ref.cg(lambda v: jit_crs(A_r, v), b_r)

    A = cg.spd_band_matrix(2000, device="cpu")
    b = torch.ones(A.n_cols)
    crs = cg.crs_solve(A, b)
    ell = cg.tuned_solve(A, b, None, fmt="ell_row")
    assert (crs.fmt, ell.fmt, ell.rule) == ("csr", "ell_row", "fixed")
    assert crs.iterations == ell.iterations
    for s in (crs, ell):
        np.testing.assert_allclose(s.x.numpy(), np.asarray(x_r), **CG_TOL)
        assert s.residual == pytest.approx(res_r, rel=1e-2)
    cg.agree(crs.x, ell.x)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
def test_quickstart_plans_and_products_are_the_references():
    """One TuningDB JSON, loaded by both packages: the uniform matrix goes
    to ELL-Row, the heavy-tailed one stays CSR, in both; ``D_mat`` within
    1e-6, ``y = P @ 1`` within 1e-5 of the reference's relative to
    ``Σ|a|`` of the row; the service serves the same ``y`` on its tuned
    rung."""
    text = RA.TuningDB(machine="quickstart-test", c=1.0, records=[],
                       d_star={"ell_row": 1.0, "sell": 1.0,
                               "coo_row": 1.0}).to_json()
    got = port("quickstart").plan_and_serve(TuningDB.from_json(text),
                                            torch.device("cpu"))
    r_db = RA.TuningDB.from_json(text)
    fmts = {}
    for name, out in got.items():
        A = r_synthesize(next(s for s in R_TABLE1 if s.name == name),
                         scale=0.05)
        stats = RMatrixStats.of(A)
        plan = RPlanner(db=r_db).plan(A, rule="paper")
        y = np.asarray(plan.bind(A) @ jnp.ones((A.n_cols,), jnp.float32))
        scale = np.abs(A.todense()).sum(axis=1)
        assert out["stats"].d_mat == pytest.approx(stats.d_mat, abs=1e-6)
        assert out["plan"].fmt == plan.fmt
        err = np.abs(out["y"].numpy() - y) / (scale + 1e-30)
        assert err.max() <= Y_REL_TOL, name
        fmts[name] = plan.fmt
    assert fmts == {"chem_master1": "ell_row", "memplus": "csr"}

    svc = port("quickstart").serve(torch.device("cpu"))
    want = got["chem_master1"]["y"].numpy()
    for y in (svc["y"], *svc["flushed"]):
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6)
    assert svc["stats"]["guard"]["spmv"]["served_by"]["tuned"] == 1


# ---------------------------------------------------------------------------
# moe_autotune
# ---------------------------------------------------------------------------
def test_moe_autotune_is_the_references():
    """The reference's weights carried over: the router's ``D_mat`` on the
    first MoE layer within 1e-5, the same branch, and the logits and the
    load-balance loss of a forward through the auto dispatch within the
    MoE tests' tolerance."""
    mx = port("moe_autotune")
    rcfg, tcfg = configs("mixtral-8x22b", moe_dispatch="auto",
                         capacity_factor=1.25)
    assert dataclasses.asdict(mx.config()) == dataclasses.asdict(tcfg)
    rp, tp = both_params(rcfg, tcfg)
    tokens, x = mx.inputs(tcfg)
    got = mx.inspect(tp, tcfg, tokens, x, torch.device("cpu"))

    moe_params = jax.tree.map(lambda a: a[0], rp["scan"]["pos0"])["moe"]
    ids, _, _ = r_route(moe_params, jnp.asarray(x), rcfg)
    d_mat = float(r_dispatch_d_mat(ids, rcfg.n_experts))
    logits, aux = jax.jit(lambda p, b: r_forward(p, b, rcfg))(
        rp, {"tokens": jnp.asarray(tokens)})
    assert got["d_mat"] == pytest.approx(d_mat, abs=1e-5)
    assert got["branch"] == ("ell" if d_mat < mx.DEFAULT_D_STAR else "csr")
    np.testing.assert_allclose(f32(got["logits"]), f32(logits), **TOL)
    np.testing.assert_allclose(got["aux"], float(aux), **TOL)


# ---------------------------------------------------------------------------
# serve_lm
# ---------------------------------------------------------------------------
def test_serve_lm_tokens_are_the_references():
    """The example's default model (h2o-danube at smoke size, sliding-window
    blocks) on carried weights: its prompts through three slots, greedy
    tokens equal to the reference engine's on the same prompts."""
    sv = port("serve_lm")
    rcfg, tcfg = configs("h2o-danube-1.8b")
    rp, tp = both_params(rcfg, tcfg)
    prompts = sv.prompts(tcfg, 4)
    got, _ = sv.serve(tp, tcfg, prompts, 6, 3, torch.device("cpu"))
    ref = RServeEngine(rp, rcfg, max_batch=3, max_len=128)
    for p in prompts:
        ref.submit(p, max_new_tokens=6)
    want = ref.run()
    assert sorted(got) == sorted(want) == list(range(4))
    for rid in want:
        assert got[rid].generated == want[rid].generated, rid


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-1.2b"])
def test_train_lm_config_counts_the_references_parameters(arch):
    from repro import configs as RC
    cfg = port("train_lm").config(arch, 256)
    rcfg = RC.smoke_config(RC.get_config(arch)).replace(
        d_model=256, d_ff=1024 if RC.get_config(arch).d_ff else 0,
        vocab_size=2048)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert port("train_lm").n_params(cfg) == r_n_params(rcfg)


def test_train_lm_runs_two_steps(tmp_path):
    tl = port("train_lm")
    trainer, state = tl.train(tl.config(), 2, 32, 2, str(tmp_path), "cpu")
    assert state.step == 2 and len(trainer.metrics) == 2
    assert all(np.isfinite(m["loss"]) for m in trainer.metrics)


# ---------------------------------------------------------------------------
# every example
# ---------------------------------------------------------------------------
#: each example's ``main`` on the CPU at a small size
CPU_ARGS = {
    "quickstart": [],
    "cg_solver": ["--n", "500", "--iters", "20"],
    "moe_autotune": [],
    "serve_lm": ["--requests", "2", "--max-new", "3", "--kv-quant"],
    "train_lm": ["--steps", "2", "--seq", "16", "--batch", "2",
                 "--width", "64"],
}


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_runs_on_the_cpu(name, tmp_path, capsys):
    argv = ["--device", "cpu", *CPU_ARGS[name]]
    if name == "train_lm":
        argv += ["--ckpt-dir", str(tmp_path)]
    out = port(name).main(argv)
    assert out and "Traceback" not in capsys.readouterr().err


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_refuses_to_run_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port(name).main([])


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_import_neither_jax_nor_the_reference(name):
    with open(os.path.join(ROOT, "examples", f"torch_{name}.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    roots = {m.split(".")[0] for m in mods}
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots
