"""Port vs reference: the sharded tier's ``shard_map`` executor on 8 ranks.

The reference's two 8-device cases of ``tests/test_sharded_spmv.py``
(``test_shard_map_parity_all_strategies_8dev``,
``test_shard_map_service_roundtrip_8dev``) run under 8 forced XLA host
devices; the port runs them in one ``gloo`` world of 8 CPU ranks
(``tests/torch_worlds.py shard_map``, one subprocess for the module, with
its own wall limit), and each case reads its rank results here: every
strategy x axis x op within 2e-4 of the dense oracle and of the
reference's ``dispatch`` product, ``auto`` resolved to ``shard_map`` with
the reference's envelope bytes, 4 shards on a world of 8 (every rank holds
``y``), fewer ranks than shards refused with the reference's
``PlanError``, a caller's mesh, and the service and plan store serving a
reference-minted ``ShardedPlan`` (and the reference serving a port-minted
one).  ``_stack_shards`` is held against the reference's array for array
in this process.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import plan as RPL
from repro.core import plan_store as RPS
from repro.core.transform import csr_from_dense as r_csr_from_dense
from repro.sharding import build_sharded as r_build_sharded
from repro.sharding import shard_csr as r_shard_csr
from repro.sharding.spmv import _stack_shards as r_stack_shards

from repro_torch.core.transform import csr_from_dense
from repro_torch.sharding import shard_csr
from repro_torch.sharding.spmv import _stack_shards

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = os.path.join(ROOT, "tests", "torch_worlds.py")
#: the wall limit of a spawning fixture, in seconds
WALL_S = 120
N_RANKS = 8
STRATEGIES = ("fixed", "balanced_nnz", "variance")
AXES = ("row", "col")
TOL = dict(rtol=2e-4, atol=2e-4)


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
    return torch.load(os.path.join(work, "results.pt"), weights_only=False)


def problem():
    """The reference test's matrix: 240 x 200, three dense rows."""
    rng = np.random.default_rng(3)
    dense = ((rng.random((240, 200)) < 0.05)
             * rng.normal(size=(240, 200))).astype(np.float32)
    dense[:3, :] = rng.normal(size=(3, 200)).astype(np.float32)
    x = rng.normal(size=200).astype(np.float32)
    X = rng.normal(size=(200, 8)).astype(np.float32)
    return dense, x, X


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("shard_map")
    dense, x, X = problem()
    rng = np.random.default_rng(5)
    svc_dense = ((rng.random((200, 200)) < 0.06)
                 * rng.normal(size=(200, 200))).astype(np.float32)
    r_svc = r_csr_from_dense(svc_dense, pad=8)
    ref_plan = str(work / "ref_plan.json")
    RPL.Planner().plan_sharded(r_svc, n_shards=8, axis="row").save(ref_plan)
    store = RPS.PlanStore(str(work / "ref_store"))
    key = store.key_for(r_svc)
    store.put(key, RPL.Planner().plan_sharded(r_svc, n_shards=8,
                                              axis="col"))
    inputs = {"dense": dense, "x": x, "X": X, "svc_dense": svc_dense,
              "svc_x": rng.normal(size=200).astype(np.float32),
              "svc_X": rng.normal(size=(200, 4)).astype(np.float32),
              "ref_plan": ref_plan, "ref_store": str(work / "ref_store"),
              "store_key": key, "port_plan": str(work / "port_plan.json")}
    got = run_world("shard_map", work, inputs)
    return inputs, got["ranks"]


@pytest.fixture(scope="module")
def reference_products():
    """The reference's ``dispatch`` products, one process."""
    dense, x, X = problem()
    rcsr = r_csr_from_dense(dense, pad=8)
    out = {}
    for axis in AXES:
        for strat in STRATEGIES:
            spm = r_build_sharded(rcsr, n_shards=8, axis=axis,
                                  strategy=strat, mode="dispatch")
            out[axis, strat] = {"spmv": np.asarray(spm @ x),
                                "spmm": np.asarray(spm @ X)}
    return out


@pytest.mark.parametrize("op", ("spmv", "spmm"))
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("axis", AXES)
def test_shard_map_products_match_the_oracle_and_the_reference(
        world, reference_products, axis, strategy, op):
    inputs, ranks = world
    want = inputs["dense"] @ (inputs["x"] if op == "spmv" else inputs["X"])
    assert len(ranks) == N_RANKS
    for r in ranks:
        got = r["products"][axis, strategy][op]
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, reference_products[axis, strategy][op],
                                   **TOL)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("axis", AXES)
def test_auto_resolves_to_shard_map_with_the_references_envelope(
        world, axis, strategy):
    """A rank a shard: ``auto`` is ``shard_map``, and ``nbytes()`` is the
    bytes of the whole stacked envelope, as the reference reports."""
    inputs, ranks = world
    rcsr = r_csr_from_dense(inputs["dense"], pad=8)
    _, subs = r_shard_csr(rcsr, 8, axis=axis, strategy=strategy)
    d, c, ip = r_stack_shards(subs)[:3]
    for r in ranks:
        case = r["products"][axis, strategy]
        assert case["mode"] == "shard_map"
        assert case["nbytes"] == d.nbytes + c.nbytes + ip.nbytes


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("axis", AXES)
def test_stack_shards_is_the_references(axis, strategy):
    dense, _, _ = problem()
    _, subs = shard_csr(csr_from_dense(dense, pad=8, device="cpu"), 8,
                        axis=axis, strategy=strategy)
    _, rsubs = r_shard_csr(r_csr_from_dense(dense, pad=8), 8, axis=axis,
                           strategy=strategy)
    got, want = _stack_shards(subs), r_stack_shards(rsubs)
    for a, b in zip(got[:3], want[:3], strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[3:] == want[3:]


def test_four_shards_on_a_world_of_eight_reach_every_rank(world):
    """Ranks 0-3 compute; ranks 4-7, outside the mesh, take ``y`` by one
    broadcast."""
    inputs, ranks = world
    dense = inputs["dense"]
    for rank, r in enumerate(ranks):
        case = r["four"]
        assert case["mode"] == "shard_map"
        assert case["in_mesh"] == (rank < 4)
        np.testing.assert_allclose(case["spmv"], dense @ inputs["x"], **TOL)
        np.testing.assert_allclose(case["spmm"], dense @ inputs["X"], **TOL)


def test_fewer_ranks_than_shards_raise_the_references_plan_error(world):
    _, ranks = world
    with pytest.raises(RPL.PlanError, match="needs >= 16 devices") as ref:
        dense, _, _ = problem()
        r_build_sharded(r_csr_from_dense(dense, pad=8), n_shards=16,
                        mode="shard_map")
    for r in ranks:
        assert r["fewer"] is not None
        assert "needs >= 16 devices for 16 shards; have 8" in r["fewer"]
    assert "have 1" in str(ref.value)


def test_a_callers_mesh_is_used_when_it_fits(world):
    """A 1-D mesh named ``shards`` of 8 serves as it is; a 2x4 mesh
    without that dim gives its first 8 ranks (and the shard count)."""
    inputs, ranks = world
    for r in ranks:
        case = r["mesh"]
        assert case["same"]
        assert case["grid_mode"] == "shard_map"
        assert case["grid_shards"] == 8
        np.testing.assert_allclose(case["spmv"],
                                   inputs["dense"] @ inputs["x"], **TOL)
        np.testing.assert_allclose(case["grid_spmv"],
                                   inputs["dense"] @ inputs["x"], **TOL)


def test_service_serves_a_reference_minted_plan_in_shard_map(world):
    inputs, ranks = world
    want = inputs["svc_dense"] @ inputs["svc_x"]
    for r in ranks:
        case = r["service"]
        assert case["mode"] == "shard_map" and case["from_plan"]
        assert case["n_blocks"] == 8 and case["bytes"] > 0
        np.testing.assert_allclose(case["spmv"], want, **TOL)


def test_store_entry_replays_under_shard_map_without_tuning(world):
    """The reference's store entry (a column-sharded plan) replays on
    every rank with a tuner that raises if called."""
    inputs, ranks = world
    for r in ranks:
        case = r["store"]
        assert case["mode"] == "shard_map" and case["from_plan"]
        np.testing.assert_allclose(
            case["spmv"], inputs["svc_dense"] @ inputs["svc_x"], **TOL)
        np.testing.assert_allclose(
            case["spmm"], inputs["svc_dense"] @ inputs["svc_X"], **TOL)


def test_a_port_minted_plan_serves_in_the_reference(world):
    inputs, _ = world
    plan = RPL.ShardedPlan.load(inputs["port_plan"])
    assert plan.n_shards == 8 and plan.axis == "col"
    spm = r_build_sharded(r_csr_from_dense(inputs["svc_dense"], pad=8),
                          plan=plan, mode="dispatch")
    assert spm.fingerprint_matched
    np.testing.assert_allclose(np.asarray(spm @ inputs["svc_x"]),
                               inputs["svc_dense"] @ inputs["svc_x"], **TOL)
