"""The multi-rank halves of the port's multi-device tests.

    python tests/torch_worlds.py <world> <workdir>

reads ``<workdir>/inputs.pt`` (numpy arrays and tensors the test made),
starts one ``gloo`` world of CPU ranks (``repro_torch.launch.mesh.spawn``)
that runs every case of ``<world>``, and writes each rank's results, in
rank order, to ``<workdir>/results.pt``.  Worlds: ``shard_map`` (8 ranks,
``tests/test_torch_shard_map.py``), ``distributed`` (8 ranks, then a world
of one; ``tests/test_torch_distributed.py``), ``mesh_train`` (4 ranks,
``tests/test_torch_mesh_train.py``).  The tests run it as a subprocess
with a wall limit of their own and compare the results with the JAX
package in their own process; this file imports neither ``jax`` nor
``repro``.
"""
import datetime
import os
import shutil
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

#: the wall limit of one world, in seconds (the tests' own is larger)
WORLD_WALL_S = 90.0
STRATEGIES = ("fixed", "balanced_nnz", "variance")
AXES = ("row", "col")


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# shard_map: the sharded SpMV tier's SPMD executor
# ---------------------------------------------------------------------------
def shard_map_rank(rank, inp, work):
    from repro_torch.core.kernel_tune import KernelTuner
    from repro_torch.core.plan import PlanError, Planner, ShardedPlan
    from repro_torch.core.plan_store import PlanStore
    from repro_torch.core.transform import csr_from_dense
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import SpMVService
    from repro_torch.sharding import build_sharded
    torch.set_num_threads(1)
    csr = csr_from_dense(inp["dense"], pad=8, device="cpu")
    x, X = torch.from_numpy(inp["x"]), torch.from_numpy(inp["X"])
    out = {"products": {}}
    for axis in AXES:
        for strat in STRATEGIES:
            spm = build_sharded(csr, n_shards=8, axis=axis, strategy=strat,
                                device="cpu")
            out["products"][axis, strat] = {
                "mode": spm.mode, "nbytes": spm.nbytes(),
                "spmv": _np(spm @ x), "spmm": _np(spm @ X)}
    spm4 = build_sharded(csr, n_shards=4, device="cpu")
    out["four"] = {"mode": spm4.mode, "spmv": _np(spm4 @ x),
                   "spmm": _np(spm4 @ X),
                   "in_mesh": spm4.mesh.get_coordinate() is not None}
    try:
        build_sharded(csr, n_shards=16, mode="shard_map", device="cpu")
        out["fewer"] = None
    except PlanError as e:
        out["fewer"] = str(e)
    shards = make_mesh((8,), ("shards",), device="cpu")
    spm = build_sharded(csr, axis="col", mesh=shards, device="cpu")
    grid = make_mesh((2, 4), ("data", "model"), device="cpu")
    spm2 = build_sharded(csr, mesh=grid, device="cpu")
    out["mesh"] = {"same": spm.mesh is shards, "spmv": _np(spm @ x),
                   "grid_mode": spm2.mode, "grid_shards": spm2.n_shards,
                   "grid_spmv": _np(spm2 @ x)}

    # the service: a plan the reference minted, and its store entry
    svc_csr = csr_from_dense(inp["svc_dense"], pad=8, device="cpu")
    xs = torch.from_numpy(inp["svc_x"])
    svc = SpMVService(device="cpu")
    entry = svc.register("m", svc_csr, plan=ShardedPlan.load(
        inp["ref_plan"]), measure_baseline=False)
    st = svc.stats()["m"]
    out["service"] = {"mode": entry.matrix.mode, "spmv": _np(svc.spmv(
        "m", xs)), "n_blocks": st["n_blocks"], "bytes": st["bytes"],
        "from_plan": entry.from_plan}

    def no_tuning(thunk, geometry):
        raise AssertionError("a replayed sharded plan tuned")
    store_dir = os.path.join(work, f"store{rank}")
    shutil.copytree(inp["ref_store"], store_dir)
    store = PlanStore(store_dir)
    svc = SpMVService(device="cpu", tuner=KernelTuner(timer=no_tuning))
    entry = svc.register("s", svc_csr, plan=store.get(
        inp["store_key"], fingerprint=svc_csr), measure_baseline=False)
    out["store"] = {"mode": entry.matrix.mode, "from_plan": entry.from_plan,
                    "spmv": _np(svc.spmv("s", xs)),
                    "spmm": _np(svc.spmm("s", torch.from_numpy(
                        inp["svc_X"])))}
    if rank == 0:
        Planner(device="cpu").plan_sharded(svc_csr, n_shards=8,
                                           axis="col").save(inp["port_plan"])
    return out


# ---------------------------------------------------------------------------
# distributed: the reference's five multi-device cases
# ---------------------------------------------------------------------------
def _placement_cases(mesh, rules_shapes):
    """Local shapes and the round trip of a few leaves placed by the rules
    with ``distribute_tensor`` on ``mesh``."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.sharding.rules import RULES_1POD
    out = []
    for axes, shape in rules_shapes:
        sh = RULES_1POD.sharding_for(axes, mesh, shape)
        full = torch.arange(int(np.prod(shape)),
                            dtype=torch.float32).reshape(shape)
        dt = distribute_tensor(full, mesh, sh.placements,
                               src_data_rank=None)
        out.append({"spec": sh.spec, "local": tuple(dt.to_local().shape),
                    "round_trip": bool(torch.equal(dt.full_tensor(),
                                                   full))})
    return out


def distributed_rank(rank, inp, work):
    from torch.distributed.tensor import Shard
    from repro_torch.checkpoint import restore, save
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (distribute, mesh_forward,
                                          params_sharding)
    from repro_torch.optim.compress import (init_error_state,
                                            make_compressed_allreduce)
    from repro_torch.pipeline import pipeline_forward, reference_forward
    from repro_torch.sharding.rules import NamedSharding
    torch.set_num_threads(1)
    out = {}

    # GPipe: two pipelines of 4 stages (one a data row of a 2x4 mesh)
    mesh = make_mesh((2, 4), ("data", "pipe"), device="cpu")
    params = {k: torch.from_numpy(v) for k, v in inp["pipe_params"].items()}
    xm = torch.from_numpy(inp["pipe_x"])

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])
    out["pipe"] = _np(pipeline_forward(params, xm, stage_fn=stage_fn,
                                       mesh=mesh))
    out["pipe_sequential"] = _np(reference_forward(params, xm,
                                                   stage_fn=stage_fn))

    # the int8 compressed all-reduce: this rank's row of the stacked trees
    data = make_mesh((8,), ("data",), device="cpu")
    grads = {k: torch.from_numpy(v[rank]) for k, v in inp["grads"].items()}
    fn = make_compressed_allreduce(data, "data")
    mean, err = fn(grads, init_error_state(grads))
    mean2, err2 = fn(grads, err)
    out["compress"] = {"mean": {k: _np(v) for k, v in mean.items()},
                       "err": {k: _np(v) for k, v in err.items()},
                       "mean2": {k: _np(v) for k, v in mean2.items()},
                       "err2": {k: _np(v) for k, v in err2.items()}}

    # elastic re-shard: save on 4x2, restore on 8 as (None, "data")
    x = torch.arange(64.0).reshape(8, 8)
    m42 = make_mesh((4, 2), ("data", "model"), device="cpu")
    dx = distribute({"x": x}, {"x": NamedSharding(m42, ("data", "model"))})
    save(inp["ckpt"], 1, dx)
    sh8 = NamedSharding(data, (None, "data"))
    got, _ = restore(inp["ckpt"], 1, {"x": x}, shardings={"x": sh8},
                     device="cpu")
    # ... and the reverse: save on 8, restore on 4x2
    y = torch.arange(64.0).reshape(8, 8) * 3.0
    save(inp["ckpt"], 2, distribute({"y": y}, {"y": sh8}))
    back, _ = restore(inp["ckpt"], 2, {"y": y}, shardings={
        "y": NamedSharding(m42, ("data", "model"))}, device="cpu")
    ref, _ = restore(inp["ref_ckpt"], 3, {"z": x}, shardings={"z": sh8},
                     device="cpu")
    out["elastic"] = {
        "full": _np(got["x"].full_tensor()),
        "placements": got["x"].placements == (Shard(1),),
        "local": tuple(got["x"].to_local().shape),
        "back": _np(back["y"].full_tensor()),
        "back_placements": back["y"].placements == (Shard(0), Shard(1)),
        "ref": _np(ref["z"].full_tensor())}

    # the rules on three meshes of this world (1x1: a world of one)
    out["rules"] = {
        "x".join(map(str, shape)): _placement_cases(
            make_mesh(shape, axes, device="cpu"), inp["rules_shapes"])
        for shape, axes in (((2, 2, 2), ("pod", "data", "model")),
                            ((8, 1), ("data", "model")),
                            ((8,), ("data",)))}

    # MoE on a (2, 4) mesh
    from repro_torch.configs import get_config, smoke_config
    cfg = smoke_config(get_config("dbrx-132b")).replace(
        n_layers=2, capacity_factor=4.0)
    grid = make_mesh((2, 4), ("data", "model"), device="cpu")
    moe = distribute(inp["moe_params"], params_sharding(cfg, grid))
    out["moe"] = _np(mesh_forward(moe, {"tokens": torch.from_numpy(
        inp["moe_tokens"]).long()}, cfg, grid).float())
    return out


def world_of_one(inp, work):
    """The 1x1 mesh of the rules case, in a world of one rank."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(work, "one"), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        return _placement_cases(
            make_mesh((1, 1), ("data", "model"), device="cpu"),
            inp["rules_shapes"])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# mesh_train: train steps on a 2x2 mesh
# ---------------------------------------------------------------------------
def mesh_train_rank(rank, inp, work):
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import gather_full, jitted_step_for_cell
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import tree_leaves, tree_map
    torch.set_num_threads(1)
    cfg = smoke_config(get_config("qwen3-1.7b")).replace(n_layers=2)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    tokens, labels = inp["tokens"], inp["labels"]
    B, S = tokens.shape[1:]
    out = {}
    for mixed in (False, True):
        fn, _ = jitted_step_for_cell(
            cfg, ShapeConfig("t", S, B, "train"), mesh,
            opt_cfg=adamw.AdamWConfig(**inp["opt"]), microbatches=1,
            mixed_precision=mixed)
        params = tree_map(torch.clone, inp["params"])
        state = (adamw.init_mixed(params) if mixed else adamw.init(params))
        if mixed:
            params = tree_map(lambda t: t.to(torch.bfloat16), params)
        metrics = []
        for i in range(tokens.shape[0]):
            params, state, m = fn(params, state, {
                "tokens": torch.from_numpy(tokens[i]).long(),
                "labels": torch.from_numpy(labels[i]).long()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        kept = state.master if mixed else params
        out["mixed" if mixed else "f32"] = {
            "metrics": metrics,
            "params": [_np(t.float()) for t in tree_leaves(
                gather_full(kept))],
            "placements": [str(p.placements) for p in tree_leaves(params)],
            "step": int(state.step.to_local())}

    # the serving cells: a prefill, then a decode step, on the same mesh
    from repro_torch.models import model as M
    SP, max_len = inp["serve_tokens"].shape[1], inp["serve_max_len"]
    prefill, _ = jitted_step_for_cell(cfg, ShapeConfig("p", SP, B,
                                                       "prefill"), mesh)
    decode, _ = jitted_step_for_cell(cfg, ShapeConfig("d", max_len, B,
                                                      "decode"), mesh)
    caches = M.init_caches(cfg.replace(kv_quant=True), B, max_len,
                           torch.float32, device="cpu")
    tok, caches = prefill(inp["params"], {"tokens": torch.from_numpy(
        inp["serve_tokens"]).long()}, caches)
    nxt, caches = decode(inp["params"], tok, caches, SP)
    out["serve"] = {"prefill": _np(tok), "decode": _np(nxt),
                    "caches": [_np(t.float()) for t in tree_leaves(
                        gather_full(caches))],
                    "placements": [str(t.placements)
                                   for t in tree_leaves(caches)]}
    return out


RANKS = {"shard_map": (shard_map_rank, 8), "distributed":
         (distributed_rank, 8), "mesh_train": (mesh_train_rank, 4)}


def inputs(work):
    return torch.load(os.path.join(work, "inputs.pt"), weights_only=False)


def run_rank(rank, world, work):
    """One rank: its world's cases on the inputs (each rank reads them
    from the file: arguments of a spawned rank travel pickled)."""
    return RANKS[world][0](rank, inputs(work), work)


def main(world, work):
    from repro_torch.launch.mesh import spawn
    results = spawn(run_rank, RANKS[world][1], (world, work), device="cpu",
                    wall_s=WORLD_WALL_S, workdir=work)
    extra = (world_of_one(inputs(work), work) if world == "distributed"
             else None)
    torch.save({"ranks": results, "one": extra},
               os.path.join(work, "results.pt"))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
