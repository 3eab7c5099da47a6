"""The multi-rank halves of the port's multi-device tests.

    python tests/torch_worlds.py <world> <workdir>

reads ``<workdir>/inputs.pt`` (numpy arrays and tensors the test made),
starts one ``gloo`` world of CPU ranks (``repro_torch.launch.mesh.spawn``)
that runs every case of ``<world>``, and writes each rank's results, in
rank order, to ``<workdir>/results.pt``.  Worlds: ``shard_map`` (8 ranks,
``tests/test_torch_shard_map.py``), ``distributed`` (8 ranks, then a world
of one; ``tests/test_torch_distributed.py``), ``mesh_train`` (4 ranks,
``tests/test_torch_mesh_train.py``), ``tensor_parallel`` and
``tensor_parallel_serve`` (4 ranks: 1x4, 2x2 and 4x1 meshes;
``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_tensor_parallel_families.py``,
``tests/test_torch_tensor_parallel_serve.py``), ``weight_stationary``
(4 ranks: 2x2 and 4x1 meshes, ``tests/test_torch_weight_stationary.py``,
``tests/test_torch_weight_stationary_families.py``)
and ``seq_parallel`` (4 ranks: 1x4 and 2x2,
``tests/test_torch_seq_parallel.py``).  The tests run it as a
subprocess with a wall limit of their own and compare the results with
the JAX package in their own process; this file imports neither ``jax`` nor
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

    # donate=False: new parameters and moments each step, the given ones
    # left as they were
    fn, _ = jitted_step_for_cell(
        cfg, ShapeConfig("t", S, B, "train"), mesh,
        opt_cfg=adamw.AdamWConfig(**inp["opt"]), microbatches=1,
        donate=False)
    params = tree_map(torch.clone, inp["params"])
    state = adamw.init(params)
    metrics, kept = [], True
    for i in range(tokens.shape[0]):
        given = [getattr(t, "to_local", lambda t=t: t)() for t in
                 tree_leaves([params, state.m, state.v])]
        before = [t.clone() for t in given]
        params, state, m = fn(params, state, {
            "tokens": torch.from_numpy(tokens[i]).long(),
            "labels": torch.from_numpy(labels[i]).long()})
        kept &= all(torch.equal(a, b) for a, b in zip(given, before))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    out["f32_not_donated"] = {
        "metrics": metrics, "given_kept": kept,
        "params": [_np(t.float()) for t in tree_leaves(gather_full(params))]}

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
    kept = decode_without_donation(cfg, mesh, inp, tok, caches, SP,
                                   max_len, B)
    nxt, caches = decode(inp["params"], tok, caches, SP)
    out["serve"] = {"prefill": _np(tok), "decode": _np(nxt),
                    "decode_not_donated": kept,
                    "caches": [_np(t.float()) for t in tree_leaves(
                        gather_full(caches))],
                    "placements": [str(t.placements)
                                   for t in tree_leaves(caches)]}
    return out


def decode_without_donation(cfg, mesh, inp, tok, caches, pos, max_len, B):
    """A decode step built with ``donate=False`` on ``caches``: its
    tokens, and whether the given caches came back unchanged."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import jitted_step_for_cell
    from repro_torch.sharding.rules import tree_leaves
    decode, _ = jitted_step_for_cell(
        cfg, ShapeConfig("d", max_len, B, "decode"), mesh, donate=False)
    before = [t.to_local().clone() for t in tree_leaves(caches)]
    nxt, new = decode(inp["params"], tok, caches, pos)
    return {"decode": _np(nxt), "given_kept": all(
        torch.equal(t.to_local(), b)
        for t, b in zip(tree_leaves(caches), before))}


# ---------------------------------------------------------------------------
# tensor_parallel / tensor_parallel_serve: every architecture on 1x4 and
# 2x2 meshes of one world of 4 (and 4x1 for the MoE and padding cases)
# ---------------------------------------------------------------------------
TP_MESHES = {"1x4": (1, 4), "2x2": (2, 2), "4x1": (4, 1)}


def tp_config(case):
    """The port's config of a case (``test_torch_tensor_parallel.py``
    makes the reference's from the same recipe)."""
    from repro_torch.configs import get_config, smoke_config
    return smoke_config(get_config(case["arch"])).replace(
        **case["kw"]).resolve_for_tp(case["tp"])


def _meshes():
    from repro_torch.launch.mesh import make_mesh
    return {name: make_mesh(dims, ("data", "model"), device="cpu")
            for name, dims in TP_MESHES.items()}


def _local_shapes_are_model_shards(params):
    """Whether each leaf a step computes with (``gather_fsdp``) is the
    ``model`` shard of the whole leaf: whole on every mesh dim but
    ``model``, split on it as the rules place it."""
    from repro_torch.launch.steps import gather_fsdp
    from repro_torch.sharding.rules import tree_leaves
    for t, used in zip(tree_leaves(params), tree_leaves(gather_fsdp(params)),
                       strict=True):
        want = list(t.shape)
        names = t.device_mesh.mesh_dim_names
        for name, p in zip(names, t.placements):
            if name == "model" and p.is_shard():
                want[p.dim] //= t.device_mesh.size(names.index(name))
        if list(used.shape) != want:
            return False
    return True


def _replicas(mesh, params, moment):
    """This rank's coordinates on the mesh dims but ``model`` (``peers``:
    the ranks that share them form its ``model`` group) and, by leaf
    index, its local parameter and first moment of every leaf replicated
    over ``model`` (``replicated``)."""
    from repro_torch.sharding.rules import tree_leaves
    mi = list(mesh.mesh_dim_names).index("model")
    coord = mesh.get_coordinate()
    return {"peers": tuple(c for i, c in enumerate(coord) if i != mi),
            "replicated": {
                i: (_np(p.to_local().float()), _np(m.to_local()))
                for i, (p, m) in enumerate(zip(tree_leaves(params),
                                               tree_leaves(moment),
                                               strict=True))
                if p.placements[mi].is_replicate()}}


def vocab_case(mc):
    """The LM head and vocabulary-parallel cross-entropy of a vocabulary
    of 200 padded to 256 under the mesh context ``mc`` (``None``: one
    rank, the whole vocabulary): the summed NLL and count, the hidden
    state's gradient and the rank's columns of the head's gradient, and
    the all-gathers it made."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import model as M
    from repro_torch.models.layers import lm_head_apply, lm_head_spec
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import MeshContext, use_mesh
    cfg = smoke_config(get_config("qwen3-1.7b")).replace(vocab_size=200)
    g = torch.Generator().manual_seed(0)
    head = torch.randn(cfg.d_model, 256, generator=g) * 0.3
    x = torch.randn(2, 8, cfg.d_model, generator=g)
    labels = torch.randint(0, 200, (2, 8), generator=g)
    labels[0, :3] = -1
    labels[1, :4] = torch.tensor([199, 192, 0, 63])
    mc = mc or MeshContext()
    lo, hi = mc.shard(lm_head_spec(cfg)["w"], 1)
    w = head[:, lo:hi].clone().requires_grad_()
    x = x.requires_grad_()
    before = sum(n for (op, _), n in C.moved.calls.items()
                 if op == "all_gather")
    with use_mesh(mc):
        logits = lm_head_apply({"w": w}, {}, x, cfg).float()
        if logits.shape[-1] == 256:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, labels.clamp_min(0)[..., None]
                                )[..., 0]
        else:
            logz, gold = M._vocab_parallel_terms(logits, labels, cfg)
        mask = (labels >= 0).float()
        nll = ((logz - gold) * mask).sum()
        d_x, d_w = torch.autograd.grad(nll, [x, w])
    gathers = sum(n for (op, _), n in C.moved.calls.items()
                  if op == "all_gather") - before
    return {"nll": float(nll.detach()), "count": float(mask.sum()),
            "d_x": _np(d_x), "d_head": _np(d_w), "lo": lo, "hi": hi,
            "gathers": gathers}


def collective_input(rank):
    return torch.arange(6.0).reshape(2, 3) * (rank + 1) - rank


def collective_weight(rank, shape):
    """The weights rank ``rank``'s loss puts on a collective's output."""
    n = int(np.prod(shape))
    return (torch.arange(float(n)).reshape(shape) * 0.25 - 1.0) * (rank + 2)


#: name -> (the op on a rank's tensor under a mesh context, whether each
#: rank weights the result its own way (else all alike, the loss counted
#: once), whether every rank's input is the same, the computation on
#: every rank's inputs in one process)
COLLECTIVES = {
    "tp_copy": (lambda x, mc: _c().tp_copy(x, mc), True, True,
                lambda ls, r: ls[0] * 1.0),
    "tp_reduce": (lambda x, mc: _c().tp_reduce(x, mc), False, False,
                  lambda ls, r: sum(ls)),
    "tp_sum": (lambda x, mc: _c().tp_sum(x, mc), True, False,
               lambda ls, r: sum(ls)),
    "tp_gather": (lambda x, mc: _c().tp_gather(x, 0, mc), False, False,
                  lambda ls, r: torch.cat(ls)),
    "tp_gather_sum": (lambda x, mc: _c().tp_gather(x, 0, mc, True), True,
                      False, lambda ls, r: torch.cat(ls)),
    "batch_sum": (lambda x, mc: _c().batch_sum(x, mc), False, False,
                  lambda ls, r: sum(ls)),
    # sequence parallelism along dim 1: all-gather / reduce-scatter pairs
    "seq_gather": (lambda x, mc: _c().seq_gather(x, mc), True, False,
                   lambda ls, r: torch.cat(ls, dim=1)),
    "seq_scatter": (lambda x, mc: _c().seq_scatter(x.repeat(1, 4), mc),
                    True, False,
                    lambda ls, r: sum(ls).repeat(1, 4)[:, 3 * r:3 * r + 3]),
}


def _c():
    from repro_torch.sharding import collectives
    return collectives


def collectives_case(rank, mc):
    """Each of ``COLLECTIVES`` on this rank: its output and the gradient
    of its input under this rank's loss."""
    out = {}
    for name, (op, own, shared, _) in COLLECTIVES.items():
        x = collective_input(0 if shared else rank).requires_grad_()
        y = op(x, mc)
        w = collective_weight(rank if own else 0, y.shape)
        (g,) = torch.autograd.grad((y * w).sum(), [x])
        out[name] = (_np(y), _np(g))
    return out


def tensor_parallel_rank(rank, inp, work):
    """One train step, float32 and mixed precision, of every case on its
    meshes (``jitted_step_for_cell``, one microbatch unless the case
    says), and the steps' whole parameters after it on rank 0."""
    from repro_torch.launch.steps import rank_context
    torch.set_num_threads(1)
    meshes = _meshes()
    mc = rank_context(meshes["1x4"], None)
    out = {"vocab": vocab_case(mc), "collectives": collectives_case(
        rank, type(mc)(model_group=mc.model_group, tp=mc.tp,
                       tp_rank=mc.tp_rank, batch_groups=(mc.model_group,)))}
    train_cases(rank, inp, meshes, out)
    return out


def train_cases(rank, inp, meshes, out, moved=False):
    """:func:`tensor_parallel_rank`'s train steps of every case into
    ``out``; ``moved``: with each step's collective calls by (op, mesh
    axis) (:func:`calls_since`)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import gather_full, jitted_step_for_cell
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import tree_leaves, tree_map
    for key, case in inp["cases"].items():
        cfg = tp_config(case)
        batch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
                 else torch.from_numpy(v) for k, v in case["batch"].items()}
        B, S = case["batch"]["tokens"].shape
        F = cfg.frontend_len if cfg.frontend else 0
        for mesh_name in case["meshes"]:
            for mixed in case["precisions"]:
                fn, _ = jitted_step_for_cell(
                    cfg, ShapeConfig("t", S + F, B, "train"),
                    meshes[mesh_name], opt_cfg=adamw.AdamWConfig(
                        **inp["opt"]), microbatches=case["microbatches"],
                    mixed_precision=mixed)
                params = tree_map(torch.clone, case["params"])
                state = (adamw.init_mixed(params) if mixed
                         else adamw.init(params))
                if mixed:
                    params = tree_map(lambda t: t.to(torch.bfloat16), params)
                before = calls_now()
                params, state, m = fn(params, state, batch)
                calls = calls_since(before, meshes[mesh_name])
                kept = state.master if mixed else params
                res = {"loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"]),
                       "model_shards": _local_shapes_are_model_shards(
                           params),
                       **_replicas(meshes[mesh_name], kept, state.m)}
                if moved:
                    res["calls"] = calls
                full = [_np(t.float()) for t in tree_leaves(gather_full(
                    kept))]
                # the first moment after one step: (1 - b1) times the
                # clipped gradient
                moment = [_np(t) for t in tree_leaves(gather_full(state.m))]
                if rank == 0:
                    res["params"], res["moment"] = full, moment
                out[key, mesh_name, "mixed" if mixed else "f32"] = res


def calls_now():
    """Every collective's calls and bytes so far, by (op, group name)."""
    from repro_torch.sharding import collectives as C
    return dict(C.moved.calls), dict(C.moved.bytes)


def calls_since(before, mesh):
    """``{"calls": ..., "bytes": ...}``: the collectives since
    :func:`calls_now` gave ``before``, by (op, mesh axis name)."""
    from repro_torch.sharding import collectives as C
    axis = {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}
    out = {}
    for kind, now, was in (("calls", C.moved.calls, before[0]),
                           ("bytes", C.moved.bytes, before[1])):
        got = {}
        for (op, g), n in now.items():
            if g in axis and n != was.get((op, g), 0):
                got[op, axis[g]] = got.get((op, axis[g]), 0) + n - \
                    was.get((op, g), 0)
        out[kind] = got
    return out


def tensor_parallel_serve_rank(rank, inp, work):
    """A prefill, then a decode step, of every case on its meshes
    (``jitted_step_for_cell``, int8 KV caches placed by
    ``cache_sharding``): the tokens, and on rank 0 the whole caches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import gather_full, jitted_step_for_cell
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import tree_leaves
    torch.set_num_threads(1)
    meshes = _meshes()
    out = {}
    for key, case in inp["cases"].items():
        cfg = tp_config(case).replace(kv_quant=True)
        prompt = {k: torch.from_numpy(v).long() if v.dtype == np.int32
                  else torch.from_numpy(v) for k, v in case["prompt"].items()}
        B, SP = case["prompt"]["tokens"].shape
        F = cfg.frontend_len if cfg.frontend else 0
        max_len = SP + F + case["steps"]
        for mesh_name in case["meshes"]:
            mesh = meshes[mesh_name]
            prefill, _ = jitted_step_for_cell(
                cfg, ShapeConfig("p", SP + F, B, "prefill"), mesh)
            decode, _ = jitted_step_for_cell(
                cfg, ShapeConfig("d", max_len, B, "decode"), mesh)
            caches = M.init_caches(cfg, B, max_len, torch.float32,
                                   device="cpu")
            tok, caches = prefill(case["params"], prompt, caches)
            toks = [_np(tok)]
            for i in range(case["steps"]):
                tok, caches = decode(case["params"], tok, caches,
                                     SP + F + i)
                toks.append(_np(tok))
            res = {"tokens": toks, "model_shards": [
                str(t.placements) for t in tree_leaves(caches)]}
            full = [_np(t.float()) for t in tree_leaves(gather_full(caches))]
            if rank == 0:
                res["caches"] = full
            out[key, mesh_name] = res
    return out


# ---------------------------------------------------------------------------
# weight_stationary: a prefill, then a weight-stationary decode step
# ---------------------------------------------------------------------------
def _torch_inputs(arrays):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in arrays.items()}


def _decode_logits(cfg):
    """A serve step that returns the next position's logits over the
    whole vocabulary in place of the token."""
    from repro_torch.models import model as M

    @torch.no_grad()
    def step(params, tokens, caches, cache_len):
        logits, caches = M.decode_step(params, tokens, caches, cache_len,
                                       cfg)
        return M.full_vocab(logits, cfg)[:, -1], caches
    return step


def weight_stationary_rank(rank, inp, work):
    """Per case and mesh: a prefill (``jitted_step_for_cell``'s prefill
    cell at the caches' length, so its caches are placed as the decode
    cell's; weight-stationary where the case says), then the decode
    step's logits (the same step wiring, nothing donated) and the decode
    step itself (weight-stationary by default): its token, its collectives
    by (op, mesh axis), the shapes of every tensor it gathered over
    ``data``, and on rank 0 the whole caches after it; under
    ``"gathered"`` the same of the step with its parameters gathered
    (``serve_weight_stationary=False``) from the same prefilled caches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.sharding import collectives as C
    from repro_torch.sharding.rules import tree_leaves
    torch.set_num_threads(1)
    meshes = _meshes()
    gathered = []
    real_gather = C.all_gather

    def recording(t, group=None):
        gathered.append((C.group_name(group), tuple(t.shape)))
        return real_gather(t, group)
    C.all_gather = recording
    out = {}
    for key, case in inp["cases"].items():
        cfg = tp_config(case).replace(kv_quant=case["kv_quant"])
        prompt = _torch_inputs(case["prompt"])
        B, SP = case["prompt"]["tokens"].shape
        L = case["max_len"]
        dshape = ShapeConfig("d", L, B, "decode")
        for mesh_name in case["meshes"]:
            mesh = meshes[mesh_name]
            prefill, _ = S.jitted_step_for_cell(
                cfg, ShapeConfig("p", L, B, "prefill"), mesh,
                serve_weight_stationary=case["ws_prefill"],
                kv_quant=case["kv_quant"])
            decode, _ = S.jitted_step_for_cell(cfg, dshape, mesh,
                                               kv_quant=case["kv_quant"])
            gathered_decode, _ = S.jitted_step_for_cell(
                cfg, dshape, mesh, serve_weight_stationary=False,
                donate=False, kv_quant=case["kv_quant"])
            caches = M.init_caches(cfg, B, L, torch.float32, device="cpu")
            tok, caches = prefill(case["params"], prompt, caches)

            def logits(ws):
                return S._placing(S._mesh_serving(
                    _decode_logits(cfg), mesh, S.batch_axes_for(B, mesh),
                    donate=False, ws=ws), S.params_sharding(cfg, mesh),
                    None, S.cache_sharding(cfg, dshape, mesh), None)(
                        case["params"], tok, caches, SP)[0]
            g_nxt, g_caches = gathered_decode(case["params"], tok, caches,
                                              SP)
            g_res = {"decode": _np(g_nxt), "logits": _np(logits(False))}
            full = [_np(t.float()) for t in tree_leaves(
                S.gather_full(g_caches))]
            if rank == 0:
                g_res["caches"] = full
            lg = logits(True)
            del gathered[:]
            before = calls_now()
            nxt, caches = decode(case["params"], tok, caches, SP)
            data = mesh.get_group("data").group_name \
                if mesh.size(0) > 1 else None
            res = {"prefill": _np(tok), "decode": _np(nxt),
                   "logits": _np(lg), **calls_since(before, mesh),
                   "data_gathers": [shp for g, shp in gathered
                                    if g == data],
                   "placements": [str(t.placements)
                                  for t in tree_leaves(caches)],
                   "gathered": g_res}
            full = [_np(t.float()) for t in tree_leaves(
                S.gather_full(caches))]
            if rank == 0:
                res["caches"] = full
            out[key, mesh_name] = res
    C.all_gather = real_gather
    return out


# ---------------------------------------------------------------------------
# seq_parallel: train steps and prefills with the residual stream sharded
# over the sequence
# ---------------------------------------------------------------------------
def seq_parallel_rank(rank, inp, work):
    """Every case's train step (:func:`train_cases`, with its collectives
    by (op, mesh axis)) and a prefill of its batch's tokens (its token and
    collectives)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import jitted_step_for_cell
    from repro_torch.models import model as M
    torch.set_num_threads(1)
    meshes = _meshes()
    out = {}
    train_cases(rank, inp, meshes, out, moved=True)
    for key, case in inp["cases"].items():
        cfg = tp_config(case).replace(kv_quant=True)
        prompt = {"tokens": torch.from_numpy(case["batch"]["tokens"]).long()}
        B, SP = case["batch"]["tokens"].shape
        for mesh_name in case["meshes"]:
            prefill, _ = jitted_step_for_cell(
                cfg, ShapeConfig("p", SP, B, "prefill"), meshes[mesh_name])
            caches = M.init_caches(cfg, B, SP, torch.float32, device="cpu")
            before = calls_now()
            tok, _ = prefill(case["params"], prompt, caches)
            out[key, mesh_name, "prefill"] = {
                "token": _np(tok), **calls_since(before, meshes[mesh_name])}
    return out


RANKS = {"shard_map": (shard_map_rank, 8), "distributed":
         (distributed_rank, 8), "mesh_train": (mesh_train_rank, 4),
         "tensor_parallel": (tensor_parallel_rank, 4),
         "tensor_parallel_serve": (tensor_parallel_serve_rank, 4),
         "weight_stationary": (weight_stationary_rank, 4),
         "seq_parallel": (seq_parallel_rank, 4)}
#: a world's wall limit past ``WORLD_WALL_S``, in seconds
WORLD_WALLS = {"tensor_parallel": 150.0, "tensor_parallel_serve": 150.0,
               "weight_stationary": 150.0, "seq_parallel": 150.0}


def inputs(work):
    return torch.load(os.path.join(work, "inputs.pt"), weights_only=False)


def run_rank(rank, world, work):
    """One rank: its world's cases on the inputs (each rank reads them
    from the file: arguments of a spawned rank travel pickled)."""
    return RANKS[world][0](rank, inputs(work), work)


def main(world, work):
    from repro_torch.launch.mesh import spawn
    results = spawn(run_rank, RANKS[world][1], (world, work), device="cpu",
                    wall_s=WORLD_WALLS.get(world, WORLD_WALL_S),
                    workdir=work)
    extra = (world_of_one(inputs(work), work) if world == "distributed"
             else None)
    torch.save({"ranks": results, "one": extra},
               os.path.join(work, "results.pt"))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
