"""Step builders (train / prefill / serve), input specs, and the sharding
of every argument tree over a mesh.

The port of the JAX package's ``launch/steps.py``.  A step is a plain
function over the port's parameter and state trees: the train step
differentiates ``models.loss_fn`` with autograd and applies AdamW, the
prefill and serve steps emit the next token.

On a mesh (``launch/mesh.py``) the shardings come from the logical-axis
rules (``sharding/rules.py``) as in the reference, and
:func:`jitted_step_for_cell` builds the step of a cell.  The reference
hands its step to GSPMD, which inserts the collectives; the port is SPMD
with the collectives written out over the mesh's groups
(``sharding/collectives.py``; the model body has index, scatter and top-k
ops and a ctypes-bound kernel that DTensor's op propagation does not
cover):

  * parameters and moments are DTensors placed by :func:`params_sharding`
    and :func:`opt_sharding`; a step all-gathers each parameter for the
    compute (GSPMD's FSDP all-gather);
  * each rank runs the one-device step on its shard of the batch
    (:func:`batch_sharding`), sums the gradients over the batch axes, and
    updates its own shards with AdamW (the grad norm is the whole tree's);
  * the loss is the reference's, the mean over every label token of the
    global batch: the shards' summed NLL and token counts are reduced, not
    a mean of per-rank means (masked labels differ across shards).  The
    MoE auxiliary loss is the mean of the shards' (the reference takes it
    over the global batch; its capacity also counts the shard's tokens).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import model as M
from ..optim import adamw
from ..sharding import collectives as C
from ..sharding.rules import (RULES_1POD, RULES_ZERO1, NamedSharding,
                              ShardingRules, logical_to_sharding,
                              rules_for_mesh, tree_leaves, tree_map)
from .mesh import data_axis_size, mesh_shape, model_axis_size


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one input (the reference's
    ``jax.ShapeDtypeStruct``); nothing is allocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, TensorSpec]:
    """Model inputs for one step of the given shape cell.

    Train/prefill: the full sequence; frontend archs split the sequence
    into (frontend embeddings, text tokens) so total length == seq_len.
    Decode: a single new token (the KV cache is a separate argument)."""
    B = shape.global_batch
    if shape.kind == "decode":
        return {"tokens": TensorSpec((B, 1), torch.int32)}
    F = cfg.frontend_len if cfg.frontend else 0
    S_text = shape.seq_len - F
    out = {"tokens": TensorSpec((B, S_text), torch.int32),
           "labels": TensorSpec((B, S_text), torch.int32)}
    if cfg.frontend:
        out["frontend_embeds"] = TensorSpec((B, F, cfg.d_model), dtype)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16) -> Any:
    """The decode caches at this cell's length as a tree of
    :class:`TensorSpec` (built on the ``meta`` device: no memory)."""
    caches = M.init_caches(cfg, shape.global_batch, shape.seq_len, dtype,
                           device="meta")
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), caches)


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------
def value_and_grad(params: Any, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig) -> Tuple[torch.Tensor, list]:
    """Loss and the gradient of every parameter leaf (leaf order of
    ``params``); the parameters themselves are not marked."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    with torch.enable_grad():
        loss = M.loss_fn(tree_map(lambda _: next(it), params), batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int = 1, mixed_precision: bool = False,
                    inplace: bool = False) -> Callable:
    """One optimizer step ``(params, opt_state, batch) -> (params,
    opt_state, {"loss", "grad_norm"})``.  ``microbatches`` > 1 accumulates
    the gradients in float32 over batch slices, then divides (the
    reference's scan); ``mixed_precision``: bfloat16 working params and the
    float32 master in the optimizer state.  ``inplace=True`` writes the new
    parameters and moments into the given tensors (the reference donates
    them to its jitted step)."""
    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch, cfg)
        else:
            slices = {k: v.chunk(microbatches, dim=0)
                      for k, v in batch.items()}
            loss, grads = None, None
            for i in range(microbatches):
                l, g = value_and_grad(
                    params, {k: v[i] for k, v in slices.items()}, cfg)
                g = [x.float() for x in g]
                if grads is None:       # the reference adds to zeros
                    loss, grads = l, g
                    continue
                loss = loss + l
                for acc, x in zip(grads, g, strict=True):
                    acc.add_(x)
            loss = loss / microbatches
            for acc in grads:
                acc.div_(microbatches)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        if mixed_precision:
            new_params, new_state, gnorm = adamw.update_mixed(
                opt_cfg, grads, opt_state, inplace=inplace)
        else:
            new_params, new_state, gnorm = adamw.update(
                opt_cfg, grads, opt_state, params, inplace=inplace)
        return new_params, new_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def prefill_step(params, batch, caches):
        logits, caches = M.prefill(params, batch, caches, cfg)
        # serving prefill emits the first generated token
        next_tok = torch.argmax(logits[:, -1:, :], dim=-1)
        return next_tok, caches
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def serve_step(params, tokens, caches, cache_len):
        logits, caches = M.decode_step(params, tokens, caches, cache_len,
                                       cfg)
        next_tok = torch.argmax(logits[:, -1:, :], dim=-1)
        return next_tok, caches
    return serve_step


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Gradient-accumulation depth, the reference's rule: scale with model
    width x depth (activation bytes per token-layer) against its anchor
    (qwen3 at B=256, S=4k fits a 16 GB TPU chip at M=1)."""
    if shape.kind != "train":
        return 1
    cost = cfg.d_model * cfg.n_layers * shape.seq_len * shape.global_batch
    anchor = 2048 * 28 * 4096 * 256
    m = 1
    while cost > anchor * m and m < 64:
        m *= 2
    if cfg.n_experts:
        m *= 2
    while shape.global_batch % m:
        m //= 2
    return max(m, 1)


def param_specs(cfg: ModelConfig, dtype: torch.dtype = torch.float32
                ) -> Any:
    """The parameter tree as :class:`TensorSpec` leaves (no memory)."""
    return tree_map(lambda sp: TensorSpec(tuple(sp.shape), dtype),
                    M.model_spec(cfg))


# ---------------------------------------------------------------------------
# sharding assignment
# ---------------------------------------------------------------------------
def batch_axes_for(B: int, mesh) -> Optional[Tuple[str, ...]]:
    """The mesh axes the batch dim shards over: ``("pod", "data")`` or the
    longest prefix of it that divides ``B``; ``None`` when none does."""
    size = mesh_shape(mesh)
    cands = tuple(a for a in ("pod", "data") if a in size)
    while cands:
        if B % math.prod(size[a] for a in cands) == 0:
            return cands
        cands = cands[:-1]
    return None


def params_sharding(cfg: ModelConfig, mesh,
                    rules: ShardingRules = RULES_1POD) -> Any:
    return logical_to_sharding(M.model_spec(cfg), mesh, rules)


def opt_sharding(cfg: ModelConfig, mesh,
                 rules: ShardingRules = RULES_1POD) -> adamw.AdamWState:
    ps = params_sharding(cfg, mesh, rules)
    return adamw.AdamWState(step=NamedSharding(mesh, ()), m=ps, v=ps)


def batch_sharding(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Any:
    bax = batch_axes_for(shape.global_batch, mesh)
    return {k: NamedSharding(mesh, (bax,) + (None,) * (len(s.shape) - 1))
            for k, s in input_specs(cfg, shape).items()}


def _map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and lists (a path holds the
    dict keys and list indices down to the leaf)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def cache_sharding(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Any:
    """The reference's per-leaf placement of the decode caches:
      * batch dim -> (pod, data) when divisible;
      * attn K/V: kv_heads -> model; if batch unshardable, sequence -> (pod,
        data) (context parallelism);
      * SSM/xLSTM states: heads (or the widest inner dim) -> model.
    The port keeps one cache a layer (the reference stacks the pattern's
    repetitions under ``scan``), so no leaf has a leading layers dim."""
    B = shape.global_batch
    bax = batch_axes_for(B, mesh)
    tp = model_axis_size(mesh)
    dp = data_axis_size(mesh)
    seq_ax = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))

    def leaf(path, s):
        shp = s.shape
        name = [p for p in path if isinstance(p, str)][-1]
        ent: list = [None] * len(shp)
        ent[0] = bax
        if name in ("k", "v", "k_s", "v_s"):      # (B, S, KV[, hd])
            if shp[2] % tp == 0:
                ent[2] = "model"
            if bax is None and seq_ax and shp[1] % dp == 0:
                ent[1] = seq_ax                   # context parallelism
        elif name == "h" and len(shp) == 4:       # mamba (B, H, N, hd)
            if shp[1] % tp == 0:
                ent[1] = "model"
        elif name == "conv":                      # (B, K, C)
            if shp[2] % tp == 0:
                ent[2] = "model"
        elif name == "C" and len(shp) == 4:       # mlstm (B, H, dk, dv)
            if shp[1] % tp == 0:
                ent[1] = "model"
            elif shp[3] % tp == 0:
                ent[3] = "model"
        elif len(shp) >= 3 and shp[-1] % tp == 0 and name in ("c", "n",
                                                              "m", "h"):
            if shp[1] % tp == 0:
                ent[1] = "model"
        return NamedSharding(mesh, tuple(ent))

    return _map_with_path(leaf, cache_specs(cfg, shape))


# ---------------------------------------------------------------------------
# placing trees on a mesh
# ---------------------------------------------------------------------------
def distribute(tree: Any, shardings: Any) -> Any:
    """DTensors of a tree of whole tensors (the same on every rank), each
    leaf placed by its :class:`NamedSharding` — no communication: each rank
    keeps its own shard.  DTensor leaves are kept as they are.  The trees
    pair leaf by leaf (``NamedTuple`` states by field)."""
    from torch.distributed.tensor import DTensor

    def place(t, sh):
        if isinstance(t, DTensor):
            return t
        return DTensor.from_local(C.local_shard(t, sh.mesh, sh.placements),
                                  sh.mesh, sh.placements, run_check=False)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(a, b)
                            for a, b in zip(tree, shardings, strict=True)))
    leaves = [place(t, sh) for t, sh in zip(
        tree_leaves(tree), tree_leaves(shardings), strict=True)]
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def gather_full(tree: Any) -> Any:
    """The whole tensors of a tree of DTensors (a collective: the FSDP
    all-gather of each sharded leaf; plain tensors pass through)."""
    from torch.distributed.tensor import DTensor

    def full(t):
        if not isinstance(t, DTensor):
            return t
        return C.full_tensor(t.to_local(), t.device_mesh, t.placements)
    return tree_map(full, tree)


def _rewrap(like: Any, local: torch.Tensor) -> Any:
    """``local`` as a DTensor placed as ``like`` (plain if ``like`` is)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor):
        return local
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False)


def _local(t: Any) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _batch_ops(mesh, bax):
    """(this rank's rows of a global batch tensor, the sum over the batch
    axes in place, the number of batch shards)."""
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in (bax or ())]
    groups = [mesh.get_group(i) for i in dims if mesh.size(i) > 1]

    def rows(t):
        sh = NamedSharding(mesh, (bax,) + (None,) * (t.ndim - 1))
        return C.local_shard(t, mesh, sh.placements)

    def reduce_(t):
        for g in groups:
            C.all_reduce_(t, group=g)
        return t
    return rows, reduce_, math.prod(mesh.size(i) for i in dims)


def make_mesh_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh,
                         batch_axes: Optional[Tuple[str, ...]],
                         microbatches: int = 1,
                         mixed_precision: bool = False,
                         aux_weight: float = 0.01) -> Callable:
    """The train step on a mesh (see the module docstring): ``(params,
    opt_state, batch) -> (params, opt_state, {"loss", "grad_norm"})`` with
    DTensor parameters and moments, updated in place, and the global batch
    (the same tensors on every rank; microbatch ``m`` is its ``m``-th
    slice of rows, as in the reference's scan, and a rank takes its shard
    of each).  A collective: every rank of ``mesh`` calls it."""
    rows, reduce_, n_shards = _batch_ops(mesh, batch_axes)

    def train_step(params, opt_state, batch):
        full = tree_leaves(gather_full(params))
        loss, grads = None, None
        for mb in range(microbatches):
            part = {k: rows(v.chunk(microbatches, dim=0)[mb])
                    for k, v in batch.items()}
            leaves = [p.detach().requires_grad_() for p in full]
            it = iter(leaves)
            with torch.enable_grad():
                nll, cnt, aux = M.loss_terms(
                    tree_map(lambda _: next(it), params), part, cfg)
                n_tok = reduce_(cnt.detach().clone()).clamp_min(1.0)
                g = torch.autograd.grad(
                    nll / n_tok + aux_weight * aux / n_shards, leaves)
            terms = reduce_(torch.stack([nll.detach(), aux.detach()]))
            l = terms[0] / n_tok + aux_weight * terms[1] / n_shards
            g = [x.float() for x in g]
            if grads is None:
                loss, grads = l, g
                continue
            loss = loss + l
            for acc, x in zip(grads, g, strict=True):
                acc.add_(x)
        del full, leaves, g
        # one all-reduce of every gradient over the batch axes
        sizes = [x.numel() for x in grads]
        shapes = [x.shape for x in grads]
        flat = torch.cat([x.reshape(-1) for x in grads])
        del grads
        flat = reduce_(flat)
        p_leaves = tree_leaves(params)
        if microbatches > 1:
            loss = loss / microbatches
            flat = flat / microbatches
        grads = [x.view(shape) if microbatches > 1
                 else x.view(shape).to(p.dtype)   # the reference's grads
                 for x, shape, p in zip(flat.split(sizes), shapes, p_leaves,
                                        strict=True)]
        gnorm = adamw.global_norm(grads)
        g_local = [C.local_shard(x, p.device_mesh, p.placements)
                   for x, p in zip(grads, p_leaves, strict=True)]

        def local_tree(t):
            return tree_map(_local, t)
        gl = iter(g_local)
        g_tree = tree_map(lambda _: next(gl), params)
        step = opt_state.step
        if mixed_precision:
            state = adamw.AdamWMixedState(
                step=_local(step), m=local_tree(opt_state.m),
                v=local_tree(opt_state.v),
                master=local_tree(opt_state.master))
            work, new, gnorm = adamw.update_mixed(opt_cfg, g_tree, state,
                                                  inplace=True, gnorm=gnorm)
            wl = iter(tree_leaves(work))
            new_params = tree_map(lambda p: _rewrap(p, next(wl)), params)
            new_state = opt_state._replace(step=_rewrap(step, new.step))
        else:
            state = adamw.AdamWState(step=_local(step),
                                     m=local_tree(opt_state.m),
                                     v=local_tree(opt_state.v))
            _, new, gnorm = adamw.update(opt_cfg, g_tree, state,
                                         local_tree(params), inplace=True,
                                         gnorm=gnorm)
            new_params = params
            new_state = opt_state._replace(step=_rewrap(step, new.step))
        return new_params, new_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def _cache_ops(mesh, bax):
    """(a cache tree's rank-local view: the rank's batch rows, every other
    dim whole; the inverse: those back to the tree's placements)."""
    from torch.distributed.tensor import Shard
    names = list(mesh.mesh_dim_names)
    bdims = {names.index(a) for a in (bax or ())}

    def other(t):
        return [i for i, p in enumerate(t.placements)
                if not (i in bdims and p == Shard(0))]

    def to_local(caches):
        return tree_map(lambda t: C.full_tensor(
            t.to_local(), t.device_mesh, t.placements, other(t)), caches)

    def back(like, new):
        out = iter(tree_leaves(new))
        return tree_map(lambda t: _rewrap(t, C.local_shard(
            next(out), t.device_mesh, t.placements, other(t))), like)
    return to_local, back


def mesh_forward(params: Any, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, mesh) -> torch.Tensor:
    """``models.forward``'s logits for the global batch on a mesh: each
    rank gathers the parameters, runs its shard of the batch, and the
    logits are gathered over the batch axes (every rank returns them
    all).  A collective."""
    bax = batch_axes_for(next(iter(batch.values())).shape[0], mesh)
    rows, _, _ = _batch_ops(mesh, bax)
    with torch.no_grad():
        logits, _ = M.forward(gather_full(params),
                              {k: rows(v) for k, v in batch.items()}, cfg)
    sh = NamedSharding(mesh, (bax,) + (None,) * (logits.ndim - 1))
    return C.full_tensor(logits, mesh, sh.placements)


def _mesh_serving(fn: Callable, mesh, bax) -> Callable:
    """A prefill or serve step on a mesh: parameters gathered, the batch
    rows and cache rows of this rank, the new tokens gathered over the
    batch axes, the caches placed back as they came."""
    rows, _, _ = _batch_ops(mesh, bax)
    to_local, back = _cache_ops(mesh, bax)

    def step(params, inputs, caches, *rest):
        inputs = ({k: rows(v) for k, v in inputs.items()}
                  if isinstance(inputs, dict) else rows(inputs))
        tok, new = fn(gather_full(params), inputs, to_local(caches), *rest)
        sh = NamedSharding(mesh, (bax, None))
        return C.full_tensor(tok, mesh, sh.placements), back(caches, new)
    return step


def _placing(fn: Callable, *shardings: Any) -> Callable:
    """``fn`` with each argument tree placed by its shardings first (the
    reference's ``in_shardings``): whole tensors become DTensors, DTensors
    are taken as they come; a ``None`` sharding leaves the argument."""
    def placed(*args):
        return fn(*(a if sh is None else distribute(a, sh)
                    for a, sh in zip(args, shardings, strict=True)))
    return placed


def jitted_step_for_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                         opt_cfg: Optional[adamw.AdamWConfig] = None,
                         rules: Optional[ShardingRules] = None,
                         microbatches: Optional[int] = None,
                         zero1: bool = False,
                         kv_quant: Optional[bool] = None,
                         mixed_precision: bool = False):
    """Build ``(step_fn, abstract_args)`` for one (arch x shape) cell on
    ``mesh`` (the reference's name; nothing is compiled):

    train  -> train_step(params, opt_state, batch)
    prefill-> prefill_step(params, batch, caches)
    decode -> serve_step(params, tokens, caches, cache_len)

    ``abstract_args`` are :class:`TensorSpec` trees of the global
    arguments.  The step places whole-tensor arguments by the cell's
    shardings (``params_sharding`` under ``rules``, or ``RULES_ZERO1`` with
    ``zero1``: parameters replicated, moments still sharded by ``rules``;
    ``opt_sharding``; ``cache_sharding``) and returns DTensors so placed;
    the batch is the global one on every rank.  Serving cells run with the
    int8 KV cache unless ``kv_quant`` says otherwise.  Every step is a
    collective over ``mesh``."""
    rules = rules or rules_for_mesh(mesh)
    bax = batch_axes_for(shape.global_batch, mesh)
    binp = input_specs(cfg, shape)
    ps = params_sharding(cfg, mesh, RULES_ZERO1 if zero1 else rules)
    if shape.kind == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        mb = (microbatches if microbatches is not None
              else default_microbatches(cfg, shape))
        fn = make_mesh_train_step(cfg, opt_cfg, mesh, bax, microbatches=mb,
                                  mixed_precision=mixed_precision)
        base = params_sharding(cfg, mesh, rules)
        rep = NamedSharding(mesh, ())
        p32 = param_specs(cfg, torch.float32)
        step = TensorSpec((), torch.int32)
        if mixed_precision:
            osh = adamw.AdamWMixedState(step=rep, m=base, v=base,
                                        master=base)
            args = (param_specs(cfg, torch.bfloat16),
                    adamw.AdamWMixedState(step=step, m=p32, v=p32,
                                          master=p32), binp)
        else:
            osh = adamw.AdamWState(step=rep, m=base, v=base)
            args = (p32, adamw.AdamWState(step=step, m=p32, v=p32), binp)
        return _placing(fn, ps, osh, None), args
    cfg = cfg.replace(kv_quant=True if kv_quant is None else kv_quant)
    csh = cache_sharding(cfg, shape, mesh)
    cargs = cache_specs(cfg, shape)
    params = param_specs(cfg, torch.bfloat16)
    if shape.kind == "prefill":
        return (_placing(_mesh_serving(make_prefill_step(cfg), mesh, bax),
                         ps, None, csh), (params, binp, cargs))
    return (_placing(_mesh_serving(make_serve_step(cfg), mesh, bax),
                     ps, None, csh, None),
            (params, binp["tokens"], cargs, TensorSpec((), torch.int32)))


__all__ = ["TensorSpec", "input_specs", "cache_specs", "param_specs",
           "value_and_grad", "make_train_step", "make_prefill_step",
           "make_serve_step", "default_microbatches", "batch_axes_for",
           "params_sharding", "opt_sharding", "batch_sharding",
           "cache_sharding", "distribute", "gather_full",
           "make_mesh_train_step", "mesh_forward", "jitted_step_for_cell"]
