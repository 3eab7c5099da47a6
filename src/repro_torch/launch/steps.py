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
    and :func:`opt_sharding`; a step all-gathers each parameter over the
    FSDP axes only (``data``, and ``pod`` under ``RULES_2POD``:
    :func:`gather_fsdp`), keeping its ``model`` shard;
  * the blocks compute tensor-parallel on those shards (column- and
    row-parallel heads and ``d_ff``, expert parallelism, the SSM/xLSTM
    ``inner`` dim, vocabulary-parallel logits and cross-entropy), reading
    the ``model`` group from the ``sharding/rules.py:MeshContext`` the
    step enters; with a ``model`` axis of 1 every one of their
    collectives is the identity;
  * each rank runs its shard of the batch (:func:`batch_sharding`); a
    microbatch of fewer rows than the batch shards is padded with rows
    whose labels are all ``-1``, left out of the loss and of the MoE
    router's statistics, so the step is the reference's function of the
    real rows;
  * the gradients come back ``model``-shard-sized, are summed over the
    batch axes, and each rank updates its own shards with AdamW (the grad
    norm counts each element once: the sharded leaves' squares summed
    over ``model``);
  * the loss is the reference's, the mean over every label token of the
    global batch: the shards' summed NLL and token counts are reduced, not
    a mean of per-rank means (masked labels differ across shards); the MoE
    auxiliary loss is taken over the global microbatch (``models/moe.py``:
    its two batch means summed over the batch axes);
  * train and prefill steps keep the residual stream sharded over the
    sequence on ``model`` where the config's ``use_seq_sp`` and the rules
    allow it (``MeshContext.seq_parallel``): each block all-gathers it and
    reduce-scatters its row-parallel partial sums;
  * a decode cell is weight-stationary by default, as in the reference
    (:func:`_mesh_serving` with ``ws``): no parameter is gathered, every
    rank holds the global batch and its columns of ``d``, and the caches
    stay as they are placed — a cache whose batch does not split over
    ``data`` has its sequence split there, and the attention merges each
    rank's softmax over its slots (context parallelism).
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
from ..sharding.rules import (RULES_1POD, RULES_ZERO1, MeshContext,
                              NamedSharding, ShardingRules,
                              logical_to_sharding, rules_for_mesh,
                              tree_leaves, tree_map, use_mesh)
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
        next_tok = torch.argmax(M.full_vocab(logits[:, -1:, :], cfg), dim=-1)
        return next_tok, caches
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    @torch.no_grad()
    def serve_step(params, tokens, caches, cache_len):
        logits, caches = M.decode_step(params, tokens, caches, cache_len,
                                       cfg)
        next_tok = torch.argmax(M.full_vocab(logits[:, -1:, :], cfg), dim=-1)
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
    """The per-leaf placement of the decode caches, as the blocks compute
    on a mesh (``models/*.py``):
      * batch dim -> (pod, data) when divisible;
      * attn K/V: kv_heads -> model; if batch unshardable, sequence -> (pod,
        data) (context parallelism);
      * Mamba-2 ``h``: heads -> model; its conv cache replicated (every
        channel: a rank's conv reads all of B and C);
      * mLSTM ``C``/``n``/``m``: heads -> model where they divide it, else
        replicated (the recurrence runs whole on each rank); its conv
        cache's channels -> model;
      * sLSTM ``c``/``n``/``h``/``m``: each head's units -> model where
        ``R`` is sharded over its gate columns, else replicated.
    The port keeps one cache a layer (the reference stacks the pattern's
    repetitions under ``scan``), so no leaf has a leading layers dim."""
    B = shape.global_batch
    bax = batch_axes_for(B, mesh)
    tp = model_axis_size(mesh)
    dp = data_axis_size(mesh)
    seq_ax = tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))
    slstm_units = (cfg.xlstm_shard_recurrent and
                   (4 * cfg.d_model // cfg.n_heads) % tp == 0)

    def leaf(path, s):
        shp = s.shape
        block, name = [p for p in path if isinstance(p, str)][-2:]
        ent: list = [None] * len(shp)
        ent[0] = bax
        if block == "attn":                       # (B, S, KV[, hd])
            if shp[2] % tp == 0:
                ent[2] = "model"
            if bax is None and seq_ax and shp[1] % dp == 0:
                ent[1] = seq_ax                   # context parallelism
        elif block == "mamba" and name == "h":    # (B, H, N, hd)
            if shp[1] % tp == 0:
                ent[1] = "model"
        elif block == "mlstm" and name == "conv":  # (B, 3, d_in)
            if shp[2] % tp == 0:
                ent[2] = "model"
        elif block == "mlstm" and name in ("C", "n", "m"):  # (B, H, ...)
            if shp[1] % tp == 0:
                ent[1] = "model"
        elif block == "slstm":                    # (B, H, dh)
            if slstm_units and shp[2] % tp == 0:
                ent[2] = "model"
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
    """The whole tensors of a tree of DTensors (a collective: the
    all-gather of each sharded leaf; plain tensors pass through)."""
    from torch.distributed.tensor import DTensor

    def full(t):
        if not isinstance(t, DTensor):
            return t
        return C.full_tensor(t.to_local(), t.device_mesh, t.placements)
    return tree_map(full, tree)


def fsdp_dims(mesh) -> list:
    """The mesh dims a step gathers parameters over: all but ``model``."""
    return [i for i, n in enumerate(mesh.mesh_dim_names) if n != "model"]


def gather_fsdp(tree: Any) -> Any:
    """Each DTensor leaf of a tree gathered over the FSDP axes only (every
    mesh dim but ``model``: GSPMD's FSDP all-gather), leaving the rank's
    ``model`` shard; plain tensors pass through.  A collective."""
    from torch.distributed.tensor import DTensor

    def part(t):
        if not isinstance(t, DTensor):
            return t
        mesh = t.device_mesh
        return C.full_tensor(t.to_local(), mesh, t.placements,
                             fsdp_dims(mesh))
    return tree_map(part, tree)


def rank_context(mesh, bax, real_rows: Optional[torch.Tensor] = None,
                 rules: Optional[ShardingRules] = None, *, ws: bool = False,
                 spans: Optional[Dict[int, Optional[tuple]]] = None
                 ) -> MeshContext:
    """The :class:`~repro_torch.sharding.rules.MeshContext` of this rank of
    ``mesh`` with the batch over ``bax`` and the parameters placed by
    ``rules`` (default :func:`rules_for_mesh`); ``ws``: weight-stationary
    serving (the FSDP axes the rules split ``embed`` over are the
    ``data_groups``); ``spans``: the cache leaves' spans (:func:`_cache_ops`)."""
    names = list(mesh.mesh_dim_names)
    tp = mesh.size(names.index("model")) if "model" in names else 1
    rules = rules or rules_for_mesh(mesh)
    data_groups: tuple = ()
    if ws:
        m = rules.spec_for(("embed",), mesh)[0]
        m = () if m is None else (m if isinstance(m, tuple) else (m,))
        data_groups = tuple(mesh.get_group(a) for a in names
                            if a in m and mesh.size(names.index(a)) > 1)
    return MeshContext(
        model_group=mesh.get_group("model") if tp > 1 else None, tp=tp,
        tp_rank=mesh.get_local_rank("model") if tp > 1 else 0,
        batch_groups=tuple(mesh.get_group(a) for a in (bax or ())
                           if mesh.size(names.index(a)) > 1),
        real_rows=real_rows, mesh=mesh, rules=rules, ws=ws,
        data_groups=data_groups, spans=spans)


def _rewrap(like: Any, local: torch.Tensor) -> Any:
    """``local`` as a DTensor placed as ``like`` (plain if ``like`` is)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(like, DTensor):
        return local
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False)


def _rewrap_tree(like: Any, new: Any) -> Any:
    """The leaves of ``new`` placed as the leaves of ``like``."""
    leaves = iter(tree_leaves(new))
    return tree_map(lambda t: _rewrap(t, next(leaves)), like)


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


def _padded(batch: Dict[str, torch.Tensor], shards: int):
    """``(batch, real rows or None)``: rows past the last real one added
    until the batch splits over ``shards`` (tokens 0, labels all ``-1``,
    zero frontend embeddings), and a mask of the real rows; the batch as
    it is (``None``) when it splits already."""
    R = next(iter(batch.values())).shape[0]
    pad = -R % shards
    if not pad:
        return batch, None

    def fill(k, v):
        extra = v.new_full((pad,) + v.shape[1:], -1 if k == "labels" else 0)
        return torch.cat([v, extra])
    real = torch.arange(R + pad, device=next(iter(batch.values())).device) < R
    return {k: fill(k, v) for k, v in batch.items()}, real


def _grad_norm(grads: list, params: list, mesh) -> torch.Tensor:
    """The global norm of ``model``-shard gradients: each element counted
    once (the squares of a leaf sharded over ``model`` summed over it, a
    replicated leaf's taken once)."""
    names = list(mesh.mesh_dim_names)
    mi = names.index("model") if "model" in names else None
    dev = grads[0].device
    sq = [torch.zeros((), dtype=torch.float32, device=dev) for _ in "rs"]
    for g, p in zip(grads, params, strict=True):
        sharded = mi is not None and p.placements[mi].is_shard()
        sq[sharded] = sq[sharded] + g.float().square().sum()
    if mi is not None and mesh.size(mi) > 1:
        C.all_reduce_(sq[1], group=mesh.get_group(mi))
    return (sq[0] + sq[1]).sqrt()


#: dtypes of parameters held in low precision (mixed precision's working
#: copy)
LOW = (torch.bfloat16, torch.float16)


def make_mesh_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh,
                         batch_axes: Optional[Tuple[str, ...]],
                         microbatches: int = 1,
                         mixed_precision: bool = False,
                         aux_weight: float = 0.01,
                         inplace: bool = True,
                         rules: Optional[ShardingRules] = None) -> Callable:
    """The train step on a mesh (see the module docstring): ``(params,
    opt_state, batch) -> (params, opt_state, {"loss", "grad_norm"})`` with
    DTensor parameters and moments, updated in place (new ones with
    ``inplace=False``), and the global batch (the same tensors on every
    rank; microbatch ``m`` is its ``m``-th slice of rows, as in the
    reference's scan, padded to split over the batch shards, and a rank
    takes its shard of each).  ``rules``: the ones that placed the
    parameters (default :func:`rules_for_mesh`).  A collective: every rank
    of ``mesh`` calls it."""
    rows, reduce_, n_shards = _batch_ops(mesh, batch_axes)
    fsdp = fsdp_dims(mesh)

    def train_step(params, opt_state, batch):
        local = tree_leaves(gather_fsdp(params))
        loss, grads = None, None
        for mb in range(microbatches):
            part, real = _padded({k: v.chunk(microbatches, dim=0)[mb]
                                  for k, v in batch.items()}, n_shards)
            part = {k: rows(v) for k, v in part.items()}
            # a low-precision leaf differentiated through a float32 copy:
            # the batch shards' gradients are summed in float32 and
            # rounded once, as one device's gradient is
            leaves = [(p.detach().float() if p.dtype in LOW else
                       p.detach()).requires_grad_() for p in local]
            it = iter(leaves)
            ctx = rank_context(mesh, batch_axes,
                               None if real is None else rows(real), rules)
            with torch.enable_grad(), use_mesh(ctx):
                nll, cnt, aux = M.loss_terms(
                    tree_map(lambda _: next(it), params), part, cfg)
                n_tok = reduce_(cnt.detach().clone()).clamp_min(1.0)
                g = torch.autograd.grad(nll / n_tok + aux_weight * aux,
                                        leaves)
            # the auxiliary loss is the global batch's on every rank
            l = reduce_(nll.detach().clone()) / n_tok + \
                aux_weight * aux.detach()
            g = [x.float() for x in g]
            if grads is None:
                loss, grads = l, g
                continue
            loss = loss + l
            for acc, x in zip(grads, g, strict=True):
                acc.add_(x)
        del local, leaves, g
        # one all-reduce of every gradient (the rank's model shards) over
        # the batch axes
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
        gnorm = _grad_norm(grads, p_leaves, mesh)
        g_local = [C.local_shard(x, p.device_mesh, p.placements, fsdp)
                   for x, p in zip(grads, p_leaves, strict=True)]

        def local_tree(t):
            return tree_map(_local, t)
        gl = iter(g_local)
        g_tree = tree_map(lambda _: next(gl), params)
        local = type(opt_state)(*(tree_map(_local, f) for f in opt_state))
        if mixed_precision:
            new_p, new, gnorm = adamw.update_mixed(
                opt_cfg, g_tree, local, inplace=inplace, gnorm=gnorm)
        else:
            new_p, new, gnorm = adamw.update(
                opt_cfg, g_tree, local, local_tree(params), inplace=inplace,
                gnorm=gnorm)
        new_params = _rewrap_tree(params, new_p)
        new_state = type(opt_state)(*(
            _rewrap_tree(a, b) for a, b in zip(opt_state, new, strict=True)))
        return new_params, new_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def _cache_ops(mesh, donate: bool, ws: bool):
    """(a cache tree's rank-local view and the spans of its leaves; the
    inverse: the view's leaves back into the tree).  The rank keeps every
    leaf's local shard as it is placed — its batch rows, its slot range
    where the sequence is sharded (context parallelism), its ``model``
    shards — and nothing is gathered; ``spans`` (``MeshContext.spans``)
    names the slot ranges and, under ``ws`` (where the step holds the
    global batch), the batch rows.  With ``donate`` the step writes the
    given caches' shards in place and returns them (the reference's
    donated cache); without, the given caches are left as they are and new
    ones returned."""
    from torch.distributed.tensor import Shard
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()

    def span(t, local):
        dims = {}
        for i, p in enumerate(t.placements):
            if isinstance(p, Shard) and names[i] != "model" and \
                    mesh.size(i) > 1:
                dims.setdefault(p.dim, []).append(i)
        if len(dims) > 1 or not set(dims) <= {0, 1}:
            raise ValueError(
                f"a cache leaf placed {t.placements} on {names}: the blocks "
                "read a split of its batch rows or of its slots, not both "
                "and no other dim")
        for d, axes in dims.items():
            if d == 1 or ws:
                idx, parts = 0, 1
                for i in axes:
                    idx, parts = idx * mesh.size(i) + coord[i], \
                        parts * mesh.size(i)
                n = local.shape[d]
                return (d, idx * n, (idx + 1) * n, parts * n,
                        tuple(mesh.get_group(i) for i in axes))
        return None

    def to_local(caches):
        spans = {}

        def view(t):
            local = t.to_local()
            out = local if donate else local.clone()
            spans[id(out)] = span(t, out)
            return out
        return tree_map(view, caches), spans

    def back(like, new):
        out = iter(tree_leaves(new))

        def leaf(t):
            got, local = next(out), t.to_local()
            if not donate:
                return _rewrap(t, got)
            if not _same(got, local):
                local.copy_(got)
            return t
        return tree_map(leaf, like)
    return to_local, back


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` are the same elements of one storage
    (``Tensor.is_set_to`` is false for any two fake tensors)."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset()
            and a.shape == b.shape and a.stride() == b.stride())


def mesh_forward(params: Any, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, mesh) -> torch.Tensor:
    """``models.forward``'s logits for the global batch on a mesh: each
    rank gathers the parameters over the FSDP axes, runs its shard of the
    batch tensor-parallel over ``model`` (sequence-parallel where the
    config asks), and the logits are gathered over ``model`` and the batch
    axes (every rank returns them all).  A collective."""
    bax = batch_axes_for(next(iter(batch.values())).shape[0], mesh)
    rows, _, _ = _batch_ops(mesh, bax)
    with torch.no_grad(), use_mesh(rank_context(mesh, bax)):
        logits, _ = M.forward(gather_fsdp(params),
                              {k: rows(v) for k, v in batch.items()}, cfg)
        logits = M.full_vocab(logits, cfg)
    sh = NamedSharding(mesh, (bax,) + (None,) * (logits.ndim - 1))
    return C.full_tensor(logits, mesh, sh.placements)


def _mesh_serving(fn: Callable, mesh, bax, donate: bool = True,
                  rules: Optional[ShardingRules] = None,
                  ws: bool = False) -> Callable:
    """A prefill or serve step on a mesh, the caches' local shards kept
    as they are placed (:func:`_cache_ops`) and written back in place with
    ``donate``, tensor-parallel over ``model``:

      * by default parameters are gathered over the FSDP axes, the rank
        runs its batch rows and the new tokens are gathered over the batch
        axes;
      * ``ws`` (weight-stationary, the reference's ``RULES_SERVE``):
        nothing is gathered — each rank reads its FSDP x ``model`` shard of
        every parameter, holds the global batch (the tokens every rank
        returns are the global ones) and its columns of the residual
        stream's ``d``, and a block's caches are its batch rows or slot
        range (``MeshContext.spans``)."""
    rows, _, _ = _batch_ops(mesh, bax)
    to_local, back = _cache_ops(mesh, donate, ws)

    def step(params, inputs, caches, *rest):
        if not ws:
            inputs = ({k: rows(v) for k, v in inputs.items()}
                      if isinstance(inputs, dict) else rows(inputs))
        local, spans = to_local(caches)
        ctx = rank_context(mesh, None if ws else bax, rules=rules, ws=ws,
                           spans=spans)
        with use_mesh(ctx):
            tok, new = fn(tree_map(_local, params) if ws
                          else gather_fsdp(params), inputs, local, *rest)
        if ws:
            return tok, back(caches, new)
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
    placed.shardings = shardings
    return placed


def jitted_step_for_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                         opt_cfg: Optional[adamw.AdamWConfig] = None,
                         rules: Optional[ShardingRules] = None,
                         donate: bool = True,
                         microbatches: Optional[int] = None,
                         serve_weight_stationary: Optional[bool] = None,
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
    ``opt_sharding``; ``cache_sharding``; ``step_fn.shardings`` holds them,
    ``None`` for an argument taken as it comes) and returns DTensors so
    placed; the batch is the global one on every rank.  ``donate`` (the
    reference's donated arguments): the train step updates the parameters
    and moments in place, a serving step writes the caches in place;
    without it both return new tensors and leave the given ones.  Serving
    cells run with the int8 KV cache unless ``kv_quant`` says otherwise,
    and weight-stationary where ``serve_weight_stationary`` says, by
    default (``None``) for a decode cell and not for a prefill, as in the
    reference (:func:`_mesh_serving`).  Train and prefill steps keep the
    residual stream sharded over the sequence on ``model`` where the
    config's ``use_seq_sp`` and the rules allow it.  Every step is a
    collective over ``mesh``."""
    rules = rules or rules_for_mesh(mesh)
    bax = batch_axes_for(shape.global_batch, mesh)
    binp = input_specs(cfg, shape)
    prules = RULES_ZERO1 if zero1 else rules
    ps = params_sharding(cfg, mesh, prules)
    if shape.kind == "train":
        opt_cfg = opt_cfg or adamw.AdamWConfig()
        mb = (microbatches if microbatches is not None
              else default_microbatches(cfg, shape))
        # every microbatch over every batch axis: one that does not split
        # is padded (make_mesh_train_step), whatever the global batch
        train_bax = tuple(a for a in ("pod", "data")
                          if a in mesh_shape(mesh)) or None
        fn = make_mesh_train_step(cfg, opt_cfg, mesh, train_bax,
                                  microbatches=mb,
                                  mixed_precision=mixed_precision,
                                  inplace=donate, rules=prules)
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
    ws = (shape.kind == "decode" if serve_weight_stationary is None
          else bool(serve_weight_stationary))
    if ws:
        d_split = prules.spec_for(("embed",), mesh, (cfg.d_model,))[0]
        if d_split is None and data_axis_size(mesh) > 1:
            raise ValueError(
                f"weight-stationary serving splits d_model={cfg.d_model} "
                f"over the FSDP axes, which the rules do not split it over "
                f"on this mesh {mesh_shape(mesh)}")
    cfg = cfg.replace(kv_quant=True if kv_quant is None else kv_quant)
    csh = cache_sharding(cfg, shape, mesh)
    cargs = cache_specs(cfg, shape)
    params = param_specs(cfg, torch.bfloat16)
    if shape.kind == "prefill":
        return (_placing(_mesh_serving(make_prefill_step(cfg), mesh, bax,
                                       donate, prules, ws),
                         ps, None, csh),
                (params, binp, cargs))
    return (_placing(_mesh_serving(make_serve_step(cfg), mesh, bax, donate,
                                   prules, ws), ps, None, csh, None),
            (params, binp["tokens"], cargs, TensorSpec((), torch.int32)))


__all__ = ["TensorSpec", "input_specs", "cache_specs", "param_specs",
           "value_and_grad", "make_train_step", "make_prefill_step",
           "make_serve_step", "default_microbatches", "batch_axes_for",
           "params_sharding", "opt_sharding", "batch_sharding",
           "cache_sharding", "distribute", "gather_full", "fsdp_dims",
           "gather_fsdp", "rank_context",
           "make_mesh_train_step", "mesh_forward", "jitted_step_for_cell"]
