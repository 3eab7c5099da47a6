"""The collectives of the port's multi-device tier, on any backend.

Thin wrappers over ``torch.distributed`` for the six collectives the
SPMD code uses — ``all_gather``, ``all_reduce``, ``reduce_scatter``,
``broadcast``, a ring shift (the reference's ``ppermute``) and the gather
of a sharded tensor —
that also run where the backend cannot take the tensors as they are:
``gloo`` moves CPU tensors only for most collectives (its CUDA support is
``broadcast`` and ``all_reduce``), so on a ``gloo`` world with tensors on a
card every collective here is staged through host memory explicitly (copy
out, collective on the host copy, copy back).  That is the transport of a
named backend, not a fallback: the computation stays on the card.  NCCL
takes card tensors directly.

Every staged call adds the bytes it copied to the host to ``stage.bytes``
(a process-wide counter, as the kernels count their launches); a caller
reads it before and after.  Beside it, every collective adds the bytes of
its result on this rank (the reference's HLO collective bytes) to
``moved.bytes`` and one to ``moved.calls``, keyed by ``(op, group
name)``: the dry run (``launch/roofline.py``) reads them around a traced
step and maps each group to its mesh axis.  The
host copies are pinned (a copy out of the card runs at 26 GB/s into
pinned memory against 7 GB/s into pageable memory on the H100's host:
``experiments/torch_gloo_staging.py``).

Each function is a collective over ``group`` (default: the world): every
rank of the group calls it in the same order.

The tensor-parallel collectives (:func:`tp_copy`, :func:`tp_reduce`,
:func:`tp_sum`, :func:`tp_gather`, :func:`tp_max`, :func:`tp_grad_once`,
:func:`batch_sum`), the sequence-parallel pair (:func:`seq_gather`,
:func:`seq_scatter`) and the weight-stationary serving ones over the FSDP
axes (:func:`data_sum`, :func:`data_gather`, :func:`lse_merge`) work over
the groups of a step's :class:`~repro_torch.sharding.rules.MeshContext`,
built on the ones above, so every one of them is counted in ``moved`` as
well.  A group of one rank (``tp == 1``, no batch axis, no FSDP axis)
makes each of them the identity: nothing is called and nothing counted.
Low-precision tensors are reduced in float32 and rounded once.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def stage(t: torch.Tensor, group=None) -> bool:
    """Whether a collective over ``group`` on ``t`` goes through the host:
    a ``gloo`` group and a tensor off the CPU."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


#: bytes copied to the host by staged collectives in this process
stage.bytes = 0


def group_name(group=None) -> str:
    """The name of ``group`` (the world's when ``None``), as
    ``moved`` keys it."""
    return (group if group is not None else dist.group.WORLD).group_name


def moved(op: str, group, nbytes: int) -> None:
    """Count one collective: ``nbytes`` of result on this rank."""
    key = (op, group_name(group))
    moved.bytes[key] = moved.bytes.get(key, 0) + nbytes
    moved.calls[key] = moved.calls.get(key, 0) + 1


#: bytes of every collective's result on this rank, by (op, group name)
moved.bytes = {}
#: calls of every collective, by (op, group name)
moved.calls = {}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host(t: torch.Tensor) -> torch.Tensor:
    stage.bytes += _nbytes(t)
    return _pinned_like(t).copy_(t.detach())


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on each), in group-rank
    order, on ``t``'s device."""
    n = dist.get_world_size(group)
    moved("all_gather", group, n * _nbytes(t))
    if not stage(t, group):
        out = [torch.empty_like(t, memory_format=torch.contiguous_format)
               for _ in range(n)]
        dist.all_gather(out, t.contiguous(), group=group)
        return out
    out = [_pinned_like(t) for _ in range(n)]
    dist.all_gather(out, _host(t), group=group)
    return [o.to(t.device) for o in out]


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM,
                group=None) -> torch.Tensor:
    """``t`` reduced over the group, in place; returns ``t``."""
    moved("all_reduce", group, _nbytes(t))
    if stage(t, group):
        h = _host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _group_rank(group=None) -> int:
    return (dist.get_group_rank(group, dist.get_rank()) if group is not None
            else dist.get_rank())


def reduce_scatter(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's slice along ``dim`` (the group rank's of equal slices)
    of ``t`` summed over the group; a new tensor.  ``gloo`` has no
    reduce-scatter: there it is an all-reduce whose result each rank
    slices — counted in ``moved`` as the reduce-scatter it stands for, with
    a reduce-scatter's result bytes (the process group sees an
    all-reduce)."""
    n = dist.get_world_size(group)
    moved("reduce_scatter", group, _nbytes(t) // n)
    if dist.get_backend(group) == "gloo":
        staged = stage(t, group)
        h = _host(t) if staged else t.contiguous().clone()
        dist.all_reduce(h, group=group)
        full = h.to(t.device) if staged else h
        return full.chunk(n, dim=dim)[_group_rank(group)].contiguous()
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    # ``reduce_scatter_single`` where this torch has it (the newer name)
    fn = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
    fn(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from global rank ``src`` on every rank, in place."""
    moved("broadcast", group, _nbytes(t))
    if stage(t, group):
        h = _host(t)
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def ring_shift(t: torch.Tensor, group=None) -> torch.Tensor:
    """Group rank ``i``'s ``t`` arrives at group rank ``i + 1`` (mod the
    group's size): the reference's ``ppermute`` with ``[(i, i+1 % n)]``.
    One ``batch_isend_irecv`` of a send and a receive a rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return t.clone()
    moved("ring_shift", group, _nbytes(t))
    me = _group_rank(group)

    def glob(i):
        return dist.get_global_rank(group, i) if group is not None else i
    staged = stage(t, group)
    send = _host(t) if staged else t.contiguous()
    recv = _pinned_like(t) if staged else torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, glob((me + 1) % n), group=group),
           dist.P2POp(dist.irecv, recv, glob((me - 1) % n), group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(t.device) if staged else recv


def _sharded_dims(mesh, placements, dims):
    from torch.distributed.tensor import Shard
    return [(i, p.dim) for i, p in enumerate(placements)
            if isinstance(p, Shard) and mesh.size(i) > 1
            and (dims is None or i in dims)]


def full_tensor(local: torch.Tensor, mesh, placements,
                dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The global tensor of a sharded one: ``local`` is this rank's shard
    under DTensor ``placements`` on ``mesh`` (``Shard(d)`` or
    ``Replicate()`` a mesh dim, split in mesh-dim order as DTensor splits
    it); each sharded mesh dim is gathered over its group, innermost first
    (only the mesh dims in ``dims``, when given).  Every shard must have
    the same shape (the rules shard only dims that divide)."""
    out = local
    for i, d in reversed(_sharded_dims(mesh, placements, dims)):
        out = torch.cat(all_gather(out, mesh.get_group(i)), dim=d)
    return out


def local_shard(full: torch.Tensor, mesh, placements,
                dims: Optional[Sequence[int]] = None) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements`` (over the mesh
    dims in ``dims``, when given) — no communication: every rank holds
    ``full``.  A tensor of its own (contiguous), never a view."""
    coord = mesh.get_coordinate()
    out = full
    for i, d in _sharded_dims(mesh, placements, dims):
        out = out.chunk(mesh.size(i), dim=d)[coord[i]]
    return out.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# autograd-aware collectives of tensor parallelism
# ---------------------------------------------------------------------------
def _sum_over(t: torch.Tensor, groups) -> torch.Tensor:
    """A new tensor: ``t`` summed over each group in turn (float32 for a
    low-precision ``t``, rounded back once)."""
    out = t.float() if t.dtype in (torch.bfloat16, torch.float16) else \
        t.clone()
    out = out.contiguous()
    for g in groups:
        all_reduce_(out, group=g)
    return out.to(t.dtype)


class _Reduce(torch.autograd.Function):
    """Forward: the sum over ``groups``.  Backward: the same sum of the
    gradient (``grad_sum``) or the gradient as it is."""

    @staticmethod
    def forward(ctx, x, groups, grad_sum):
        ctx.groups, ctx.grad_sum = groups, grad_sum
        return _sum_over(x, groups)

    @staticmethod
    def backward(ctx, g):
        return (_sum_over(g, ctx.groups) if ctx.grad_sum else g), None, None


class _Copy(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradient summed over
    ``groups``."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.groups), None


class _Gather(torch.autograd.Function):
    """Forward: every rank's ``x`` concatenated along ``dim`` in group-rank
    order.  Backward: this rank's slice of the gradient (``grad_sum``:
    of the gradient summed over the group first)."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, grad_sum):
        ctx.dim, ctx.group, ctx.rank, ctx.grad_sum = dim, group, rank, \
            grad_sum
        ctx.n = x.shape[dim]
        return torch.cat(all_gather(x.contiguous(), group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = _sum_over(g, (ctx.group,))
        g = g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous()
        return g, None, None, None, None


def _model_groups(mc) -> tuple:
    return (mc.model_group,) if mc.tp > 1 else ()


def tp_copy(x: torch.Tensor, mc) -> torch.Tensor:
    """The input of a column-parallel product (or of any computation whose
    gradient is partial on each rank of the ``model`` group): the
    identity forward, the gradient summed over the group backward."""
    groups = _model_groups(mc)
    return _Copy.apply(x, groups) if groups else x


def tp_reduce(x: torch.Tensor, mc) -> torch.Tensor:
    """The output of a row-parallel product: the partial sums added over
    the ``model`` group forward, the gradient as it is backward (what
    follows is the same on every rank)."""
    groups = _model_groups(mc)
    return _Reduce.apply(x, groups, False) if groups else x


def tp_sum(x: torch.Tensor, mc) -> torch.Tensor:
    """A sum over the ``model`` group whose result each rank uses on its
    own shard (a norm's sum of squares over a sharded dim): summed
    forward and backward."""
    groups = _model_groups(mc)
    return _Reduce.apply(x, groups, True) if groups else x


def tp_gather(x: torch.Tensor, dim: int, mc,
              grad_sum: bool = False) -> torch.Tensor:
    """Every ``model`` rank's ``x`` along ``dim``; the gradient of this
    rank's slice backward (``grad_sum``: of the gradient summed over the
    group, where the gathered tensor feeds a computation each rank does
    on its own shard)."""
    if mc.tp == 1:
        return x
    return _Gather.apply(x, dim % x.dim(), mc.model_group, mc.tp_rank,
                         grad_sum)


def tp_max(x: torch.Tensor, mc) -> torch.Tensor:
    """The elementwise maximum over the ``model`` group, outside autograd
    (a softmax's stabilizer)."""
    if mc.tp == 1:
        return x
    return all_reduce_(x.detach().clone().contiguous(),
                       op=dist.ReduceOp.MAX, group=mc.model_group)


class _GradOnce(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradient on group rank 0, zero
    on the others."""

    @staticmethod
    def forward(ctx, x, rank):
        ctx.rank = rank
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.rank == 0 else torch.zeros_like(g)), None


def tp_grad_once(x: torch.Tensor, mc) -> torch.Tensor:
    """The input of a computation replicated over the ``model`` group
    (each rank computes, and differentiates, the same thing) inside a
    region whose input gradients are partial and summed over the group
    (:func:`seq_gather`'s backward): the identity forward, the gradient
    kept by ``model`` rank 0 only, so the sum counts it once."""
    return _GradOnce.apply(x, mc.tp_rank) if mc.tp > 1 else x


def _scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:func:`reduce_scatter` in float32 for a low-precision ``x``, rounded
    once."""
    low = x.dtype in (torch.bfloat16, torch.float16)
    out = reduce_scatter(x.float() if low else x, dim, group)
    return out.to(x.dtype)


class _SeqGather(torch.autograd.Function):
    """Forward: the ``model`` ranks' slices along ``dim`` gathered.
    Backward: the gradient reduce-scattered (each rank's is partial)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(all_gather(x.contiguous(), group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.dim, ctx.group), None, None


class _SeqScatter(torch.autograd.Function):
    """Forward: the partial sums reduce-scattered along ``dim``.
    Backward: the gradient's slices gathered."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_sum(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(all_gather(g.contiguous(), ctx.group),
                         dim=ctx.dim), None, None


def seq_gather(x: torch.Tensor, mc, dim: int = 1) -> torch.Tensor:
    """Sequence parallelism: the residual stream's ``model`` shards of the
    sequence gathered before a column-parallel product (an all-gather), the
    partial gradients reduce-scattered back (a reduce-scatter)."""
    if mc.tp == 1:
        return x
    return _SeqGather.apply(x, dim % x.dim(), mc.model_group)


def seq_scatter(x: torch.Tensor, mc, dim: int = 1) -> torch.Tensor:
    """Sequence parallelism: a row-parallel product's partial sums added
    over ``model`` and split along the sequence (a reduce-scatter: each
    rank keeps its shard), the gradient's shards gathered back (an
    all-gather)."""
    if mc.tp == 1:
        return x
    return _SeqScatter.apply(x, dim % x.dim(), mc.model_group)


def data_sum(x: torch.Tensor, mc) -> torch.Tensor:
    """Weight-stationary serving: partial products of the rank's ``d``
    shard summed over the FSDP axes (float32 for a low-precision ``x``,
    rounded once).  Forward only: serving runs without autograd."""
    groups = tuple(mc.data_groups)
    return _sum_over(x, groups) if groups else x


def data_gather(x: torch.Tensor, dim: int, groups) -> torch.Tensor:
    """Every rank's ``x`` along ``dim`` over ``groups`` (mesh order; the
    innermost gathered first, as a tensor split over several mesh dims is
    laid out).  Forward only."""
    for g in reversed(tuple(groups)):
        x = torch.cat(all_gather(x.contiguous(), g), dim=dim)
    return x


def lse_merge(out: torch.Tensor, lse: torch.Tensor, groups) -> torch.Tensor:
    """Context parallelism: the attention over every rank's slot range
    from each rank's ``out`` (..., Dh) and ``lse`` (...) — a max of the
    log-sum-exps over ``groups``, then one sum of the weighted outputs and
    their weights ``exp(lse - max)``, in float32, cast once to ``out``'s
    dtype (``kernels/decode_attention.py:merge_partials`` on one rank).
    Forward only."""
    groups = tuple(groups)
    if not groups:
        return out
    m = lse.float().contiguous().clone()
    for g in groups:
        all_reduce_(m, op=dist.ReduceOp.MAX, group=g)
    w = torch.exp(lse.float() - m)
    packed = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
    packed = _sum_over(packed, groups)
    return (packed[..., :-1] / packed[..., -1:]).to(out.dtype)


def batch_sum(x: torch.Tensor, mc) -> torch.Tensor:
    """``x`` summed over the batch axes' groups, the gradient as it is
    backward: each rank's share of a statistic of the global batch (the
    MoE router's means) keeps its own rows' gradient, which the step then
    sums over the batch axes with every other gradient."""
    groups = tuple(mc.batch_groups)
    if not groups:
        return x
    if not x.requires_grad:
        return _sum_over(x, groups)
    return _Reduce.apply(x, groups, False)


__all__ = ["stage", "group_name", "moved", "all_gather", "all_reduce_",
           "reduce_scatter", "broadcast_", "ring_shift", "full_tensor",
           "local_shard", "tp_copy", "tp_reduce", "tp_sum", "tp_gather",
           "tp_max", "tp_grad_once", "seq_gather", "seq_scatter", "data_sum",
           "data_gather", "lse_merge", "batch_sum"]
