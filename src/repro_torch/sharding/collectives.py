"""The collectives of the port's multi-device tier, on any backend.

Thin wrappers over ``torch.distributed`` for the five collectives the
SPMD code uses — ``all_gather``, ``all_reduce``, ``broadcast``, a ring
shift (the reference's ``ppermute``) and the gather of a sharded tensor —
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
:func:`tp_sum`, :func:`tp_gather`, :func:`tp_max`, :func:`batch_sum`) are
autograd functions over the groups of a step's
:class:`~repro_torch.sharding.rules.MeshContext`, built on the ones
above, so every one of them is counted in ``moved`` as well.  A group of
one rank (``tp == 1``, no batch axis) makes each of them the identity:
nothing is called and nothing counted.  Low-precision tensors are reduced
in float32 and rounded once.
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
    me = dist.get_group_rank(group, dist.get_rank()) if group is not None \
        else dist.get_rank()

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
           "broadcast_", "ring_shift", "full_tensor", "local_shard",
           "tp_copy", "tp_reduce", "tp_sum", "tp_gather", "tp_max",
           "batch_sum"]
