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
reads it before and after.  The
host copies are pinned (a copy out of the card runs at 26 GB/s into
pinned memory against 7 GB/s into pageable memory on the H100's host:
``experiments/torch_gloo_staging.py``).

Each function is a collective over ``group`` (default: the world): every
rank of the group calls it in the same order.
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


def _host(t: torch.Tensor) -> torch.Tensor:
    stage.bytes += t.numel() * t.element_size()
    return _pinned_like(t).copy_(t.detach())


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on each), in group-rank
    order, on ``t``'s device."""
    n = dist.get_world_size(group)
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
    if stage(t, group):
        h = _host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from global rank ``src`` on every rank, in place."""
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


__all__ = ["stage", "all_gather", "all_reduce_",
           "broadcast_", "ring_shift", "full_tensor", "local_shard"]
