"""Gradient compression for bandwidth-constrained links: an int8
quantized all-reduce with error feedback.

The port of the JAX package's ``optim/compress.py``.  Each worker
quantizes its local gradient to int8 against a scale shared by an
``all_reduce(MAX)`` of the amax, all-reduces the codes in int32,
dequantizes and averages.  Error feedback accumulates the quantization
residual locally and re-injects it next step.  Wire cost: 1 byte an
element instead of 4.

The reference runs inside ``shard_map`` over a data axis, its trees
carrying a leading worker dim (one row a worker).  The port is SPMD: each
rank passes its own tree — the reference's row for that worker — and gets
back its mean and its error state; :func:`compressed_psum_mean` and the
function :func:`make_compressed_allreduce` returns are collectives over the
group.  ``torch.round``, like ``jnp.round``, rounds half to even, so the
codes are the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist

from ..sharding import collectives as C
from ..sharding.rules import tree_leaves, tree_map


def init_error_state(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def compressed_psum_mean(local_grads: Any, error: Any, group=None
                         ) -> Tuple[Any, Any]:
    """``(mean_grads, new_error)`` of this rank's gradient tree and error
    state over ``group`` (default: the world).  A collective."""
    n = dist.get_world_size(group)
    means, errs = [], []
    for g, e in zip(tree_leaves(local_grads), tree_leaves(error),
                    strict=True):
        g32 = g.to(torch.float32) + e
        amax = C.all_reduce_(g32.abs().max(), op=dist.ReduceOp.MAX,
                             group=group)
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        q = _quantize(g32, scale)
        errs.append(g32 - q.to(torch.float32) * scale)   # error feedback
        total = C.all_reduce_(q.to(torch.int32), group=group)
        means.append((total.to(torch.float32) * scale / n).to(g.dtype))
    it_m, it_e = iter(means), iter(errs)
    return (tree_map(lambda _: next(it_m), local_grads),
            tree_map(lambda _: next(it_e), local_grads))


def make_compressed_allreduce(mesh, axis: str = "data") -> Callable:
    """``(grads, error) -> (mean grads, error)`` over the ``axis`` dim of
    ``mesh``: each rank's own trees (the reference's per-worker rows)."""
    group = mesh.get_group(axis)

    def fn(grads: Any, error: Any) -> Tuple[Any, Any]:
        return compressed_psum_mean(grads, error, group)
    return fn


__all__ = ["init_error_state", "compressed_psum_mean",
           "make_compressed_allreduce"]
