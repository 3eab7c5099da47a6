"""GPipe-style pipeline parallelism over a ``pipe`` mesh dim.

The port of the JAX package's ``pipeline/gpipe.py``.  Each rank owns one
stage's parameters.  The schedule runs ``M + P - 1`` ticks; on each tick
every rank applies its stage to the microbatch it holds and shifts
activations one stage forward (a ring ``batch_isend_irecv``, the
reference's ``ppermute``) — the classic fill/drain bubble of ``P - 1``
idle slots.  The last stage's outputs reach every rank by one
``all_reduce`` (the reference's masked ``psum``).  Forward only, as in the
reference.  :func:`pipeline_forward` is a collective over the ``pipe``
group.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..sharding import collectives as C
from ..sharding.rules import tree_leaves, tree_map


def _stage_slice(stage_params: Any, stage: int) -> Any:
    """One stage's parameters: a DTensor leaf's local shard (its leading
    stage dim sharded over the pipe axis), a whole tensor's row."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda a: a.to_local()[0] if isinstance(a, DTensor)
                    else a[stage], stage_params)


def pipeline_forward(stage_params: Any, x_micro: torch.Tensor, *,
                     stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     mesh, axis: str = "pipe") -> torch.Tensor:
    """stage_params: a tree with leading dim = n_stages (whole tensors, or
    DTensors sharded over ``axis``); x_micro: ``(M, mb, ...)``
    microbatches, the same on every rank.  Returns the ``(M, mb, ...)``
    outputs of the final stage on every rank."""
    dim = list(mesh.mesh_dim_names).index(axis)
    n_stages = mesh.size(dim)
    group = mesh.get_group(dim)
    stage = mesh.get_local_rank(dim)
    params = _stage_slice(stage_params, stage)
    M = x_micro.shape[0]
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    with torch.no_grad():
        for t in range(M + n_stages - 1):
            # stage 0 ingests microbatch t (if any remain)
            inp = x_micro[t] if (stage == 0 and t < M) else buf
            y = stage_fn(params, inp)
            # the last stage records its finished microbatch t - (P - 1)
            done = t - (n_stages - 1)
            if stage == n_stages - 1 and done >= 0:
                outs[done] = y
            buf = C.ring_shift(y, group)
        # deliver the final outputs from the last stage to everyone
        return C.all_reduce_(outs, group=group)


def reference_forward(stage_params: Any, x_micro: torch.Tensor, *,
                      stage_fn: Callable[[Any, torch.Tensor], torch.Tensor]
                      ) -> torch.Tensor:
    """Sequential oracle: apply all stages to every microbatch."""
    n_stages = tree_leaves(stage_params)[0].shape[0]
    out = []
    for x in x_micro:
        for s in range(n_stages):
            x = stage_fn(tree_map(lambda a: a[s], stage_params), x)
        out.append(x)
    return torch.stack(out)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """GPipe bubble overhead: (P-1)/(M+P-1)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


__all__ = ["pipeline_forward", "reference_forward", "bubble_fraction"]
