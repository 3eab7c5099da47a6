"""Parameter specs: one ``ParamSpec`` (shape + logical axis names +
initializer) per parameter, materialized by :func:`init_params`.

The one-device subset of the JAX package's ``sharding/rules.py``: the specs,
:func:`stack_spec`, :func:`init_params` and :func:`param_count`.  The logical
axes are kept so a spec reads the same in both packages; on one card nothing
maps them onto a mesh, and the reference's activation constraints
(``with_logical_constraint``) are the identity here, so the port has no
counterpart of them.  Meshes and ``ShardingRules`` shard LM parameters over
several devices and come with the multi-device slice (ROADMAP.md item
A16c); the sharded SpMV tier (``sharding/spmv.py``) reads none of them.

Spec trees are nested ``dict``s and ``list``s with ``ParamSpec`` leaves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Tuple, Union

import torch

from ..device import DeviceLike, resolve_device

Axes = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Axes
    init: str = "normal"        # normal | zeros | ones | embed
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in) for "normal"
    #: port only: the leaf is read in float32 (the reference casts its
    #: float32 master with ``.astype(float32)``), so it is stored so
    float32: bool = False

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` applied to every leaf of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """Leaves of a tree of dicts and lists, depth first in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def stack_spec(spec_tree: Any, reps: int, axis_name: Optional[str] = None) -> Any:
    """Add a leading (reps,) 'layers' dimension to every spec — the stacked
    layout of the reference's scan over layer repetitions."""
    return tree_map(lambda s: replace(s, shape=(reps,) + s.shape,
                                      axes=(axis_name,) + s.axes), spec_tree)


def _init_leaf(gen: torch.Generator, s: ParamSpec, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dtype, device=device)
    x = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                    device=device)
    if s.init != "embed":
        fan_in = s.shape[-2] if len(s.shape) >= 2 else max(s.shape[-1], 1)
        x.mul_(s.scale if s.scale is not None else 1.0 / math.sqrt(fan_in))
    return x.to(dtype)


def init_params(gen: torch.Generator, spec_tree: Any,
                dtype: Union[torch.dtype, Callable[[ParamSpec], torch.dtype]]
                = torch.float32, device: DeviceLike = None) -> Any:
    """Materialize a spec tree into tensors on ``device`` (default: the
    card), drawing every ``normal``/``embed`` leaf from ``gen`` in turn (a
    generator on that device).  The distributions per ``init`` kind are the
    reference's — ``normal``: N(0, 1) times ``scale`` or ``1/sqrt(fan_in)``,
    ``embed``: N(0, 1), ``zeros``, ``ones`` — the bits are not (another
    generator).  ``dtype`` is one dtype for every leaf or a function of the
    leaf's spec."""
    dev = resolve_device(device)
    pick = dtype if callable(dtype) else (lambda s: dtype)
    return tree_map(lambda s: _init_leaf(gen, s, pick(s), dev), spec_tree)


def param_count(spec_tree: Any) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree))


__all__ = ["ParamSpec", "stack_spec", "init_params", "param_count",
           "tree_map", "tree_leaves"]
