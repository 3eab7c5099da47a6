"""Logical-axis parameter specs and mesh-shape-agnostic sharding rules.

The port of the JAX package's ``sharding/rules.py``.  Every parameter is
declared once as a ``ParamSpec`` (shape + logical axis names +
initializer); :func:`init_params` materializes the tree, :func:`axes_tree`
yields the parallel tree of logical axes, and :class:`ShardingRules` maps
logical axes onto whatever mesh is in scope (a
:class:`~torch.distributed.device_mesh.DeviceMesh`, see
``launch/mesh.py``), so the same model config places on one rank, a 2x2
world or a 512-rank one.

A spec is the reference's ``PartitionSpec`` as a tuple, one entry a tensor
dim: ``None`` (replicated), a mesh dim name, or a tuple of names (one
tensor dim split over several mesh dims).  :class:`NamedSharding` pairs it
with its mesh and gives the DTensor ``placements``: ``Shard(d)`` on each
mesh dim that tensor dim ``d`` maps to, ``Replicate()`` elsewhere.  DTensor
splits a dim sharded over several mesh dims in the mesh's dim order; the
reference splits it in the tuple's order, so ``RULES_2POD``'s
``("data", "pod")`` puts the same pieces on other ranks (one global tensor
either way).

The default placement (the reference's production posture):
  * ``batch``   -> ("pod", "data")   — data parallelism
  * ``embed``   -> "data"            — FSDP/ZeRO-3: weights and optimizer
                                       moments sharded over the data axis
  * ``heads`` / ``kv_heads`` / ``ffn`` / ``vocab`` / ``experts`` -> "model"
  * ``seq_kv``  -> "data"            — context parallelism (long decode)
  * anything unknown                 -> replicated

Spec trees are nested ``dict``s and ``list``s with ``ParamSpec`` leaves.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Optional, Tuple, Union

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
    """Leaves of a tree of dicts and lists, depth first; a dict's in its
    insertion order (``jax.tree`` sorts keys: pair two trees by position
    only when both were built in one order, and pair with ``strict=True``)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_paths(tree: Any, path: tuple = ()) -> list:
    """The path (dict keys, list indices) of each leaf, in
    :func:`tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in tree_paths(v, path + (k,))]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in tree_paths(v, path + (i,))]
    return [path]


def paired_leaves(*trees: Any) -> list:
    """The leaves of each tree, for pairing by position: raises
    ``ValueError`` unless every tree has the first one's paths in its order
    (a dict whose keys were inserted in another order included)."""
    want = tree_paths(trees[0])
    for i, t in enumerate(trees[1:], 1):
        got = tree_paths(t)
        if got != want:
            bad = next((a, b) for a, b in zip(got + [None], want + [None])
                       if a != b)
            raise ValueError(f"tree {i} does not pair with tree 0 by "
                             f"position: leaf {bad[0]} against {bad[1]}")
    return [tree_leaves(t) for t in trees]


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


def axes_tree(spec_tree: Any) -> Any:
    return tree_map(lambda s: s.axes, spec_tree)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------
MeshAxes = Union[None, str, Tuple[str, ...]]
#: the reference's ``PartitionSpec``: one entry a tensor dim
Spec = Tuple[MeshAxes, ...]


def _mesh_axes(mesh: Any) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """(dim names, {name: size}) of a ``DeviceMesh``, or of any object
    with the reference mesh's ``axis_names`` and ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), dict(zip(names, mesh.shape))
    return tuple(mesh.axis_names), dict(mesh.shape)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        """DTensor placements: ``Shard(d)`` on each mesh dim tensor dim
        ``d`` maps to, ``Replicate()`` on the others."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in _mesh_axes(self.mesh)[0]:
            dims = [d for d, e in enumerate(self.spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


@dataclass(frozen=True)
class ShardingRules:
    """Map logical axis name -> mesh axis (or tuple of mesh axes)."""
    rules: Dict[str, MeshAxes]

    def spec_for(self, axes: Axes, mesh: Any,
                 shape: Optional[Tuple[int, ...]] = None) -> Spec:
        """The reference's rule: mesh axes absent from this mesh (elastic)
        or used by an earlier dim are dropped; with ``shape``, an axis that
        does not divide its dim is dropped (a tuple tries its prefixes)."""
        names, msize = _mesh_axes(mesh)
        entries = []
        used: set = set()
        for i, ax in enumerate(axes):
            m = self.rules.get(ax) if ax is not None else None
            if isinstance(m, tuple):
                m = tuple(a for a in m if a in names and a not in used)
                m = m if m else None
            elif isinstance(m, str):
                m = m if (m in names and m not in used) else None
            if m is not None and shape is not None:
                def parts(mm):
                    return (math.prod(msize[a] for a in mm)
                            if isinstance(mm, tuple) else msize[mm])
                if shape[i] % parts(m) != 0:
                    if isinstance(m, tuple):
                        while m and shape[i] % parts(m) != 0:
                            m = m[:-1]
                        m = m if m else None
                    else:
                        m = None
            if m is not None:
                used.update(m if isinstance(m, tuple) else (m,))
            # a 1-tuple reads as its axis (``PartitionSpec`` spells it so)
            entries.append(m[0] if isinstance(m, tuple) and len(m) == 1
                           else m)
        return tuple(entries)

    def sharding_for(self, axes: Axes, mesh: Any,
                     shape: Optional[Tuple[int, ...]] = None
                     ) -> NamedSharding:
        return NamedSharding(mesh, self.spec_for(axes, mesh, shape))


RULES_1POD = ShardingRules(rules={
    "batch": ("pod", "data"),
    "embed": "data",            # FSDP axis for weights
    "embed_act": None,          # activations keep embed replicated
    "heads": "model",
    "kv_heads": "model",
    "q_dim": "model",
    "ffn": "model",
    "experts": "model",
    "vocab": "model",
    "embed_tp": "model",        # embed-table d-dim TP (local token gather)
    "seq": None,
    "seq_sp": "model",          # sequence parallelism on the residual stream
    "seq_kv": "data",           # context parallelism (long-context decode)
    "layers": None,
    "conv": None,
    "state": None,
    "inner": "model",           # SSM/xLSTM expanded inner dim
})

#: multi-pod: FSDP additionally spans the pod axis
RULES_2POD = ShardingRules(rules={**RULES_1POD.rules,
                                  "embed": ("data", "pod")})

#: serving, weight-stationary: activations replicate over batch and shard
#: their d dim over the weights' FSDP axis
RULES_SERVE = ShardingRules(rules={**RULES_1POD.rules,
                                   "batch": None,
                                   "embed_act": "data"})

#: ZeRO-1: parameters replicated, optimizer moments sharded over ``data``
RULES_ZERO1 = ShardingRules(rules={**RULES_1POD.rules, "embed": None})


def rules_for_mesh(mesh: Any) -> ShardingRules:
    return RULES_2POD if "pod" in _mesh_axes(mesh)[0] else RULES_1POD


def logical_to_sharding(spec_tree: Any, mesh: Any,
                        rules: ShardingRules = RULES_1POD) -> Any:
    """ParamSpec tree -> :class:`NamedSharding` tree (shape-aware: every
    sharded dim divides evenly)."""
    return tree_map(lambda s: rules.sharding_for(s.axes, mesh, s.shape),
                    spec_tree)


_ACTIVE_RULES: list = []


class use_rules:
    """Context manager: the rules :func:`with_logical_constraint` applies
    inside (e.g. ``RULES_SERVE`` for weight-stationary decode)."""

    def __init__(self, rules: ShardingRules):
        self.rules = rules

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE_RULES.pop()
        return False


def active_rules() -> ShardingRules:
    return _ACTIVE_RULES[-1] if _ACTIVE_RULES else RULES_1POD


def with_logical_constraint(x: torch.Tensor, axes: Axes, mesh: Any = None,
                            rules: Optional[ShardingRules] = None
                            ) -> torch.Tensor:
    """An activation placed by its logical axes: a DTensor is
    redistributed to the rules' sharding (shape-aware; rules default to the
    active context, else ``RULES_1POD``); a plain tensor is returned as it
    is (the reference's no-op outside a mesh)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = mesh if mesh is not None else x.device_mesh
    sh = (rules or active_rules()).sharding_for(axes, mesh, tuple(x.shape))
    return x.redistribute(mesh, sh.placements)


__all__ = ["ParamSpec", "stack_spec", "init_params", "param_count",
           "tree_map", "tree_leaves", "tree_paths", "paired_leaves",
           "axes_tree", "Spec", "NamedSharding",
           "ShardingRules", "RULES_1POD", "RULES_2POD", "RULES_SERVE",
           "RULES_ZERO1", "rules_for_mesh", "logical_to_sharding",
           "use_rules", "active_rules", "with_logical_constraint"]
