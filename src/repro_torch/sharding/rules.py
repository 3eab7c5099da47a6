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
from dataclasses import dataclass, field, replace
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


# ---------------------------------------------------------------------------
# the mesh a step runs on, as its blocks see it
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MeshContext:
    """What a block needs to know of the mesh its step runs on.

    ``model_group`` is the process group of this rank's ``model`` axis
    (``tp`` ranks, this one ``tp_rank`` among them; ``tp == 1``: no tensor
    parallelism, the default outside a mesh step).  Each parameter a block
    reads is its shard as ``rules`` place it on ``mesh`` (its ``model``
    shard, and under ``ws`` its FSDP shard too); a block asks
    :meth:`shard` which slice that is, so the rules stay the one owner of
    the decision.  ``batch_groups`` are the groups of the batch axes of
    size above one (the MoE router's statistics are the global batch's);
    ``real_rows`` (B_local,) marks the rank's real rows where a microbatch
    was padded to split over the batch shards (``None``: every row is
    real).

    ``ws``: weight-stationary serving (the reference's ``RULES_SERVE``):
    no parameter is gathered, the activations hold the global batch and
    the residual stream is this rank's columns of ``d`` (:meth:`embed_cols`)
    — each product with a weight's ``embed`` dim on its input side is a
    partial sum over ``data_groups`` (the groups of the FSDP axes of size
    above one, mesh order), each with it on its output side gives the
    rank's columns.  ``spans`` tells a block which part of a cache leaf
    the rank holds, by the leaf's ``id``: ``(dim, start, stop, total,
    groups)`` — dim 0, its batch rows (under ``ws``), or dim 1, its range
    of slots (context parallelism), split over ``groups`` — or ``None``,
    for every leaf of the cache view a serving step made from the caches'
    placements (``launch/steps.py:_cache_ops``); ``None`` outside such a
    step.

    ``seq_split``: the blocks inside receive the rank's shard of the
    sequence (set by ``models/model.py`` around its layers where
    :meth:`seq_parallel` says)."""
    model_group: Any = None
    tp: int = 1
    tp_rank: int = 0
    batch_groups: Tuple[Any, ...] = ()
    real_rows: Optional[torch.Tensor] = None
    mesh: Any = None
    rules: Optional[ShardingRules] = None
    ws: bool = False
    data_groups: Tuple[Any, ...] = ()
    spans: Optional[Dict[int, Optional[tuple]]] = field(
        default=None, compare=False, hash=False)
    seq_split: bool = False

    def _axes(self, spec: ParamSpec, dim: int) -> Tuple[str, ...]:
        """The mesh axes the rules split dim ``dim`` of ``spec`` over that
        this rank's local tensor is split over (``model``, and the FSDP
        axes under ``ws``), of size above one, in mesh order."""
        if self.mesh is None:
            return ()
        m = self.rules.spec_for(spec.axes, self.mesh, spec.shape)[dim]
        m = () if m is None else (m if isinstance(m, tuple) else (m,))
        names, size = _mesh_axes(self.mesh)
        return tuple(a for a in names if a in m and size[a] > 1 and
                     (a == "model" or self.ws))

    def shard(self, spec: ParamSpec, dim: int) -> Tuple[int, int]:
        """``(start, stop)`` of this rank's slice of dim ``dim`` of a
        parameter declared by ``spec``: its equal slice where the rules
        split that dim over ``model`` (or, under ``ws``, the FSDP axes;
        a dim split over several mesh dims is split in the mesh's order,
        as DTensor lays it out), else the whole dim."""
        n = spec.shape[dim]
        if self.tp == 1 and not self.ws:
            return 0, n
        axes = self._axes(spec, dim)
        if not axes:
            return 0, n
        names, size = _mesh_axes(self.mesh)
        coord = dict(zip(names, self.mesh.get_coordinate()))
        idx, parts = 0, 1
        for a in axes:
            idx, parts = idx * size[a] + coord[a], parts * size[a]
        k = n // parts
        return idx * k, (idx + 1) * k

    def splits(self, spec: ParamSpec, dim: int) -> bool:
        """Whether the rules split dim ``dim`` of ``spec`` over ``model``."""
        if self.tp == 1:
            return False
        return "model" in self._axes(spec, dim)

    def split(self, n: int) -> Tuple[int, int]:
        """``(start, stop)`` of this rank's share of ``n`` items (heads)
        a block splits over ``model``: its ``n / tp`` when ``tp`` divides
        ``n``, else all of them (the computation is replicated)."""
        if n % self.tp:
            return 0, n
        k = n // self.tp
        return self.tp_rank * k, (self.tp_rank + 1) * k

    def embed_cols(self, d: int) -> Tuple[int, int]:
        """``(start, stop)``: the columns of ``d`` the residual stream
        holds on this rank (its FSDP shard under ``ws``, else all)."""
        return self.shard(ParamSpec((d,), ("embed",)), 0) if self.ws \
            else (0, d)

    def span(self, t: torch.Tensor) -> Optional[tuple]:
        """``(dim, start, stop, total, groups)`` of a cache leaf the rank
        holds part of (see the class docstring), or ``None``: the leaf
        is whole along its batch and slots (or no serving step placed the
        caches).  Raises ``LookupError`` for a tensor that is not a leaf
        of the step's cache view (a leaf cloned or rebuilt on its way to
        the block would otherwise be read as whole)."""
        if self.spans is None:
            return None
        if id(t) not in self.spans:
            raise LookupError(
                f"a cache leaf of shape {tuple(t.shape)} that is not one "
                "the serving step placed: its batch rows or slot range "
                "are unknown (pass the step's cache view to the blocks "
                "as it is)")
        return self.spans[id(t)]

    def seq_parallel(self, use_seq_sp: bool, S: int) -> bool:
        """Whether a sequence of ``S`` runs sequence-parallel: the config
        asks for it (``use_seq_sp``) and the rules map ``seq_sp`` to
        ``model`` for a dim of ``S`` (``spec_for`` drops an axis that does
        not divide it, so a decode step's ``S = 1`` never shards)."""
        if not (use_seq_sp and self.tp > 1):
            return False
        m = self.rules.spec_for(("seq_sp",), self.mesh, (S,))[0]
        return m == "model"


_NO_MESH = MeshContext()
_ACTIVE_MESH: list = []


class use_mesh:
    """Context manager: the :class:`MeshContext` the blocks read inside
    (:func:`mesh_context`); the mesh steps of ``launch/steps.py`` enter
    it around the model's code."""

    def __init__(self, context: MeshContext):
        self.context = context

    def __enter__(self):
        _ACTIVE_MESH.append(self.context)
        return self.context

    def __exit__(self, *exc):
        _ACTIVE_MESH.pop()
        return False


def mesh_context() -> MeshContext:
    """The active :class:`MeshContext`; outside a mesh step one that
    reads as ``tp = 1``, no batch groups, every row real."""
    return _ACTIVE_MESH[-1] if _ACTIVE_MESH else _NO_MESH


__all__ = ["ParamSpec", "stack_spec", "init_params", "param_count",
           "tree_map", "tree_leaves", "tree_paths", "paired_leaves",
           "axes_tree", "Spec", "NamedSharding",
           "ShardingRules", "RULES_1POD", "RULES_2POD", "RULES_SERVE",
           "RULES_ZERO1", "rules_for_mesh", "logical_to_sharding",
           "use_rules", "active_rules", "with_logical_constraint",
           "MeshContext", "use_mesh", "mesh_context"]
