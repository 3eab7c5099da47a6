"""Roofline terms of one rank's step, read from a trace on fake tensors.

The port of the JAX package's ``launch/roofline.py``.  The reference
compiles a cell for placeholder TPU devices and reads XLA:
``compiled.cost_analysis()`` for FLOPs and bytes, the post-SPMD HLO text
for the collectives' operand bytes (weighted by the trip counts of the
while loops around them), ``memory_analysis()`` for the peak.  PyTorch has
no compiled program to read and this module parses no HLO; each reading
has a stand-in over ONE trace of rank 0's step on fake tensors (nothing
allocated, no card; ``launch/dryrun.py`` builds the fake world and the
arguments), chosen once here:

  * FLOPs (``traced_flops``): ``torch.utils.flop_counter.FlopCounterMode``
    — every matmul, attention and convolution op of the forward, the
    rematerialized forward and the backward, and K11 by the formula its
    custom operator registers.  The trace runs every iteration of every
    Python loop, so no trip count is needed;
  * bytes (``traced_bytes``): the bytes every op of the trace reads and
    writes, each distinct operand once per op, leaving out views and
    aliases (no data moves), allocations and collectives.  That is what an
    eager program with no fusion moves: an UPPER bound on the traffic,
    where XLA's post-fusion count was close to it;
  * collective bytes: the bytes of each collective's result on this rank,
    counted at the port's one chokepoint (``sharding/collectives.py``
    ``moved``) by op and by process group, each group mapped to its mesh
    axis.  ``CommDebugMode`` counts the process-group ops of the same trace
    as a cross-check that nothing bypasses the chokepoint;
  * peak memory: ``torch.distributed._tools.mem_tracker.MemTracker`` —
    every storage live at once, the step's arguments included, each
    rounded as the caching allocator rounds it.

  compute    = traced_flops / PEAK_FLOPS_BF16
  memory     = traced_bytes / HBM_BW
  collective = sum over (op, axis) of the bytes / the rate of the slowest
               link the axis's group spans (ranks laid out in order,
               CARDS_PER_NODE cards a node)

Each term is one device's time, as the reference's are.  The constants are
an NVIDIA H100 SXM's data sheet (no link rate between cards has been
measured for this repo: none is claimed).
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter
from dataclasses import asdict, dataclass, field, replace
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..sharding import collectives as C

# NVIDIA H100 SXM data sheet (dense, no sparsity), one card
PEAK_FLOPS_BF16 = 989e12       # FLOP/s
HBM_BW = 3.35e12               # B/s
HBM_PER_CARD = 80e9            # B
#: NVLink 4 inside a node: 900 GB/s a card both ways, 450 GB/s a direction
NVLINK_BW = 450e9              # B/s
#: cards a node (an HGX H100 board)
CARDS_PER_NODE = 8
#: between nodes: one 400 Gb/s NIC a card, 50 GB/s a direction
INTER_NODE_BW = 50e9           # B/s

#: ops that allocate or relabel and move no data
_NO_DATA = frozenset({
    "aten.empty.memory_format", "aten.empty_like.default",
    "aten.empty_strided.default", "aten.new_empty.default",
    "aten.new_empty_strided.default", "aten.lift_fresh.default",
    "aten._local_scalar_dense.default", "aten._unsafe_view.default"})
#: namespaces of the process-group ops (counted at the chokepoint)
_COMM_NAMESPACES = frozenset({"c10d", "_c10d_functional", "c10d_functional"})


def link_bw(ranks: Iterable[int]) -> float:
    """The rate of the slowest link a group of global ranks spans: NVLink
    when every rank is in one node of ``CARDS_PER_NODE``, else the
    network between nodes."""
    nodes = {r // CARDS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else INTER_NODE_BW


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _operand_bytes(tensors) -> int:
    """Bytes of distinct operands: each storage once, a tensor at most its
    elements' bytes (a slice) and at most its storage's (an expansion)."""
    seen = {}
    for t in tensors:
        n = min(t.numel() * t.element_size(), t.untyped_storage().nbytes())
        k = _storage_key(t)
        seen[k] = max(seen.get(k, 0), n)
    return sum(seen.values())


class _Traffic(TorchDispatchMode):
    """Counts every op of a trace by name, and the bytes each op that
    moves data reads and writes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":          # queries (a tensor's device)
            return out
        name = str(func)
        self.ops[name] += 1
        if (func.namespace not in _COMM_NAMESPACES and not func.is_view
                and name not in _NO_DATA):
            self.bytes += (_operand_bytes(_tensors((args, kwargs))) +
                           _operand_bytes(_tensors(out)))
        return out


def private_module(module: str):
    """Import a private PyTorch module the dry run needs, or fail naming
    it (this PyTorch may lack it)."""
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"the dry run needs PyTorch's private module {module} "
            f"(torch {torch.__version__} lacks it): {e}") from e


@dataclass
class StepTrace:
    """What one trace of a step read (one rank, per device)."""
    flops: float
    bytes: float
    #: (op, group name) -> bytes of the results on this rank
    collective_bytes: Dict[Tuple[str, str], int]
    #: (op, group name) -> calls
    collective_calls: Dict[Tuple[str, str], int]
    #: process-group op -> calls, by ``CommDebugMode``
    comm_counts: Dict[str, int]
    peak_bytes: int
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    #: op name -> calls (aten ops and custom operators such as K11)
    ops: Dict[str, int]
    seconds: float
    #: the microbatch counts traced when a train step's loop was
    #: extrapolated from them (``launch/dryrun.py:trace_cell``), else ()
    microbatches_traced: Tuple[int, ...] = ()


def trace_step(fn: Callable, args: tuple, *, memory: bool = True
               ) -> Tuple[Any, StepTrace]:
    """``fn(*args)`` once under the instruments, and what they read.
    ``args`` are fake tensors (or DTensors of them) made under the active
    ``FakeTensorMode``; ``memory=False`` skips the peak (0)."""
    from torch.utils.flop_counter import FlopCounterMode
    debug = private_module("torch.distributed.tensor.debug")
    locals_ = [_local(t) for t in _tensors(args)]
    moved_b, moved_c = dict(C.moved.bytes), dict(C.moved.calls)
    traffic = _Traffic()
    mt = (private_module("torch.distributed._tools.mem_tracker")
          .MemTracker() if memory else None)
    if mt is not None:
        mt.track_external(*locals_)
    t0 = time.perf_counter()
    with debug.CommDebugMode() as comm, mt or contextlib.nullcontext(), \
            FlopCounterMode(display=False) as flops, traffic:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    peak = 0 if mt is None else sum(
        s.get("Total", 0) for s in mt.get_tracker_snapshot("peak").values())
    out_locals = [_local(t) for t in _tensors(out)]
    arg_keys = {_storage_key(t) for t in locals_}
    return out, StepTrace(
        flops=float(flops.get_total_flops()), bytes=float(traffic.bytes),
        collective_bytes=_diff(C.moved.bytes, moved_b),
        collective_calls=_diff(C.moved.calls, moved_c),
        comm_counts={str(k): v for k, v in comm.get_comm_counts().items()},
        peak_bytes=int(peak), argument_bytes=_operand_bytes(locals_),
        output_bytes=_operand_bytes(out_locals),
        alias_bytes=_operand_bytes(t for t in out_locals
                                   if _storage_key(t) in arg_keys),
        ops=dict(traffic.ops), seconds=seconds)


def _diff(now: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def axes_of(mesh) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """group name -> (mesh axis, global ranks of rank 0's group) for each
    axis of ``mesh`` (the world's group as ``"world"``)."""
    import torch.distributed as dist
    out = {C.group_name(): ("world", tuple(range(dist.get_world_size())))}
    for i, name in enumerate(mesh.mesh_dim_names):
        g = mesh.get_group(i)
        out[g.group_name] = (name, tuple(dist.get_process_group_ranks(g)))
    return out


def on_axes(trace: StepTrace, mesh) -> Tuple[StepTrace, Dict[str, float]]:
    """The trace with each collective keyed ``(op, mesh axis)`` instead of
    ``(op, group name)``, and the link rate charged on each axis: the
    slowest its group spans (a group that is no axis of ``mesh`` keeps
    its name and is charged the slowest link)."""
    if not trace.collective_bytes:
        return trace, {}
    axes = axes_of(mesh)
    rates: Dict[str, float] = {}

    def rename(d):
        out: Dict[Tuple[str, str], int] = {}
        for (op, group), n in d.items():
            axis, ranks = axes.get(group, (group, None))
            rates[axis] = INTER_NODE_BW if ranks is None else link_bw(ranks)
            out[(op, axis)] = out.get((op, axis), 0) + n
        return out
    return replace(trace, collective_bytes=rename(trace.collective_bytes),
                   collective_calls=rename(trace.collective_calls)), rates


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    traced_flops: float          # PER-DEVICE FLOPs: FlopCounterMode
    traced_bytes: float          # PER-DEVICE bytes: eager ops, no fusion
                                 # (upper bound)
    collective_bytes: float      # per-device result bytes of collectives
    model_flops: float           # 6*N*D (active N for MoE), GLOBAL
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0    # model_flops / (chips * traced_flops)
    bytes_per_device: float = 0.0
    peak_memory_gb: float = 0.0
    collectives: Dict[str, int] = field(default_factory=dict)   # by op
    #: op -> mesh axis -> bytes
    collectives_by_axis: Dict[str, Dict[str, int]] = field(
        default_factory=dict)
    #: mesh axis -> link rate charged (B/s)
    link_bw: Dict[str, float] = field(default_factory=dict)

    def finalize(self) -> "Roofline":
        self.t_compute = self.traced_flops / PEAK_FLOPS_BF16
        self.t_memory = self.traced_bytes / HBM_BW
        if self.collectives_by_axis:
            self.t_collective = sum(
                b / self.link_bw.get(axis, INTER_NODE_BW)
                for row in self.collectives_by_axis.values()
                for axis, b in row.items())
        else:       # no split by axis: all of it over the slowest link
            self.t_collective = self.collective_bytes / INTER_NODE_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        self.useful_ratio = (
            self.model_flops / (self.chips * self.traced_flops)
            if self.traced_flops else 0.0)
        return self

    def to_dict(self) -> dict:
        return asdict(self)


def from_trace(trace: StepTrace, *, arch: str, shape: str, mesh_name: str,
               chips: int, model_flops: float,
               link_rates: Optional[Dict[str, float]] = None) -> Roofline:
    """The roofline of one traced step whose collectives are keyed by mesh
    axis (:func:`on_axes`, which also gives ``link_rates``)."""
    table: Dict[str, Dict[str, int]] = {}
    for (op, axis), b in sorted(trace.collective_bytes.items()):
        table.setdefault(op, {})[axis] = b
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        traced_flops=trace.flops, traced_bytes=trace.bytes,
        collective_bytes=float(sum(trace.collective_bytes.values())),
        model_flops=model_flops, bytes_per_device=trace.bytes,
        peak_memory_gb=trace.peak_bytes / 1e9,
        collectives={op: sum(row.values()) for op, row in table.items()},
        collectives_by_axis=table, link_bw=dict(link_rates or {})).finalize()


__all__ = ["Roofline", "StepTrace", "trace_step", "from_trace", "on_axes",
           "axes_of", "link_bw", "PEAK_FLOPS_BF16", "HBM_BW",
           "HBM_PER_CARD", "NVLINK_BW", "INTER_NODE_BW", "CARDS_PER_NODE"]
