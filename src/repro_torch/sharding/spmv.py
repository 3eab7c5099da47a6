"""Sharded SpMV/SpMM: per-shard ExecutionPlans, served shard by shard.

The sharded tier of the JAX package, on one CUDA card (or the CPU).  A CSR
is cut into contiguous slabs along one axis by the partition strategies
lifted to shard-count granularity (``partition_for_devices``), the
:class:`~repro_torch.core.plan.Planner` runs independently per slab so
every shard gets its own format + launch geometry, and the resulting
:class:`ShardedPlannedMatrix` serves ``P @ x`` / ``P @ X``.

Reassembly:

  * ``axis="row"`` — every shard multiplies its row slab by the whole x,
    and the outputs reassemble by concatenation alone (the partitioner
    never sorts rows, so slabs stay contiguous in the original row order).
  * ``axis="col"`` — every shard multiplies its column slab by its window
    of x (the gather) into a full-length partial y, and the partials are
    summed in shard order.

Execution modes:

  * ``"shard_map"`` — one program across ranks, the reference's SPMD
    envelope.  The reference is one process driving every device; the
    port is one process a rank of a ``torch.distributed`` world, so a
    ``shard_map`` bind and every product are **collectives**: every rank
    of the world calls them in the same order with the same arguments (and
    the same matrix).  Slabs are padded to one ``(rows_pad, nnz_pad)``
    envelope (pad entries ``val=0``/``col=0`` past ``IRP[-1]``, so the
    kernels' row loops never read them; ``indptr`` extends flat) and each
    rank of a 1-D mesh named ``plan.mesh_axis`` holds its own slab on its
    own device and runs the kernel tier's CSR op on it (K2 ``csr_spmv``,
    K5 ``csr_spmm``; their plain versions on the CPU).  Row axis: the
    padded outputs are gathered across the mesh and the valid head of each
    slab concatenated; column axis: x is padded by the widest slab, each
    rank slices its window at its offset (the gather) into a full-length
    partial, and one ``all_reduce`` sums the partials.  Every rank returns
    the whole ``y`` (the reference returns one global array): a rank of
    the world outside the mesh takes it by one broadcast.  Per-shard
    format choices are recorded in the plan but not applied here, and no
    per-shard guard ladders are built (as in the reference).
  * ``"dispatch"`` — the format-faithful path, in one process.  Each shard
    binds its own :class:`~repro_torch.core.plan.PlannedMatrix` (own
    format, tier, geometry, so its own kernel), placed round robin over
    ``devices`` (default: every CUDA card for a CUDA device, else the one
    device).  Partials move to the first device before they are joined.
    Each shard is served through its own guard ladder (tuned → reference
    CSR on the shard's slab).  Launches stay on the current stream.
  * ``"single"`` — a 1-shard plan: that shard's ``PlannedMatrix``.  Asked
    for with more shards it raises :class:`~repro_torch.core.plan.PlanError`
    (the reference serves shard 0's slab alone then: a product of the
    wrong shape).
  * ``"auto"`` — ``"single"`` for one shard; ``"shard_map"`` when a world
    is initialized and the mesh (``mesh=``, else the world) has a rank a
    shard (the reference's "a device a shard"); else ``"dispatch"``.  One
    process is one rank, so outside a world ``auto`` is ``dispatch``.

With fewer ranks than shards an explicit ``shard_map`` raises the
reference's :class:`~repro_torch.core.plan.PlanError`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import obs as _obs
from ..core import dispatch as _dispatch
from ..core.formats import CSR, memory_bytes
from ..core.plan import (PlanError, Planner, ShardedPlan, shard_boundaries,
                         slice_shard)
from ..device import DeviceLike, resolve_device, result_dtype
from ..launch.mesh import rank_device, world_size
from . import collectives as C

MODES = ("auto", "shard_map", "dispatch", "single")


# ---------------------------------------------------------------------------
# partitioning the matrix
# ---------------------------------------------------------------------------
def _slice_for(csr: CSR, boundaries: np.ndarray, axis: str) -> List[CSR]:
    """The slabs of ``csr`` between ``boundaries``, cut from one host copy
    (host CSRs)."""
    from ..partition.hybrid import _on_host
    host = _on_host(csr)
    return [slice_shard(host, int(s), int(e), axis=axis)
            for s, e in zip(boundaries[:-1], boundaries[1:])]


def shard_csr(csr: CSR, n_shards: int, axis: str = "row",
              strategy: str = "balanced_nnz",
              **strategy_kw) -> Tuple[np.ndarray, List[CSR]]:
    """Cut ``csr`` into ``n_shards`` slabs along ``axis``; returns
    ``(boundaries, [slab CSRs])`` (host CSRs).  Row slabs keep the full
    column space; column slabs keep the full row space with columns
    rebased to 0."""
    b = shard_boundaries(csr, n_shards, axis=axis, strategy=strategy,
                         **strategy_kw)
    return b, _slice_for(csr, b, axis)


def _imbalance(subs: Sequence[CSR]) -> float:
    nnzs = np.array([m.nnz for m in subs], dtype=np.float64)
    return float(nnzs.max() / max(nnzs.mean(), 1.0))


def _devices(device: DeviceLike,
             devices: Optional[Sequence[Any]]) -> List[torch.device]:
    """The devices shards are placed on: ``devices`` as given, else every
    CUDA card when ``device`` resolves to one, else that device alone."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise PlanError("devices must name at least one device")
        return devs
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


# ---------------------------------------------------------------------------
# the SPMD envelope (shard_map mode)
# ---------------------------------------------------------------------------
def _envelope(subs: Sequence[CSR]) -> Tuple[int, int, int]:
    """(rows_pad, nnz_pad, width_pad): the largest slab's extents."""
    return (max(m.n_rows for m in subs), max(m.nnz_pad for m in subs),
            max(m.n_cols for m in subs))


def _pad_slab(m: CSR, rows_pad: int, nnz_pad: int):
    """One slab padded to the envelope, as host tensors ``(data, cols,
    indptr)``: pad entries are ``val=0``/``col=0`` and ``indptr`` extends
    flat, so padded rows produce zeros."""
    d = torch.zeros(nnz_pad, dtype=m.data.dtype)
    c = torch.zeros(nnz_pad, dtype=torch.int32)
    d[:m.nnz_pad] = m.data.cpu()
    c[:m.nnz_pad] = m.cols.cpu()
    ip = m.indptr.cpu().to(torch.int32)
    ipp = torch.full((rows_pad + 1,), int(ip[-1]), dtype=torch.int32)
    ipp[:ip.shape[0]] = ip
    return d, c, ipp


def _stack_shards(subs: Sequence[CSR]):
    """The reference's stacked envelope: every slab padded to one
    ``(rows_pad, nnz_pad)`` shape and stacked with a leading shard axis —
    ``(data, cols, indptr, rows_pad, nnz_pad, width_pad)``, the arrays
    numpy.  A rank of the ``shard_map`` mode holds one row of each."""
    rows_pad, nnz_pad, width_pad = _envelope(subs)
    padded = [_pad_slab(m, rows_pad, nnz_pad) for m in subs]
    return tuple(np.stack([p[k].numpy() for p in padded])
                 for k in range(3)) + (rows_pad, nnz_pad, width_pad)


def _mesh_for(n_shards: int, axis_name: str, device_type: str,
              mesh: Optional[Any] = None):
    """``(1-D mesh of exactly n_shards ranks named axis_name, the ranks
    that compute)`` — the caller's mesh (or its ``axis_name`` dim) when it
    fits, else the first ``n_shards`` ranks of the caller's mesh or of the
    world.  A collective (it makes process groups)."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh is not None:
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch DeviceMesh; got "
                            f"{type(mesh).__name__}")
        ranks = mesh.mesh.flatten().tolist()
        names = tuple(mesh.mesh_dim_names or ())
        if axis_name in names and \
                mesh.size(names.index(axis_name)) == n_shards:
            return (mesh if mesh.ndim == 1 else mesh[axis_name]), ranks
    else:
        ranks = list(range(world_size()))
    if len(ranks) < n_shards:
        raise PlanError(
            f"shard_map mode needs >= {n_shards} devices for {n_shards} "
            f"shards; have {len(ranks)} (one rank a device: start a world "
            f"of {n_shards} ranks, or use mode='dispatch')")
    return (DeviceMesh(device_type, ranks[:n_shards],
                       mesh_dim_names=(axis_name,)), ranks[:n_shards])


class _Spmd:
    """One rank's part of a ``shard_map`` bind: its mesh and group, its
    padded slab on its device (``None`` on a rank outside the mesh), and
    the envelope every rank agrees on."""

    def __init__(self, subs: Sequence[CSR], boundaries: np.ndarray,
                 axis: str, axis_name: str, device: torch.device,
                 mesh: Optional[Any]):
        from ..kernels import ops
        self.mesh, self.members = _mesh_for(len(subs), axis_name,
                                            device.type, mesh)
        self.device = device
        self.rows_pad, self.nnz_pad, self.width_pad = _envelope(subs)
        self.rows_per = [int(m.n_rows) for m in subs]
        self.data_dtype = subs[0].data.dtype
        coord = self.mesh.get_coordinate()
        self.shard = None if coord is None else int(coord[0])
        self.group = None if coord is None else self.mesh.get_group()
        self.local: Optional[CSR] = None
        self.offset = 0
        if self.shard is not None:
            m = subs[self.shard]
            d, c, ip = _pad_slab(m, self.rows_pad, self.nnz_pad)
            n_cols = m.n_cols if axis == "row" else self.width_pad
            self.local = ops.prepare(CSR(
                data=d.to(device), cols=c.to(device), indptr=ip.to(device),
                shape=(self.rows_pad, n_cols), nnz=m.nnz))
            self.offset = int(boundaries[self.shard])
        itemsize = torch.empty((), dtype=self.data_dtype).element_size()
        #: the bytes of the whole stacked envelope (the reference's figure)
        self.nbytes = len(subs) * (self.nnz_pad * (itemsize + 4)
                                   + (self.rows_pad + 1) * 4)
        #: whether the world has ranks outside the computing ones
        self.outsiders = world_size() > len(self.members)


# ---------------------------------------------------------------------------
# the bound sharded operator
# ---------------------------------------------------------------------------
class ShardedPlannedMatrix:
    """A :class:`~repro_torch.core.plan.ShardedPlan` applied to a concrete
    matrix.  ``y = P @ x`` dispatches on x's rank exactly like
    :class:`~repro_torch.core.plan.PlannedMatrix` — 1-D serves SpMV,
    ``(n_cols, B)`` serves SpMM — shard by shard per the resolved mode
    (see the module docstring).  The result lies on the first device."""

    def __init__(self, plan: ShardedPlan, source: CSR, mode: str,
                 boundaries: np.ndarray, fingerprint_matched: bool,
                 planned: Optional[List[Any]],
                 devices: Sequence[torch.device],
                 shard_nnz: Optional[List[int]] = None,
                 spmd: Optional[_Spmd] = None):
        self.plan = plan
        self.source = source
        self.mode = mode
        self.boundaries = np.asarray(boundaries, dtype=np.int64)
        self.fingerprint_matched = fingerprint_matched
        self.planned = planned          # dispatch/single: per shard
        self.spmd = spmd                # shard_map: this rank's part
        self.shard_nnz = list(shard_nnz or [])
        self._devices = list(devices)
        self.shard_guards: List[Dict[str, Any]] = []
        if mode == "dispatch":
            self.shard_guards = self._build_shard_guards()

    def _build_shard_guards(self) -> List[Dict[str, Any]]:
        """Dispatch mode serves shards one by one on the host, so each
        shard gets its own degradation ladder: the bound per-shard impl
        backed by reference-CSR on that shard's slab (on the shard's
        device).  Exception faults demote a single shard instead of failing
        the whole product; finiteness is *not* probed per shard (that would
        add one device sync per shard per call) — the service-level guard
        already probes the assembled output end-to-end."""
        # lazy: sharding must stay importable without the serve package
        from ..serve.guard import guard_ladder
        ref_mv = _dispatch.get_impl("csr", "spmv", "reference")
        ref_mm = _dispatch.get_impl("csr", "spmm", "reference")
        guards = []
        for i, pm in enumerate(self.planned):
            src = pm.source
            guards.append({
                "spmv": guard_ladder(
                    f"shard{i}", "spmv",
                    [("tuned", lambda xi, _pm=pm: _pm.spmv(xi)),
                     ("csr", lambda xi, _s=src: ref_mv(_s, xi))],
                    fmt=pm.fmt, probe_finite=False),
                "spmm": guard_ladder(
                    f"shard{i}", "spmm",
                    [("tuned", lambda xi, _pm=pm: _pm.spmm(xi)),
                     ("csr", lambda xi, _s=src: ref_mm(_s, xi))],
                    fmt=pm.fmt, probe_finite=False),
            })
        return guards

    def guard_report(self) -> List[Dict[str, Any]]:
        """Per-shard ladder snapshots (dispatch mode; empty otherwise)."""
        return [{op: g.snapshot() for op, g in shard.items()}
                for shard in self.shard_guards]

    # -- views ---------------------------------------------------------------
    fmt = "sharded"

    @property
    def shape(self) -> Tuple[int, int]:
        return self.source.shape

    @property
    def n_rows(self) -> int:
        return self.source.shape[0]

    @property
    def n_cols(self) -> int:
        return self.source.shape[1]

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    @property
    def n_blocks(self) -> int:
        # the serving layer's block-count view: one block per shard
        return self.plan.n_shards

    @property
    def axis(self) -> str:
        return self.plan.axis

    @property
    def device(self) -> torch.device:
        return self._devices[0]

    @property
    def devices(self) -> List[torch.device]:
        """The device each shard serves on (``shard_map``: this rank's)."""
        if self.spmd is not None:
            return [self.spmd.device]
        return [pm.device for pm in self.planned]

    @property
    def mesh(self) -> Optional[Any]:
        """The 1-D mesh a ``shard_map`` bind runs on."""
        return self.spmd.mesh if self.spmd is not None else None

    def nbytes(self) -> int:
        if self.spmd is not None:
            return self.spmd.nbytes
        return sum(memory_bytes(pm.matrix) for pm in self.planned)

    def report(self) -> List[Dict[str, Any]]:
        """Per-shard decision summary: slab extent, format, tier, nnz."""
        out = []
        b = self.boundaries
        for i, bp in enumerate(self.plan.shards):
            out.append({"shard": i, "rows": (int(b[i]), int(b[i + 1])),
                        "fmt": bp.plan.fmt, "tier": bp.plan.tier,
                        "nnz": (self.shard_nnz[i]
                                if i < len(self.shard_nnz)
                                else bp.plan.fingerprint.nnz
                                if bp.plan.fingerprint else -1)})
        return out

    # -- execution -----------------------------------------------------------
    def _check(self, x: Any, op: str) -> torch.Tensor:
        x = torch.as_tensor(x)
        want = 1 if op == "spmv" else 2
        if x.ndim != want or x.shape[0] != self.n_cols:
            shape = (f"({self.n_cols},)" if op == "spmv"
                     else f"({self.n_cols}, B)")
            raise ValueError(f"{op} expects x of shape {shape}; "
                             f"got {tuple(x.shape)}")
        return x

    def _run_dispatch(self, op: str, x: torch.Tensor,
                      tel) -> torch.Tensor:
        b = self.boundaries
        parts = []
        for i, pm in enumerate(self.planned):
            with tel.span("shard.spmv", shard=i, fmt=pm.fmt,
                          mode="dispatch"):
                if self.axis == "row":
                    xi = x
                else:
                    with tel.span("shard.gather", shard=i):
                        xi = x[int(b[i]): int(b[i + 1])]
                xi = xi.to(pm.device).contiguous()
                parts.append(self.shard_guards[i][op](xi))
        # partials live where their shards ran; the join needs them on one
        # device
        home = self.device
        parts = [p.to(home) for p in parts]
        if self.axis == "row":
            return torch.cat(parts)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def _run_shard_map(self, op: str, x: torch.Tensor,
                       tel) -> torch.Tensor:
        """This rank's product and its collectives (see the module
        docstring); every rank returns the whole ``y``.  The reassembly
        span (``shard.gather``, ``step="reassemble"``) records the bytes a
        ``gloo`` world staged through the host (``staged_bytes``)."""
        sp = self.spmd
        x = x.to(sp.device)
        y = None
        if sp.local is not None:
            impl = _dispatch.get_impl("csr", op, "kernel")
            if self.axis == "col":
                with tel.span("shard.gather", mode="shard_map",
                              n_shards=self.n_shards):
                    pads = (0, 0) * (x.ndim - 1) + (0, sp.width_pad)
                    x = torch.nn.functional.pad(x, pads)[
                        sp.offset: sp.offset + sp.width_pad]
            part = impl(sp.local, x.contiguous())
            with tel.span("shard.gather", mode="shard_map",
                          n_shards=self.n_shards,
                          step="reassemble") as span:
                staged = C.stage.bytes
                if self.axis == "row":
                    parts = C.all_gather(part, sp.group)
                    y = torch.cat([p[:r] for p, r in
                                   zip(parts, sp.rows_per)])
                else:
                    y = C.all_reduce_(part, group=sp.group)
                span.set(staged_bytes=C.stage.bytes - staged)
        if sp.outsiders:
            if y is None:
                y = torch.empty((self.n_rows,) + tuple(x.shape[1:]),
                                dtype=result_dtype(sp.data_dtype, x.dtype),
                                device=sp.device)
            C.broadcast_(y, sp.members[0])
        return y

    def _apply(self, op: str, x: Any) -> torch.Tensor:
        x = self._check(x, op)
        tel = _obs.get()
        with tel.span("sharded.spmv", op=op, mode=self.mode,
                      axis=self.axis, n_shards=self.n_shards):
            if self.mode == "single":
                return getattr(self.planned[0], op)(x)
            if self.mode == "shard_map":
                return self._run_shard_map(op, x, tel)
            return self._run_dispatch(op, x, tel)

    def spmv(self, x) -> torch.Tensor:
        return self._apply("spmv", x)

    def spmm(self, x) -> torch.Tensor:
        return self._apply("spmm", x)

    def __matmul__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        return self.spmv(x) if x.ndim == 1 else self.spmm(x)

    def __call__(self, x) -> torch.Tensor:
        return self @ x

    def __repr__(self) -> str:
        return (f"ShardedPlannedMatrix(n_shards={self.n_shards}, "
                f"axis={self.axis!r}, mode={self.mode!r}, "
                f"shape={self.shape}, formats={self.plan.shard_formats()}, "
                f"fingerprint_matched={self.fingerprint_matched})")


# ---------------------------------------------------------------------------
# binding
# ---------------------------------------------------------------------------
def _resolve_mode(mode: str, n_shards: int, mesh: Optional[Any]) -> str:
    """The mode a bind serves in (see the module docstring)."""
    if mode not in MODES:
        raise PlanError(f"unknown mode {mode!r}; one of {MODES}")
    if n_shards == 1:
        return "single"
    if mode == "single":
        raise PlanError(f"mode='single' serves a 1-shard plan; this one "
                        f"has {n_shards} shards (use mode='dispatch')")
    if mode == "auto":
        if not dist.is_initialized():
            return "dispatch"
        ranks = (mesh.mesh.numel() if mesh is not None
                 else dist.get_world_size())
        return "shard_map" if ranks >= n_shards else "dispatch"
    return mode


def build_sharded(csr: CSR, *, plan: Optional[ShardedPlan] = None,
                  planner: Optional[Planner] = None, db: Optional[Any] = None,
                  n_shards: Optional[int] = None, axis: str = "row",
                  strategy: str = "balanced_nnz", mode: str = "auto",
                  devices: Optional[Sequence[Any]] = None,
                  device: DeviceLike = None, mesh: Optional[Any] = None,
                  batch: int = 1,
                  strategy_kw: Optional[Dict[str, Any]] = None,
                  **plan_kw) -> ShardedPlannedMatrix:
    """Partition + per-shard plan + bind in one call.

    Without ``plan``, a :class:`Planner` (the given one, or a fresh one
    over ``db`` on ``device``) mints a :class:`ShardedPlan` for ``csr``
    first (``n_shards`` defaults to the number of devices).  With
    ``plan``, the recorded decisions replay with zero re-tuning; a
    fingerprint mismatch keeps the recipe — axis, strategy, shard count,
    per-shard formats — but re-partitions on the new matrix (per-shard
    geometry re-resolves exactly like single plans).  ``device`` (``None``
    = the CUDA card) picks the default ``devices``.

    In ``shard_map`` mode (see the module docstring) this is a collective:
    every rank of the world calls it with the same matrix and arguments;
    ``n_shards`` defaults to the ranks of ``mesh`` (else of the world), and
    the rank computes on ``cuda:{LOCAL_RANK % device_count()}`` (``device``
    the CPU: the CPU; ``devices``: ``devices[rank % len]``)."""
    tel = _obs.get()
    if plan is None and n_shards is None and dist.is_initialized() \
            and mode in ("auto", "shard_map"):
        n_shards = (mesh.mesh.numel() if mesh is not None
                    else dist.get_world_size())
    want = plan.n_shards if plan is not None else n_shards
    if want is not None and _resolve_mode(mode, want, mesh) == "shard_map":
        devs = [rank_device(device, devices)]
    else:
        devs = _devices(device, devices)
    if plan is None:
        planner = planner or Planner(db=db, device=devs[0])
        if n_shards is None:
            n_shards = len(devs)
        plan = planner.plan_sharded(csr, n_shards=n_shards, axis=axis,
                                    strategy=strategy, batch=batch,
                                    strategy_kw=strategy_kw, **plan_kw)
        if db is None:
            db = planner.db
    matched = plan.matches(csr)

    with tel.span("sharded.bind", n_shards=plan.n_shards, axis=plan.axis,
                  matched=matched) as sp:
        resolved = _resolve_mode(mode, plan.n_shards, mesh)
        if matched:
            boundaries = plan.boundaries()
        else:
            boundaries = shard_boundaries(csr, plan.n_shards,
                                          axis=plan.axis,
                                          strategy=plan.strategy,
                                          **plan.params)
        subs = _slice_for(csr, boundaries, plan.axis)
        imb = _imbalance(subs)
        tel.gauge("sharded.load_imbalance").set(imb)
        sp.set(mode=resolved, imbalance=imb)
        shard_nnz = [m.nnz for m in subs]
        if resolved == "shard_map":
            spmd = _Spmd(subs, boundaries, plan.axis, plan.mesh_axis,
                         devs[0], mesh)
            return ShardedPlannedMatrix(
                plan, csr, resolved, boundaries, matched, planned=None,
                devices=devs[:1], shard_nnz=shard_nnz, spmd=spmd)
        # each slab moves to its device before the bind, so a CSR shard's
        # bound matrix and the source its guard falls back to are one copy
        placed = [devs[i % len(devs)] for i in range(plan.n_shards)]
        planned = [bp.plan.bind(sub.to(dev), db=db, device=dev)
                   for bp, sub, dev in zip(plan.shards, subs, placed)]
        return ShardedPlannedMatrix(
            plan, csr, resolved, boundaries, matched, planned=planned,
            devices=placed, shard_nnz=shard_nnz)


__all__ = ["ShardedPlannedMatrix", "build_sharded", "shard_csr"]
