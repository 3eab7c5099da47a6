"""Meshes over a ``torch.distributed`` world, and the world itself.

The port of the JAX package's ``launch/mesh.py``.  The reference is one
process driving every device of a ``jax.sharding.Mesh``; the port is SPMD:
one process a rank, a ``torch.distributed`` world of them, and a
:class:`~torch.distributed.device_mesh.DeviceMesh` with named dims as the
counterpart of the reference's mesh.  Every function that builds a mesh is
a collective: every rank of the world calls it, in the same order, with
the same arguments.

Meshes are built by FUNCTIONS, so importing this module touches no process
group (the reference's rule: importing its module touches no device state).

The world:

  * :func:`init_world` joins one rank to a world over a ``file://`` store
    (a path, so concurrent worlds on one host never race for a TCP port)
    or ``env://`` (under ``torchrun``), with a bounded collective timeout,
    and pins the rank's CUDA card;
  * :func:`spawn` starts a world of local ranks (``spawn``, never
    ``fork``: a parent that touched CUDA cannot fork), runs a function on
    each, returns each rank's result, and fails as a whole, within a wall
    limit, when one rank fails or hangs.
"""
from __future__ import annotations

import datetime
import math
import os
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import DeviceLike

#: the collective timeout of every world the port starts, in seconds: a
#: rank stuck in a collective fails after it instead of hanging its caller
WORLD_TIMEOUT_S = 60.0


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------
def world_size() -> int:
    """Ranks in the initialized world; 1 in a process that joined none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device: DeviceLike = None,
                devices: Optional[Sequence[Any]] = None) -> torch.device:
    """The device this rank computes on: ``devices[rank % len]`` when
    given, the CPU when ``device`` asks for it, else the card
    ``cuda:{LOCAL_RANK % device_count()}`` (ranks share a card when there
    are more ranks than cards)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    if devices is not None:
        return torch.device(devices[rank % len(devices)])
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run on the host")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_world(rank: int, size: int, init_method: str,
               backend: str = "gloo", device: DeviceLike = None
               ) -> torch.device:
    """Join this process to a world as ``rank`` of ``size`` (collectives
    time out after ``WORLD_TIMEOUT_S``) and return the device it computes
    on (the card it was pinned to, or the CPU)."""
    os.environ.setdefault("LOCAL_RANK", str(rank))
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=WORLD_TIMEOUT_S))
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _rank_main(rank: int, fn: Callable, size: int, init_method: str,
               backend: str, device: DeviceLike, args: tuple,
               out_dir: str) -> None:
    """One spawned rank: join, run ``fn(rank, *args)``, save its result."""
    os.environ["LOCAL_RANK"] = str(rank)
    init_world(rank, size, init_method, backend, device)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


# the clock is read for the wall limit, not to time work on a card —
# repro: noqa[RPA004]
def spawn(fn: Callable, nprocs: int, args: tuple = (), *,
          backend: str = "gloo", device: DeviceLike = None,
          wall_s: Optional[float] = 120.0,
          workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` on each rank of a new world of ``nprocs``
    local processes and return the ranks' results in rank order (each
    saved with ``torch.save``: tensors on the CPU, or plain values).

    ``fn`` must be importable by name (a module-level function).  The
    store is a file under ``workdir`` (default: a fresh temporary
    directory, removed after).  A rank that raises fails the call with its
    traceback; the others are terminated.  A world still running after
    ``wall_s`` seconds (``None``: no limit) is terminated and raises
    :class:`TimeoutError`."""
    import torch.multiprocessing as mp
    own = workdir is None
    work = tempfile.mkdtemp(prefix="repro_world_") if own else \
        tempfile.mkdtemp(prefix="world_", dir=workdir)
    try:
        init_method = "file://" + os.path.join(work, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, init_method, backend, device,
                              args, work),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if wall_s is None else time.monotonic() + wall_s
        while not ctx.join(timeout=None if deadline is None else
                           max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(5)
                raise TimeoutError(
                    f"a world of {nprocs} ranks ran past {wall_s:.0f} s")
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def _device_type(device: DeviceLike) -> str:
    return "cuda" if device is None else torch.device(device).type


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceLike = None):
    """A mesh of ``shape`` with dims named ``axes`` over the initialized
    world (its size must be ``prod(shape)``); its tensors live on the card
    unless ``device`` names the CPU."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh{shape}: no torch.distributed world "
                           "is initialized (see launch.mesh.init_world)")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """16x16 = 256 ranks for one pod; 2x16x16 = 512 across two pods (the
    reference's TPU meshes; the world must have that many ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def mesh_shape(mesh) -> dict:
    """``{dim name: size}`` — the reference's ``dict(mesh.shape)``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axis_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return shape.get("pod", 1) * shape.get("data", 1)


def model_axis_size(mesh) -> int:
    return mesh_shape(mesh).get("model", 1)


__all__ = ["WORLD_TIMEOUT_S", "world_size", "rank_device", "init_world",
           "spawn", "make_mesh", "make_production_mesh", "mesh_shape",
           "data_axis_size", "model_axis_size"]
