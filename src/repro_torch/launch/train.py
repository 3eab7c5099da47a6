"""Training launcher: the fault-tolerant trainer on the card (or, with
``--device cpu``, on the host), on one device or a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --scale smoke --steps 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --scale smoke --steps 3 --mesh 2x2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --scale full --seq 4096 --batch 256 --mesh 16x16 --dry-run

The flags are the JAX launcher's (``repro.launch.train``), plus
``--device`` and ``--mixed-precision`` (the reference's mixed step:
bfloat16 working parameters, the float32 master in the optimizer state).

Mesh axes: DxM (data x model) or PxDxM (pod x data x model), one rank a
mesh position.  Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) the
process joins that world (its size must be the mesh's); otherwise the
launcher spawns the ranks itself on this host: over ``gloo`` with
``--device cpu``, else over NCCL with one card a rank (it raises when the
host has fewer cards than the mesh has ranks).  Rank 0 prints the final
line.

``--dry-run`` trains nothing: it traces the step these flags would run
(``ShapeConfig("custom", seq, batch, "train")`` on ``--mesh``) for rank 0
of a fake world on fake tensors of ``--device``'s type (``launch/
dryrun.py``; no card and no memory needed) and prints its peak memory and
its FLOPs and bytes, as the reference prints XLA's ``memory_analysis()``
and ``cost_analysis()``.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM, e.g. 2x2 or 2x2x1")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mixed-precision", action="store_true",
                    help="bfloat16 working params, float32 master in the "
                         "optimizer state")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--dry-run", action="store_true",
                    help="trace the step on a fake world, print its memory "
                         "and costs, and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def mesh_of(spec: str):
    """(dims, axis names) of a ``DxM`` / ``PxDxM`` spec."""
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"--mesh {spec}: expected DxM or PxDxM")
    return dims, {2: ("data", "model"), 3: ("pod", "data", "model")}[len(dims)]


def run(args: argparse.Namespace, device=None) -> None:
    """Train as the flags say; on a mesh every rank of the world calls
    it, and rank 0 prints the final line."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import SyntheticLM, data_config_for
    from repro_torch.launch.mesh import make_mesh, model_axis_size
    from repro_torch.train import TrainConfig, Trainer, run_with_restarts

    dims, axes = mesh_of(args.mesh)
    device = device if device is not None else args.device
    mesh = (make_mesh(dims, axes, device=device)
            if math.prod(dims) > 1 else None)
    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = smoke_config(cfg)
    cfg = cfg.resolve_for_tp(model_axis_size(mesh) if mesh else 1)

    data = SyntheticLM(data_config_for(cfg, args.seq, args.batch))
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     microbatches=args.microbatches,
                     mixed_precision=args.mixed_precision)
    trainer = Trainer(cfg, data, tc, device=device, mesh=mesh)
    state = run_with_restarts(trainer)
    if trainer._lead:
        print(f"finished at step {state.step}; "
              f"final loss {trainer.metrics[-1]['loss']:.4f}", flush=True)


def dry_run(args: argparse.Namespace) -> None:
    """Trace the flags' step for rank 0 of a fake world (one device: the
    trainer's own step) and print what the trace reads."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import memory_of, trace_cell

    dims, axes = mesh_of(args.mesh)
    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = smoke_config(cfg)
    cfg = cfg.resolve_for_tp(dims[-1])
    shape = ShapeConfig("custom", args.seq, args.batch, "train")
    rl, tr = trace_cell(cfg, shape, dims, axes, arch=args.arch,
                        mesh_name=args.mesh, device=args.device or "cuda",
                        microbatches=args.microbatches,
                        mixed_precision=args.mixed_precision)
    mem = memory_of(tr)
    cost = {"flops": rl.traced_flops, "bytes accessed": rl.traced_bytes,
            "collective bytes": rl.collectives_by_axis}
    print(f"memory (rank 0 of {math.prod(dims)}, fake "
          f"{args.device or 'cuda'} tensors): {mem}")
    print(cost, flush=True)


def _rank(rank: int, argv) -> None:
    """One spawned rank of a ``--mesh`` run."""
    from repro_torch.launch.mesh import rank_device
    args = parse(argv)
    run(args, rank_device(args.device))


def main(argv=None) -> None:
    args = parse(argv)
    dims, _ = mesh_of(args.mesh)
    if args.dry_run:
        dry_run(args)
        return
    n = math.prod(dims)
    if n == 1:
        run(args)
        return
    import torch
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    backend = "gloo" if cpu else "nccl"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist
        from repro_torch.launch.mesh import init_world
        dev = init_world(int(os.environ["RANK"]),
                         int(os.environ["WORLD_SIZE"]), "env://", backend,
                         args.device)
        try:
            run(args, dev)
        finally:
            dist.destroy_process_group()
        return
    if not cpu and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"--mesh {args.mesh} spawns {n} ranks over NCCL, one card a "
            f"rank; this host has {torch.cuda.device_count()} card(s) (use "
            f"--device cpu for gloo ranks on the host)")
    from repro_torch.launch.mesh import spawn
    spawn(_rank, n, (argv,), backend=backend, device=args.device,
          wall_s=None)


if __name__ == "__main__":
    main()
