"""Training launcher: the fault-tolerant trainer on the card (or, with
``--device cpu``, on the host).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --scale smoke --steps 3 --device cpu

The flags are the JAX launcher's (``repro.launch.train``), plus
``--device`` and ``--mixed-precision`` (the reference's mixed step:
bfloat16 working parameters, the float32 master in the optimizer state).  One device only: a ``--mesh`` other than ``1x1`` and
``--dry-run`` (lower and compile for a TPU mesh) raise
``NotImplementedError`` (ROADMAP.md item A16c).
"""
from __future__ import annotations

import argparse
import os
import tempfile

MULTI_DEVICE = ("multi-device training (a mesh, the compiled dry run) is "
                "ROADMAP.md item A16c")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="1x1",
                    help="DxM or PxDxM; only 1x1 on the port")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mixed-precision", action="store_true",
                    help="bfloat16 working params, float32 master in the "
                         "optimizer state")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--dry-run", action="store_true",
                    help="lower+compile the step and exit (A16c)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dims = tuple(int(x) for x in args.mesh.split("x"))
    if len(dims) not in (2, 3) or any(d != 1 for d in dims):
        raise NotImplementedError(f"--mesh {args.mesh}: {MULTI_DEVICE}")
    if args.dry_run:
        raise NotImplementedError(f"--dry-run: {MULTI_DEVICE}")

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import SyntheticLM, data_config_for
    from repro_torch.train import TrainConfig, Trainer, run_with_restarts

    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = smoke_config(cfg)
    cfg = cfg.resolve_for_tp(1)

    data = SyntheticLM(data_config_for(cfg, args.seq, args.batch))
    tc = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                     microbatches=args.microbatches,
                     mixed_precision=args.mixed_precision)
    trainer = Trainer(cfg, data, tc, device=args.device)
    state = run_with_restarts(trainer)
    print(f"finished at step {state.step}; "
          f"final loss {trainer.metrics[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
