"""Train an LM end-to-end with the PyTorch/CUDA port's production loop:
async checkpoints, fault-tolerant restarts, straggler watchdog.

Default is a small model (~2.7M params: qwen3-1.7b's smoke depth at width
256) for a few hundred steps; any assigned architecture runs at smoke
scale via flags.

The port of ``examples/train_lm.py``, flag for flag, plus ``--device``;
its checkpoints default to a directory of its own under the temp dir, and a
later run with the same directory resumes from them.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --arch zamba2-1.2b --steps 50
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 4
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import SyntheticLM, data_config_for
from repro_torch.device import resolve_device
from repro_torch.models.model import n_params
from repro_torch.train import TrainConfig, Trainer, run_with_restarts


def config(arch="qwen3-1.7b", width=256):
    """The reduced config: the smoke config at ``width`` and a 2048-token
    vocabulary."""
    return smoke_config(get_config(arch)).replace(
        d_model=width, d_ff=width * 4 if get_config(arch).d_ff else 0,
        vocab_size=2048)


def train(cfg, steps, seq, batch, ckpt_dir, device):
    """``steps`` steps of ``Trainer`` under ``run_with_restarts``; returns
    the trainer (its ``metrics``, its ``watchdog``) and the final state."""
    data = SyntheticLM(data_config_for(cfg, seq, batch))
    tc = TrainConfig(steps=steps, ckpt_every=max(steps // 5, 10),
                     ckpt_dir=ckpt_dir, log_every=10)
    trainer = Trainer(cfg, data, tc, device=device)
    return trainer, run_with_restarts(trainer)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--width", type=int, default=256,
                    help="d_model of the reduced config")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config(args.arch, args.width)
    print(f"arch={cfg.name} params={n_params(cfg)/1e6:.1f}M "
          f"layers={cfg.n_layers} pattern={cfg.layer_pattern}")
    trainer, state = train(cfg, args.steps, args.seq, args.batch,
                           args.ckpt_dir, device)
    # a run resumed at its last step trains no further step of its own
    first = trainer.metrics[0]["loss"] if trainer.metrics else float("nan")
    last = trainer.metrics[-1]["loss"] if trainer.metrics else float("nan")
    print(f"done: step={state.step} loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'no improvement'})")
    if trainer.watchdog.flagged:
        print(f"straggler steps flagged: {trainer.watchdog.flagged}")
    return {"arch": cfg.name, "n_params": n_params(cfg), "step": state.step,
            "steps_run": len(trainer.metrics), "loss_first": first,
            "loss_last": last, "stragglers": list(trainer.watchdog.flagged)}


if __name__ == "__main__":
    main()
