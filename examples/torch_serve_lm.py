"""Serve a small model with batched requests through the continuous-
batching engine of the PyTorch/CUDA port (per-slot lengths,
prefill-on-admit, int8 KV optional: ``--kv-quant`` decodes through the
int8 decode-attention kernel on the card).

The port of ``examples/serve_lm.py``, flag for flag, plus ``--kv-quant``
and ``--device``.

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 6
    PYTHONPATH=src python examples/torch_serve_lm.py --kv-quant
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import init
from repro_torch.serve import ServeEngine


def prompts(cfg, requests, seed=0):
    """The reference's prompts: ``requests`` of 4–23 random tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, int(rng.integers(4, 24))
                         ).astype(np.int32) for _ in range(requests)]


# the run ends with the tokens on the host, so its two clock reads bracket
# the work on the card — repro: noqa[RPA004]
def serve(params, cfg, prompt_list, max_new, slots, device):
    """Every prompt through ``ServeEngine``; returns the finished requests
    by id and the seconds the run took."""
    eng = ServeEngine(params, cfg, max_batch=slots, max_len=128,
                      device=device)
    t0 = time.perf_counter()
    for p in prompt_list:
        eng.submit(p, max_new_tokens=max_new)
    done = eng.run()
    return done, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke_config(get_config(args.arch))
    if args.kv_quant:
        cfg = cfg.replace(kv_quant=True)
    params = init(cfg, torch.Generator(device=device).manual_seed(0),
                  device=device)
    done, dt = serve(params, cfg, prompts(cfg, args.requests),
                     args.max_new, args.slots, device)
    total_new = sum(len(r.generated) for r in done.values())
    print(f"arch={cfg.name} slots={args.slots} requests={len(done)}")
    for rid in sorted(done):
        r = done[rid]
        print(f"  req{rid}: prompt_len={len(r.prompt)} "
              f"generated={r.generated}")
    print(f"throughput: {total_new/dt:.1f} tok/s "
          f"({total_new} tokens in {dt:.2f}s, continuous batching)")
    return {"arch": cfg.name, "requests": len(done), "tokens": total_new,
            "seconds": dt, "kv_quant": cfg.kv_quant,
            "generated": {rid: list(map(int, r.generated))
                          for rid, r in done.items()}}


if __name__ == "__main__":
    main()
