"""Serving launcher: the continuous-batching engine on the card (or, with
``--device cpu``, on the host).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --scale smoke --requests 8 --slots 4 --kv-quant

The flags are the JAX launcher's (``repro.launch.serve``), plus
``--device``.  Weights are drawn from a seeded generator on the device.
"""
from __future__ import annotations

import argparse
import time


# the run ends with the tokens on the host, so its two clock reads bracket
# the work on the card — repro: noqa[RPA004]
def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (production serving default)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init
    from repro_torch.serve import ServeEngine

    cfg = get_config(args.arch)
    if args.scale == "smoke":
        cfg = smoke_config(cfg)
    if args.kv_quant:
        cfg = cfg.replace(kv_quant=True)

    device = resolve_device(args.device)
    params = init(cfg, torch.Generator(device=device).manual_seed(0),
                  device=device)
    eng = ServeEngine(params, cfg, max_batch=args.slots,
                      max_len=args.max_len, device=device)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        plen = int(rng.integers(4, args.max_len // 4))
        eng.submit(rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
                   max_new_tokens=args.max_new)
    done = eng.run()      # tokens come back to the host: the card is done
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done.values())
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s) on {device}")


if __name__ == "__main__":
    main()
