#!/usr/bin/env python3
"""Where the run-time transform's copy from the card to the host spends its
time: the same copy of one CRS array of ``hpcg128.rebind`` (55 742 968
float32 values, 223 MB) into a fresh pageable buffer each time (what
``transform.copy_out`` does), into one pageable buffer reused, and into a
pinned buffer; and the host's first touch of a fresh buffer of that size
alone (no copy).  Prints one JSON line: each way's ms a copy over
``--reps`` copies (the first apart) and its GB/s, the host's transparent
huge page setting, and the card's name and power limit.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_copy_out.py [--reps 5]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

N = 55_742_968


def timed(fn, reps):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return {"first_ms": out[0], "rest_median_ms": statistics.median(out[1:]),
            "rest_gb_s": N * 4 / statistics.median(out[1:]) / 1e6}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    src = torch.randn(N, device="cuda")
    reused = torch.empty(N)
    pinned = torch.empty(N, pin_memory=True)
    rec = {
        "fresh_pageable": timed(lambda: src.to("cpu"), args.reps),
        "reused_pageable": timed(lambda: reused.copy_(src), args.reps),
        "pinned": timed(lambda: pinned.copy_(src), args.reps),
        "first_touch_only": timed(lambda: torch.empty(N).fill_(0.0),
                                  args.reps),
    }
    try:
        with open("/sys/kernel/mm/transparent_hugepage/enabled") as f:
            rec["thp"] = f.read().strip()
    except OSError:
        rec["thp"] = None
    rec["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
