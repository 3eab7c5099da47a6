#!/usr/bin/env python3
"""What one streaming delta costs on the card: kernel launches, copies
between host and card, and the card's busy time.

For xenon2 at ``scale=4.0`` (629 856 rows, 15.47 M entries) it registers a
CSR and a SELL streaming key on an ``SpMVService`` (kernel-tier leaf
plans), absorbs two warm-up deltas, then applies deltas of
``random_delta(n_appends=A, n_updates=U, n_deletes=D, row_len=24)`` at an
eighth of the size ``(32, 512, 32)`` and at the full size ``(256, 4096,
256)`` — ``chip_smoke.py``'s ``serve_stream`` mix — each once under
``torch.profiler`` and once under the function mode that counts the torch
calls on the card (``chip_smoke.counted_calls``, what ``serve_stream``
prints), and prints one JSON line a (key, size): ``t_apply_s``, the rows
changed, the SELL buckets rebuilt, the kernel launches
(``cudaLaunchKernel`` calls), the copies (``cudaMemcpy*`` calls), the busy
ms and the kernels that take most of it, and the call count.  Then the
card's name and power limit.

The profiler's tracing stays attached to the process once started, so
this runs in a process of its own, not inside ``chip_smoke.py``.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_stream_profile.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

SIZES = (("small", {"n_appends": 32, "n_updates": 512, "n_deletes": 32}),
         ("full", {"n_appends": 256, "n_updates": 4096, "n_deletes": 256}))


def profiled(fn):
    """``fn()`` under ``torch.profiler``: its result and what the card did
    for it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def calls(keys):
        return sum(e.count for e in events if e.key in keys)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)
    busy = sorted(((e.key, dev_us(e), e.count) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and dev_us(e) > 0), key=lambda t: -t[1])
    return out, {
        "kernel_launches": calls(("cudaLaunchKernel", "cuLaunchKernelEx",
                                  "cuLaunchKernel")),
        "copies": calls(("cudaMemcpyAsync", "cudaMemcpy")),
        "busy_ms": sum(t[1] for t in busy) / 1e3,
        "top_kernels": [{"name": k[:60], "ms": us / 1e3, "calls": n}
                        for k, us, n in busy[:6]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_stream_profile: no CUDA device available",
              file=sys.stderr)
        return 1
    from chip_smoke import clone_csr, counted_calls
    from repro_torch import api
    from repro_torch.core import suite
    from repro_torch.stream import random_delta

    specs = {s.name: s for s in suite.TABLE1}
    base = suite.synthesize(specs["xenon2"], scale=4.0)
    svc = api.SpMVService(max_batch=32)
    for fmt in ("csr", "sell"):
        key = f"stream_{fmt}"
        csr = clone_csr(base)
        svc.register(key, csr, streaming=True, measure_baseline=False,
                     plan=api.Planner(tier="kernel").plan(csr, fmt=fmt))
        rng = np.random.default_rng(5)
        for _ in range(2):
            svc.apply_delta(key, random_delta(
                rng, svc.entries[key].source, row_len=24,
                **SIZES[1][1]))
        for size, kw in SIZES:
            delta = random_delta(rng, svc.entries[key].source, row_len=24,
                                 **kw)
            res, prof = profiled(lambda: svc.apply_delta(key, delta))
            delta = random_delta(rng, svc.entries[key].source, row_len=24,
                                 **kw)
            _, calls = counted_calls(lambda: svc.apply_delta(key, delta))
            print(json.dumps({
                "matrix": "xenon2@x4", "key": fmt, "size": size,
                "mode": res.mode, "fallback": res.fallback_reason or None,
                "t_apply_s": res.t_apply_s,
                "rows_changed": int(res.changed_rows.shape[0]),
                "buckets_rebuilt": res.buckets_rebuilt, **prof,
                "torch_calls": calls}), flush=True)
        svc.evict(key)
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
