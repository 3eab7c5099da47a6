#!/usr/bin/env python3
"""Where a sharded product's device time goes on the card.

For xenon2 at ``scale=4.0`` (629 856 rows, 15.47 M entries, past the L2) it
binds, at the kernel tier:

* ``whole``: the unsharded plan (``Planner(tier="kernel").plan(csr,
  **kw)``);
* ``row``: ``plan_sharded(csr, n_shards=4, axis="row", **kw)``, served in
  ``dispatch`` mode;
* ``col``: the same on the column axis;

for ``kw`` = ``{"fmt": "csr"}`` (the B = 32 TuningDB's pick, ``D*`` = 0)
and ``{}`` (the cost model's pick), and for each, SpMV and SpMM at B = 32,
prints one JSON line: the shard formats, the device time of one product
behind a head start (``autotune.time_device``, median of 10), the device
time of each shard's product alone on its own input (median of 10), and
the device microseconds of each CUDA kernel a product launches
(``torch.profiler``, mean over 10 products; the partials' sum and the
``cat`` among them).  Then the card's name and power limit.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_sharded_profile.py
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

CALLS = 10
BATCH = 32
SHARDS = 4
RULES = (("csr", {"fmt": "csr"}), ("cost_model", {}))


def kernel_us(fn) -> dict:
    """Mean device microseconds per call of each kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or \
            getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            out[e.key.split("(")[0][:60]] = us / CALLS
    return out


def device_ms(fn) -> float:
    from repro_torch.core.autotune import time_device
    fn()
    torch.cuda.synchronize()
    return statistics.median(time_device(fn) * 1e3 for _ in range(CALLS))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_sharded_profile: no CUDA device available",
              file=sys.stderr)
        return 1
    from repro_torch.core import suite
    from repro_torch.core.plan import Planner

    specs = {s.name: s for s in suite.TABLE1}
    csr = suite.synthesize(specs["xenon2"], scale=4.0)
    g = torch.Generator(device="cuda").manual_seed(0)
    inputs = {"spmv": torch.randn(csr.n_cols, generator=g, device="cuda"),
              "spmm": torch.randn((csr.n_cols, BATCH), generator=g,
                                  device="cuda")}
    planner = Planner(tier="kernel")
    for rule, kw in RULES:
        want = {}
        whole = planner.plan(csr, batch=BATCH, **kw).bind(csr)
        for layout in ("whole", "row", "col"):
            if layout == "whole":
                P, formats = whole, [whole.fmt]
            else:
                P = planner.plan_sharded(csr, n_shards=SHARDS, axis=layout,
                                         batch=BATCH, **kw).bind(csr)
                formats = list(P.plan.shard_formats())
            for op, x in inputs.items():
                fn = (lambda: P.spmv(x)) if op == "spmv" else \
                    (lambda: P.spmm(x))
                y = fn()
                if op in want:          # every layout gives one product
                    err = float((y - want[op]).abs().max())
                    if err > 1e-3 * float(want[op].abs().max()):
                        raise AssertionError(f"{rule} {layout} {op}: off "
                                             f"the whole product by {err}")
                else:
                    want[op] = y
                shards = []
                if layout != "whole":
                    b = P.boundaries
                    for i, pm in enumerate(P.planned):
                        xi = x if layout == "row" else \
                            x[int(b[i]):int(b[i + 1])].contiguous()
                        f = pm.spmv if op == "spmv" else pm.spmm
                        shards.append({
                            "fmt": pm.fmt, "n_rows": pm.n_rows,
                            "n_cols": pm.n_cols, "nnz": pm.source.nnz,
                            "ms": device_ms(lambda: f(xi))})
                print(json.dumps({
                    "matrix": "xenon2@x4", "rule": rule, "layout": layout,
                    "op": op, "batch": BATCH if op == "spmm" else 1,
                    "formats": formats, "device_ms": device_ms(fn),
                    "shards": shards, "kernel_us": kernel_us(fn)}),
                    flush=True)
            if layout != "whole":
                del P
        del whole, want
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
