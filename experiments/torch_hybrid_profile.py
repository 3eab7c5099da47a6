#!/usr/bin/env python3
"""Where a hybrid product's device time goes on the card, and what the row
sort costs it.

For xenon2 at ``scale=4.0`` (629 856 rows, 15.47 M entries, past the L2)
and torso1 at ``scale=1.0`` (116 158 rows, 8.5 M entries) it binds, at the
kernel tier:

* ``csr``: the whole matrix in CSR, one kernel a product;
* ``variance``: ``Planner(tier="kernel").plan(csr, partition="variance",
  max_blocks=16, min_rows=64)``, rows sorted by length first (the
  reference's default for this strategy);
* ``variance_unsorted``: the same strategy and knobs with
  ``sort_rows=False``, so each block is a run of adjacent rows;

and for each, SpMV and SpMM at B = 128, prints one JSON line: the block
formats, the launches a product makes, the device time of one product
behind a head start (``autotune.time_device``, median of 10), and the
device microseconds of each CUDA kernel a product launches
(``torch.profiler``, mean over 10 products; the reassembly's ``cat`` and
``index_copy_`` among them).  Then the card's name and power limit.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_hybrid_profile.py
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

CALLS = 10
BATCH = 128
PLANS = (("csr", {"fmt": "csr"}),
         ("variance", {"partition": "variance", "max_blocks": 16,
                       "min_rows": 64}),
         ("variance_unsorted", {"partition": "variance", "max_blocks": 16,
                                "min_rows": 64, "sort_rows": False}))


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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_hybrid_profile: no CUDA device available",
              file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.core import suite
    from repro_torch.core.autotune import time_device
    from repro_torch.core.plan import Planner

    specs = {s.name: s for s in suite.TABLE1}
    planner = Planner(tier="kernel")
    for name, scale in (("xenon2", 4.0), ("torso1", 1.0)):
        csr = suite.synthesize(specs[name], scale=scale)
        rng = np.random.default_rng(0)
        inputs = {"spmv": torch.from_numpy(rng.normal(
                      size=csr.n_cols).astype(np.float32)).cuda(),
                  "spmm": torch.from_numpy(rng.normal(
                      size=(csr.n_cols, BATCH)).astype(np.float32)).cuda()}
        label = name if scale == 1.0 else f"{name}@x{scale:g}"
        want = {}
        for plan_name, kw in PLANS:
            P = planner.plan(csr, batch=BATCH, **kw).bind(csr)
            formats = (P.matrix.format_counts() if P.fmt == "hybrid"
                       else {"csr": 1})
            for op, x in inputs.items():
                fn = (lambda: P.spmv(x)) if op == "spmv" else \
                    (lambda: P.spmm(x))
                y = fn()
                torch.cuda.synchronize()
                if op in want:          # every plan gives the same product
                    err = float((y - want[op]).abs().max())
                    if err > 1e-3 * float(want[op].abs().max()):
                        raise AssertionError(f"{label} {plan_name} {op}: "
                                             f"off the CSR product by {err}")
                else:
                    want[op] = y
                before = kernels.launch_counts()
                fn()
                torch.cuda.synchronize()
                after = kernels.launch_counts()
                ms = statistics.median(time_device(fn) * 1e3
                                       for _ in range(CALLS))
                print(json.dumps({
                    "matrix": label, "plan": plan_name, "op": op,
                    "batch": BATCH if op == "spmm" else 1,
                    "formats": formats,
                    "launches": {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]},
                    "device_ms": ms, "kernel_us": kernel_us(fn)}),
                    flush=True)
            del P
        del csr, inputs, want
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
