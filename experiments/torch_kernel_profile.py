#!/usr/bin/env python3
"""Where a kernel wrapper's time goes on the card: the device time of each
CUDA kernel one call launches (the zero fill of the output included), by
``torch.profiler``, for K2 ``csr_spmv`` (three kernels: the slices' bounds,
the slices, the carries), K7 ``ccs_spmv`` and K8 ``ccs_spmm`` (the zero fill
of y or Y, then one kernel), K4 ``ell_spmm`` and K10 ``bcsr_spmm`` (one
kernel) at their default launch, and K11 ``decode_attention_int8`` (one
kernel, its splits merged by the last to finish) at the LM server's shape.

It runs xenon2 at ``scale=4.0`` (629 856 rows, 15 466 752 entries),
torso1 at ``scale=1.0`` (116 158 rows, 8 516 500 entries) and, for K7,
viscoplastic2 at ``scale=16.0`` (524 304 rows, 6.1 M scattered entries),
float32, K8, K4 and K10 at B = 128 (K4 on xenon2's ELL-Row only:
torso1's band would take gigabytes; K10 on 8 x 8 blocks, float32 and
bfloat16, with the windows ``kernels.ops.prepare`` allows), K11 at the
LM server's shape (B 8, S 8192, KV 8, G 2, Dh 128, bfloat16 q, the cases
``served`` and ``masked_row`` of ``chip_smoke.K11_CASES``), and prints one
JSON line per case: the mean device microseconds of each kernel over 20
calls, and the card's name and power limit.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_kernel_profile.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

CALLS = 20


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
        print("torch_kernel_profile: no CUDA device available",
              file=sys.stderr)
        return 1
    from repro_torch.core import suite
    from repro_torch.core import transform as T
    from repro_torch.kernels import bcsr_spmv as K9
    from repro_torch.kernels import ccs_spmv as K7
    from repro_torch.kernels import csr_spmv as K2
    from repro_torch.kernels import decode_attention as K11
    from repro_torch.kernels import ell_spmv as K1
    from repro_torch.kernels import ops

    specs = {s.name: s for s in suite.TABLE1}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, scale, kernels in (
            ("xenon2", 4.0, ("csr_spmv", "ccs_spmv", "ccs_spmm", "ell_spmm",
                             "bcsr_spmm", "bcsr_spmm_bf16")),
            ("torso1", 1.0, ("csr_spmv", "ccs_spmv", "ccs_spmm",
                             "bcsr_spmm")),
            ("viscoplastic2", 16.0, ("ccs_spmv", "bcsr_spmm"))):
        csr = suite.synthesize(specs[name], scale=scale, device="cpu")
        m = csr.to(dev)
        ccs = T.host_csr_to_ccs(csr).to(dev)
        ell = (T.host_csr_to_ell(csr, order="row").to(dev)
               if "ell_spmm" in kernels else None)
        bm = ops.prepare(T.host_csr_to_bcsr(csr).to(dev))
        bd, Xh = bm.data.to(torch.bfloat16), None
        x = torch.randn(m.n_cols, generator=gen, device=dev)
        X = torch.randn((m.n_cols, 128), generator=gen, device=dev)
        label = name if scale == 1.0 else f"{name}@x{scale:g}"
        calls = {
            "csr_spmv": lambda: K2.csr_spmv(m.data, m.cols, m.indptr, x),
            "ccs_spmv": lambda: K7.ccs_spmv(ccs.data, ccs.rows, ccs.indptr,
                                            x, ccs.n_rows),
            "ccs_spmm": lambda: K7.ccs_spmm(ccs.data, ccs.rows, ccs.indptr,
                                            X, ccs.n_rows),
            "ell_spmm": lambda: K1.ell_spmm(ell.data, ell.cols, X),
            "bcsr_spmm": lambda: K9.bcsr_spmm(
                bm.data, bm.block_cols, bm.indptr, X, bm.n_rows),
            "bcsr_spmm_bf16": lambda: K9.bcsr_spmm(
                bd, bm.block_cols, bm.indptr, Xh, bm.n_rows)}
        if "bcsr_spmm_bf16" in kernels:
            Xh = X.to(torch.bfloat16)
        for kernel in kernels:
            bf16 = kernel.endswith("_bf16")
            print(json.dumps({"kernel": kernel.removesuffix("_bf16"),
                              "matrix": label,
                              "dtype": "bfloat16" if bf16 else "float32",
                              "batch": 128 if "spmm" in kernel else None,
                              "device_us": kernel_us(calls[kernel])}),
                  flush=True)
        del m, ccs, ell, bm, bd, X, Xh, calls
        torch.cuda.empty_cache()
    # K11 at the LM server's shape
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as smoke
    for i, case in enumerate(smoke.K11_CASES):
        if case[0] not in ("served", "masked_row"):
            continue
        args, kw = smoke.k11_case_inputs(i)
        print(json.dumps({"kernel": "decode_attention_int8",
                          "case": case[0], "dtype": "bfloat16",
                          "device_us": kernel_us(
                              lambda: K11.decode_attention_int8(*args,
                                                                **kw))}),
              flush=True)
        del args
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
