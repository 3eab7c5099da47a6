"""§Perf hillclimbing harness: trace one (arch x shape) cell under a named
optimization variant and record the roofline evidence.

The port of the JAX package's ``launch/perf.py``, over the port's dry run
(``launch/dryrun.py``: rank 0 of a fake 16x16 world of H100s; what stands
in for each of XLA's readings is in ``launch/roofline.py``).  Measurements
per variant:

  * traced: FLOPs, bytes and collective bytes of rank 0's step (the
    reference's ``scanned`` HLO counts each while body once; the trace runs
    every iteration, so one record replaces both ``scanned`` and
    ``unrolled``);
  * unrolled (decode cells): the same cell with its layer pattern unrolled
    (``unrolled_cfg``), which must read the same;
  * analytic: the closed-form terms (``launch/analytic.py``);
  * the peak memory of the trace (``MemTracker``).

The variants are the reference's, with its names and config transforms.
The ``serve_ws*`` variants ask for weight-stationary serving, which a
decode cell runs by default (``launch/steps.py:jitted_step_for_cell``).

    PYTHONPATH=src python -m repro_torch.launch.perf \\
        --cell dbrx-132b:decode_32k --variant base
"""
from __future__ import annotations

import argparse
import json
import os
import time

from ..configs import SHAPES, get_config
from .analytic import analytic_costs
from .dryrun import (MESHES, memory_of, slowest_link, trace_cell,
                     unrolled_cfg)
from .roofline import HBM_BW, PEAK_FLOPS_BF16

# variant name -> (cfg transform, step kwargs)
VARIANTS = {
    "base": (lambda c: c, {}),
    # dbrx decode iterations
    "kv_bf16": (lambda c: c, {"kv_quant": False}),      # pre-int8 baseline
    "kv_int8": (lambda c: c, {"kv_quant": True}),
    "serve_ws": (lambda c: c, {"kv_quant": True,
                               "serve_weight_stationary": True}),
    "serve_ws_bf16": (lambda c: c, {"kv_quant": False,
                                    "serve_weight_stationary": True}),
    "moe_c1": (lambda c: c, {"kv_quant": True}),   # after capacity-floor fix
    "moe_csr": (lambda c: c.replace(moe_dispatch="csr"),
                {"kv_quant": True}),
    "moe_c1_ws": (lambda c: c, {"kv_quant": True,
                                "serve_weight_stationary": True}),
    # gemma3 train iterations
    "embed_tp": (lambda c: c.replace(embed_tp_lookup=True), {}),
    # xlstm train iterations
    "local_rec": (lambda c: c.replace(xlstm_shard_recurrent=False), {}),
    "zero1": (lambda c: c, {"zero1": True}),
    "local_rec_zero1": (lambda c: c.replace(xlstm_shard_recurrent=False),
                        {"zero1": True}),
    "embed_tp_zero1": (lambda c: c.replace(embed_tp_lookup=True),
                       {"zero1": True}),
    "mixed": (lambda c: c, {"mixed_precision": True}),
    "mixed_embed_tp": (lambda c: c.replace(embed_tp_lookup=True),
                       {"mixed_precision": True}),
    "mixed_zero1": (lambda c: c, {"mixed_precision": True, "zero1": True}),
    "flash4k": (lambda c: c.replace(flash_kv_chunk=4096), {}),
}


def run_variant(arch: str, shape_name: str, variant: str,
                out_dir: str = "experiments/perf_torch",
                unroll: bool = None, device: str = "cuda") -> dict:
    mesh_name, dims, axes = MESHES[False]
    chips = dims[0] * dims[1]
    shape = SHAPES[shape_name]
    cfg_fn, kwargs = VARIANTS[variant]
    cfg = cfg_fn(get_config(arch).resolve_for_tp(dims[-1]))
    if unroll is None:
        unroll = shape.kind == "decode"

    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "device": device}
    t0 = time.time()
    rl, tr = trace_cell(cfg, shape, dims, axes, arch=arch,
                        mesh_name=mesh_name, device=device, **kwargs)
    rec["traced"] = rl.to_dict()
    rec["memory"] = memory_of(tr)
    rec["peak_gb"] = tr.peak_bytes / 1e9

    if unroll:
        url, _ = trace_cell(unrolled_cfg(cfg), shape, dims, axes, arch=arch,
                            mesh_name=mesh_name, device=device,
                            memory=False, donate=False, microbatches=1,
                            **kwargs)
        rec["unrolled"] = url.to_dict()

    cfg_serve = (cfg if shape.kind == "train"
                 else cfg.replace(kv_quant=kwargs.get("kv_quant", True)))
    ac = analytic_costs(cfg_serve, shape, chips, dims[0], dims[1])
    rec["analytic"] = {
        "t_compute_ms": ac.flops / PEAK_FLOPS_BF16 * 1e3,
        "t_memory_ms": ac.bytes / HBM_BW * 1e3,
        "t_collective_ms": ac.collective_bytes / slowest_link(dims) * 1e3,
    }
    rec["trace_s"] = time.time() - t0

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{variant}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)

    src = rec["traced"]
    print(f"[perf] {arch} x {shape_name} [{variant}]: "
          f"flops/dev={src['traced_flops']:.3g} "
          f"bytes/dev={src['traced_bytes']:.3g} "
          f"coll/dev={src['collective_bytes']:.3g} "
          f"peak={rec['peak_gb']:.2f}GB "
          f"(traced{', +unrolled' if 'unrolled' in rec else ''}, "
          f"{rec['trace_s']:.0f}s)")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", required=True,
                    help=f"one of {sorted(VARIANTS)} or comma list")
    ap.add_argument("--out", default="experiments/perf_torch")
    ap.add_argument("--unroll", action="store_true", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device type the fake tensors claim (cuda or cpu)")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    for v in args.variant.split(","):
        run_variant(arch, shape, v, args.out, unroll=args.unroll,
                    device=args.device)


if __name__ == "__main__":
    main()
