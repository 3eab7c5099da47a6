"""The readings the limits of ``correct`` are set from (never run by a
benchmark run).

In one process, with one set-up, for each seed: draw that seed's vectors,
run a short window of the cell's own traffic on the program, and compare
as a run does; then the same with the control, the bfloat16 reference put
in the program's place (``--control-seeds``).  Prints one JSON line a
reading::

    python3 -m spmvbench.calibrate --workload hpcg256.cg50 --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 2

The lower reading of a number is the largest over the program's seeds, the
upper the smallest over the control's; ``PERF.md`` gives both and the
limit set between them.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, workload: str, seeds, control: bool, seconds: float,
             device: torch.device, matrix=None):
    """``[(seed, checks, units, failed)]`` of the program (or the control)
    over ``seeds``, after one set-up: the harness's own set-up, window and
    comparison (``harness.Cell``), each seed's vectors drawn anew, the
    numbers before any limit is put beside them."""
    from spmvbench import harness
    from spmvbench.program import Control, Program
    program = (Control if control else Program)(device)
    c = harness.Cell(root, workload, seeds[0], device, program, matrix,
                     log=lambda s: None)
    out = []
    for s in seeds:
        c.ctx.seed = int(s)
        c.drv.draw()
        c.measure(seconds)
        out.append((int(s), c.drv.check(), c.drv.units, c.drv.failed))
    c.drv.release()
    return out, c.matrix, c.drv.plan_line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spmvbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import build_all
    build_all()
    device = torch.device("cuda", 0)
    matrix = None
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        seeds = [int(s) for s in seeds.split(",") if s]
        if not seeds:
            continue
        t0 = time.perf_counter()
        rows, matrix, plan = readings(ROOT, args.workload, seeds, control,
                                      args.seconds, device, matrix)
        for s, checks, units, failed in rows:
            print(json.dumps({"workload": args.workload,
                              "side": "control" if control else "program",
                              "seed": s, "units": units, "failed": failed,
                              "checks": checks, "plan": plan}), flush=True)
        print(f"{'control' if control else 'program'}: {len(seeds)} seeds "
              f"in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
