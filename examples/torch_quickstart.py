"""Quickstart on the PyTorch/CUDA port: auto-tuned run-time sparse-format
transformation in ~30 lines.

Off-line, learn the machine's D_mat–R graph once; on-line, one `Planner`
call turns a CSR matrix into a portable `ExecutionPlan` (decision rule +
format + transform recipe + launch geometry) that binds to the matrix and
serves `y = P @ x`.

The port of ``examples/quickstart.py``, step for step.  The off-line phase
times the kernel tier (the hand-written CUDA kernels on the card, their
plain PyTorch versions on the CPU) and the plans bind to it.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch import ExecutionPlan, MatrixStats, Planner, offline_phase
from repro_torch.core.suite import paper_suite, synthesize, TABLE1
from repro_torch.device import resolve_device

#: a uniform matrix and a heavy-tailed one
MATRICES = ("chem_master1", "memplus")


def learn(device):
    """The off-line phase (once per machine): learn D* from a benchmark
    suite, timing the kernel tier."""
    from repro_torch.kernels import ops
    suite = paper_suite(scale=0.02, skip_ell_overflow=True, device=device)
    db = offline_phase(suite, formats=("ell_row", "sell", "coo_row"),
                       c=1.0, machine=f"quickstart-{device.type}", iters=2,
                       spmv_impls=ops.KERNEL_SPMV_IMPLS, device=device)
    print("learned D* per format:", {k: round(v, 3)
                                     for k, v in db.d_star.items()})
    return db


def plan_and_serve(db, device, names=MATRICES):
    """The on-line phase (every library call): D_mat -> plan -> bind, then
    y = P @ 1 through the plan's JSON round trip.  Returns, per matrix,
    its statistics, the plan and ``y``."""
    planner = Planner(db=db, tier="kernel", device=device)
    out = {}
    for name in names:
        spec = next(s for s in TABLE1 if s.name == name)
        A = synthesize(spec, scale=0.05, device=device)
        stats = MatrixStats.of(A)
        plan = planner.plan(A, rule="paper")       # transforms if profitable
        print(f"{name}: D_mat={stats.d_mat:.3f}  D*={plan.d_star:.3f}"
              f"  -> {plan.fmt}")

        # the plan is a portable JSON artifact: save it, reload it anywhere,
        # bind it to the matrix, and serve SpMV (and SpMM) via `@`
        plan2 = ExecutionPlan.from_json(plan.to_json())
        P = plan2.bind(A, device=device)
        x = torch.ones((A.n_cols,), dtype=torch.float32, device=device)
        y = P @ x
        print(f"  SpMV ok: ||y||={float(torch.linalg.norm(y)):.3f} "
              f"(format={P.fmt}, rule={plan2.rule})")
        out[name] = {"A": A, "stats": stats, "plan": plan2, "y": y}
    return out


def serve(device):
    """Serving (register once, query many).  Every query runs through a
    guarded degradation ladder (tuned -> reference -> CSR), so a broken or
    fault-injected tuned tier degrades instead of failing — see
    docs/robustness.md (REPRO_FAULTS exercises it)."""
    from repro_torch.serve import SpMVService

    svc = SpMVService(max_batch=4, device=device)
    A = synthesize(next(s for s in TABLE1 if s.name == "chem_master1"),
                   scale=0.05, device=device)
    svc.register("demo", A, expected_iterations=50, measure_baseline=False)
    x = torch.ones((A.n_cols,), dtype=torch.float32, device=device)
    y = svc.spmv("demo", x)
    futs = [svc.submit("demo", x) for _ in range(3)]
    svc.flush()
    ys = [f.result() for f in futs]
    st = svc.stats()["demo"]
    g = st["guard"]["spmv"]
    print(f"service ok: ||y||={float(torch.linalg.norm(y)):.3f} "
          f"served_by={g['served_by']} breaker={g['breaker']['state']}")
    return {"y": y, "flushed": ys, "stats": st}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    db = learn(device)
    served = plan_and_serve(db, device)
    svc = serve(device)
    return {"d_star": db.d_star,
            "plans": {k: {"d_mat": v["stats"].d_mat, "fmt": v["plan"].fmt,
                          "norm_y": float(torch.linalg.norm(v["y"]))}
                      for k, v in served.items()},
            "service_served_by": svc["stats"]["guard"]["spmv"]["served_by"]}


if __name__ == "__main__":
    main()
