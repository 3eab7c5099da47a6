"""Summarize the port's dry-run records (``python -m
repro_torch.launch.dryrun``, then ``--analysis``) as the tables of
``PERF.md``: every cell's status, and for each ok cell of one mesh its
per-device FLOPs traced and in closed form, traced bytes, collective bytes
(in all, and on the ``model`` axis and the batch axes ``data``/``pod``),
the ``model`` axis's by op (all-gather, all-reduce, reduce-scatter), peak
memory, whether it fits one H100's 80 GB, the bottleneck and the
useful ratio.

    python3 experiments/torch_dryrun_table.py [--dir experiments/dryrun_torch]
        [--mesh 16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from collections import Counter


def load(directory: str) -> list:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def table(recs: list, mesh: str) -> str:
    rows = ["| arch | shape | FLOPs/dev traced | closed form | traced / "
            "closed | traced bytes/dev | collective bytes/dev | on model | "
            "model AG / AR / RS | on data, pod | peak GB | fits_80gb | "
            "bottleneck | useful_ratio | trace s |",
            "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r["mesh"] != mesh or r["status"] != "ok":
            continue
        rl, mem = r["roofline"], r["memory"]
        closed = r.get("analytic", {}).get("flops_dev")
        by_axis = {}
        for per_op in rl.get("collectives_by_axis", {}).values():
            for axis, n in per_op.items():
                by_axis[axis] = by_axis.get(axis, 0) + n
        batch = by_axis.get("data", 0) + by_axis.get("pod", 0)
        ops = rl.get("collectives_by_axis", {})
        model_ops = " / ".join(f"{ops.get(op, {}).get('model', 0):.2e}"
                               for op in ("all_gather", "all_reduce",
                                          "reduce_scatter"))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rl['traced_flops']:.3e} | "
            f"{f'{closed:.3e}' if closed else '—'} | "
            f"{f'{rl['traced_flops'] / closed:.2f}' if closed else '—'} | "
            f"{rl['traced_bytes']:.3e} | {rl['collective_bytes']:.3e} | "
            f"{by_axis.get('model', 0):.3e} | {model_ops} | {batch:.3e} | "
            f"{mem['peak_bytes'] / 1e9:.1f} | {mem['fits_80gb']} | "
            f"{rl['bottleneck']} | {rl['useful_ratio']:.3f} | "
            f"{r['timings']['trace_s']:.0f} |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    recs = load(args.dir)
    print(f"{len(recs)} records:", dict(Counter(r["status"] for r in recs)))
    for r in recs:
        if r["status"] == "error":
            print(f"  error {r['arch']} x {r['shape']} x {r['mesh']}: "
                  f"{r['error'][:160]}")
    print(table(recs, args.mesh))


if __name__ == "__main__":
    main()
