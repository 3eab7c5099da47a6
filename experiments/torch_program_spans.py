#!/usr/bin/env python3
"""The port's spans on the card, cell by cell of ``BENCHMARK.json``: what
telemetry costs, what the spans read, and where the card waits.

For each cell it sets the cell up once (``spmvbench.harness.Cell``:
inputs from the seed, plan, bind or register, one warm-up unit), then

1. measures windows of ``--seconds`` with the program's telemetry off and
   on, in turns (off, on, on, off, ... ``--turns`` of each), and prints each
   window's mean and median unit in ms (a set, a job or a flush) and the
   on/off ratio of the medians of the windows' means;
2. traces the cell's ``trace_units`` units as the benchmark's traced run
   does (``torch.profiler``, the program's telemetry on), prints every
   per-layer metric of the cell as its reader gives it, and writes the
   profiler's Chrome trace, gzipped, to ``--out``;
3. from that trace, sums the window's idle time on the card by the
   innermost program range (a span's ``record_function`` range) the host
   was in at the gap's middle, else by the benchmark's own range
   (``bench.*``), and the card's busy time by the innermost program range
   the host was in when it launched the work.

One JSON object a cell goes to standard output and to
``<out>/<cell>.json``; then the card's name and power limit.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_program_spans.py [--cells hpcg128.rebind,...]
        [--seconds 10] [--turns 2] [--seed 2147483723]
        [--out experiments/program_spans]
"""
from __future__ import annotations

import argparse
import bisect
import gc
import gzip
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from spmvbench import harness  # noqa: E402
from spmvbench import trace as _trace  # noqa: E402

DEVICE_CATS = _trace.DEVICE_CATS
LAUNCH_CATS = _trace.LAUNCH_CATS


def index_of(ranges):
    """``name -> (sorted starts, ends)`` of ranges ``(name, ts, end)``."""
    by = defaultdict(list)
    for name, s, e in ranges:
        by[name].append((s, e))
    return {k: ([s for s, _ in sorted(v)], [e for _, e in sorted(v)])
            for k, v in by.items()}


def innermost(index, ts):
    """The range holding ``ts`` that started last, or ``None``."""
    best, best_start = None, None
    for name, (starts, ends) in index.items():
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ends[i] and (best_start is None
                                          or starts[i] > best_start):
            best, best_start = name, starts[i]
    return best


def by_program_range(events):
    """The window's idle seconds by the innermost program range at the
    gap's middle, and its busy seconds by the innermost program range at
    each operation's launch (``bench.<name>`` where no program range was
    open, ``host`` where neither was)."""
    xs = [e for e in events if e.get("ph") == "X"]
    ann = [e for e in xs if e.get("cat") in ("user_annotation", "cpu_op")
           and str(e.get("name", "")).startswith(_trace.PREFIX)]
    win = [e for e in ann if e["name"] == _trace.PREFIX + "window"]
    if not win:
        return {}, {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    bench = index_of((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                     for e in ann if e is not win[0])
    prog = index_of((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                    for e in xs if e.get("cat") == "user_annotation"
                    and not str(e.get("name", "")).startswith(
                        _trace.PREFIX))

    def label(ts):
        return innermost(prog, ts) or innermost(bench, ts) or "host"

    launch = {}
    for e in xs:
        args = e.get("args") or {}
        if e.get("cat") in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = float(e["ts"])
    ops = sorted((float(e["ts"]), float(e.get("dur", 0.0)),
                  launch.get((e.get("args") or {}).get("correlation")))
                 for e in xs if e.get("cat") in DEVICE_CATS)
    idle, busy = defaultdict(float), defaultdict(float)
    cur = w0
    for s, d, at in ops:
        t = s + d
        if t < w0 or s > w1:
            continue
        busy[label(at) if at is not None else "not matched"] += d * 1e-6
        s, t = max(s, w0), min(t, w1)
        if t <= cur:
            continue
        if s > cur:
            idle[label((cur + s) / 2)] += (s - cur) * 1e-6
            cur = s
        cur = t
    if w1 > cur:
        idle[label((cur + w1) / 2)] += (w1 - cur) * 1e-6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])]

    return ranked(idle), ranked(busy)


def turns(c, seconds, n):
    """Windows of ``seconds`` with telemetry off and on, in turns."""
    out = {"off": [], "on": []}
    order = []
    for i in range(n):
        order += ["off", "on"] if i % 2 == 0 else ["on", "off"]
    for side in order:
        obs.set_default(obs.Telemetry(enabled=side == "on"))
        gc.collect()
        _, unit_s = c.measure(seconds)
        out[side].append({"mean_ms": statistics.fmean(unit_s) * 1e3,
                          "median_ms": statistics.median(unit_s) * 1e3,
                          "units": len(unit_s)})
    obs.set_default(obs.Telemetry(enabled=False))
    return out


def traced(c, out_dir: Path):
    """The cell's traced window as the benchmark takes it; its metrics,
    the gap tables and the trace written to ``out_dir``."""
    drv = c.drv
    drv.draw()                       # the window's counters from zero
    tel = obs.Telemetry(enabled=True)
    obs.set_default(tel)
    c.ctx.mark = _trace.mark
    tracer = _trace.Tracer(c.ctx.device)
    with tracer:
        with _trace.mark("window"):
            c.measure(3600.0, int(c.traffic.get("trace_units", 0)))
    obs.set_default(obs.Telemetry(enabled=False))
    c.ctx.mark = _trace.no_mark
    view = tracer.view()
    for sp in tel.spans:
        view.spans.setdefault(sp.name, []).append(sp.dur)
    drv.describe(view)
    metrics = {}
    for m in harness.metrics_for(c.bench, c.workload, "per_layer"):
        v = harness.load_reader(ROOT, m["name"])(view)
        if v is not None:
            metrics[m["name"]] = v
    idle, busy = by_program_range(tracer.events)
    with gzip.open(out_dir / f"{c.workload}.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": tracer.events}, f)
    counts = {k: len(v) for k, v in view.spans.items()}
    return {"metrics": metrics, "counts": dict(view.counts),
            "spans": counts, "window_s": view.window_s,
            "busy_s": view.busy_s, "unmatched": view.unmatched,
            "idle_by_range": idle, "busy_by_range": busy}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    ap.add_argument("--cells", default=",".join(
        w["name"] for w in bench["workloads"]))
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 75)
    ap.add_argument("--out", default="experiments/program_spans")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    from repro_torch.kernels.build import build_all
    build_all()
    obs.set_default(obs.Telemetry(enabled=False))
    for name in args.cells.split(","):
        t0 = time.perf_counter()
        c = harness.Cell(ROOT, name, args.seed, dev,
                         log=lambda s: print(f"{name}: {s}", file=sys.stderr))
        setup_s = time.perf_counter() - t0
        rec = {"cell": name, "seed": args.seed, "setup_s": setup_s,
               "plan": c.drv.plan_line,
               "turns": turns(c, args.seconds, args.turns)}
        med = {k: statistics.median(r["mean_ms"] for r in v)
               for k, v in rec["turns"].items()}
        rec["on_over_off"] = med["on"] / med["off"]
        rec["traced"] = traced(c, out_dir)
        c.drv.release()
        del c
        gc.collect()
        torch.cuda.empty_cache()
        line = json.dumps(rec)
        (out_dir / f"{name}.json").write_text(line + "\n")
        print(line, flush=True)
    print(f"card: {harness.power_limit()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
