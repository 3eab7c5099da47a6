"""One run of one cell: find its parts by name, set up, measure a window,
check the outputs against the reference, and build the result line."""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import random
import statistics
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from . import trace as _trace
from .program import Program

#: top-level module names that may not be loaded when the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Context:
    """What a driver is given: the cell's configuration and traffic, the
    benchmark's matrix, the seed, the device, the system under test
    (``program``: the port, or the control in its place), the clock and
    the range marker."""

    def __init__(self, cell, config, traffic, matrix, seed, device,
                 program=None):
        self.cell = cell
        self.config = config
        self.traffic = traffic
        self.matrix = matrix
        self.seed = int(seed)
        self.device = device
        self.program = program if program is not None else Program(device)
        self.mark: Callable = _trace.no_mark

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self) -> float:
        """Host seconds, read once the card has finished what was
        enqueued."""
        self.sync()
        return time.perf_counter()


class Keep:
    """A uniform sample of ``k`` of a window's units, drawn from the seed
    (reservoir sampling), so the check's cost does not grow with the
    window."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = random.Random(int(seed) * 1_000_003 + 17)
        self.items: list = []
        self.seen = 0

    def offer(self, make: Callable[[], Any]) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = make()


def load_cell(root: Path, workload: str):
    """``(bench, cell, config entry, config, traffic)`` for ``workload``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; one of "
                       f"{sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (root / "spmvbench" / "traffic" / f"{cell['traffic']}.json")
        .read_text())
    return bench, cell, entry, config, traffic


def load_limits(root: Path, workload: str) -> Dict[str, float]:
    """The limit of each number ``correct`` compares in ``workload``
    (``spmvbench/limits/<workload>.json``), set from that cell's own
    readings."""
    return {k: float(v) for k, v in json.loads(
        (root / "spmvbench" / "limits" / f"{workload}.json").read_text())
        .items()}


def metrics_for(bench, workload: str, kind: str):
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``)."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(root: Path, name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = root / "spmvbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "spmvbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(device: torch.device, count: int) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


class GcClock:
    """The time Python's garbage collector spends inside a window (read
    from ``gc.callbacks``), so that a run can say whether collections
    stand behind a spread."""

    def __init__(self):
        self.n = 0
        self.s = 0.0
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.n += 1
            self.s += time.perf_counter() - self._t
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)
        return False


class Cell:
    """One cell set up on the device: its parts, the matrix, the context
    and the driver, after the driver's set-up (the warm-up included)."""

    def __init__(self, root: Path, workload: str, seed: int,
                 device: torch.device, program=None, matrix=None, log=print):
        self.root, self.workload = root, workload
        self.bench, self.cell, _, self.config, self.traffic = load_cell(
            root, workload)
        if matrix is None:
            gen = importlib.import_module(
                f"spmvbench.generators.{self.config['generator']}")
            matrix = gen.build(self.config, seed, device)
            lens = matrix.row_lengths().double()
            log(f"matrix: n={matrix.n_rows} nnz={matrix.nnz} "
                f"max_row={int(lens.max())} "
                f"empty_rows={int((lens == 0).sum())} "
                f"mu={float(lens.mean()):.4f} "
                f"sigma={float(lens.std(correction=0)):.4f}")
        self.matrix = matrix
        self.ctx = Context(self.cell, self.config, self.traffic, matrix,
                           seed, device, program)
        self.drv = importlib.import_module(
            f"spmvbench.drivers.{self.traffic['driver']}").Driver(self.ctx)
        self.drv.setup()

    def measure(self, seconds: float, units_cap: int = 0):
        """Units back to back until ``seconds`` have passed (or
        ``units_cap`` units), closing at a unit's boundary; returns the
        window's seconds and each unit's."""
        ctx, drv = self.ctx, self.drv
        t0 = t1 = ctx.now()
        unit_s = []
        while True:
            drv.unit()
            t_prev, t1 = t1, ctx.now()
            unit_s.append(t1 - t_prev)
            if t1 - t0 >= seconds or (units_cap and drv.units >= units_cap):
                break
        return t1 - t0, unit_s

    def judge(self):
        """Each compared number beside its limit, and whether all hold (no
        unit failed, every number finite and within its limit)."""
        numbers = self.drv.check()
        checks = {k: (numbers[k], lim) for k, lim in
                  load_limits(self.root, self.workload).items()}
        correct = (self.drv.failed == 0 and all(
            math.isfinite(v) and v <= lim for v, lim in checks.values()))
        return checks, correct


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, log=print, program=None
        ) -> Optional[Dict[str, Any]]:
    """One run; returns the result line's object, or ``None`` when a
    forbidden module was loaded (named on standard error).  ``program``
    replaces the port (the tests' planted faults and control)."""
    from repro_torch import obs
    # the program's telemetry is on in the traced run only, whatever the
    # environment says
    obs.set_default(obs.Telemetry(enabled=False))
    if device.type == "cuda":
        from repro_torch.kernels.build import build_all
        build_all()
    c = Cell(root, workload, seed, device, program, log=log)
    bench, cell, traffic, drv = c.bench, c.cell, c.traffic, c.drv
    log(f"plan: {drv.plan_line}")
    t_open = c.ctx.now()
    setup_s = t_open - t_start
    # what set-up left behind is kept out of the window's collections
    gc.collect()
    gc.freeze()

    units_cap = int(traffic.get("trace_units", 0)) if trace else 0
    tracer = _trace.Tracer(device) if trace else None
    if trace:
        tel = obs.Telemetry(enabled=True)
        obs.set_default(tel)
        c.ctx.mark = _trace.mark
        tracer.__enter__()
        window_range = _trace.mark("window")
        window_range.__enter__()
    with GcClock() as gcc:
        window_s, unit_s = c.measure(seconds, units_cap)
    gc.unfreeze()
    if trace:
        window_range.__exit__(None, None, None)
        tracer.__exit__(None, None, None)
        obs.set_default(obs.Telemetry(enabled=False))
        view = tracer.view()
        for sp in tel.spans:
            view.spans.setdefault(sp.name, []).append(sp.dur)
        drv.describe(view)
    q = statistics.quantiles(unit_s, n=10) if len(unit_s) > 1 else unit_s * 9
    log(f"window: {len(unit_s)} units in {window_s:.3f} s; a unit's ms "
        f"p10 {q[0] * 1e3:.3f} p50 {statistics.median(unit_s) * 1e3:.3f} "
        f"p90 {q[8] * 1e3:.3f} max {max(unit_s) * 1e3:.3f}; "
        f"gc {gcc.n} collections, {gcc.s * 1e3:.3f} ms")
    if getattr(drv, "window_plans", None):
        log(f"plans in the window: {drv.window_plans}")

    dev = device_info(device, int(cell.get("chips", 1)))
    e2e = drv.end_to_end(window_s, setup_s)
    drv.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, correct = c.judge()

    metrics: Dict[str, Dict[str, Any]] = {}
    if trace:
        for m in metrics_for(bench, workload, "per_layer"):
            v = load_reader(root, m["name"])(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = view.busy_s
        dev["window_s"] = view.window_s
        limit = power_limit()
        if limit:
            log(f"card: {limit}")
        log(f"trace: {len(view.ops)} device ops, {view.unmatched} not "
            f"matched to a launch")
    else:
        for m in metrics_for(bench, workload, "end_to_end"):
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    result: Dict[str, Any] = {
        "correct": bool(correct), "attempted": int(drv.attempted),
        "failed": int(drv.failed), "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": view.device_ops,
                               "idle_gaps": view.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return None
    return result
