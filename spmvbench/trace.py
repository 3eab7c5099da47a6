"""The traced run: ``torch.profiler`` over the traced window, reduced to a
:class:`View` that the per-layer readers (``metrics/<name>.py``) take
their numbers from.

The benchmark's own spans are ``record_function`` ranges named
``bench.<name>`` around its calls into each layer (``bench.window`` around
the whole traced window).  A device operation belongs to a range when the
host launched it inside that range: the kernel's launch is found through
the trace's correlation id (a runtime or driver API call), else through
its external id (the CPU op or range it was launched under)."""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def mark(name: str):
    """The benchmark's range around one call into a layer."""
    return torch.profiler.record_function(PREFIX + name)


def no_mark(name: str):
    return contextlib.nullcontext()


@dataclass
class DeviceOp:
    name: str
    cat: str
    ts: float            # microseconds, the trace's clock
    dur: float           # microseconds
    ranges: frozenset    # the benchmark ranges it was launched inside


@dataclass
class View:
    """What a traced window holds, for the per-layer readers.

    ``host``: the benchmark's host-clock spans (seconds) by name, each
    taken after a synchronize; ``spans``: the program's own telemetry
    spans (seconds) by name; ``counts``: units, iterations, products,
    flushes and vectors the window completed; ``info``: what the driver
    states about the work (``product_bytes`` of one product, ...)."""
    window_s: float = 0.0
    busy_s: float = 0.0
    ops: List[DeviceOp] = field(default_factory=list)
    host: Dict[str, List[float]] = field(default_factory=dict)
    spans: Dict[str, List[float]] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    info: Dict[str, float] = field(default_factory=dict)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)
    unmatched: int = 0

    def kernels(self, range_name: Optional[str] = None) -> List[DeviceOp]:
        return [o for o in self.ops if o.cat == "kernel"
                and (range_name is None or range_name in o.ranges)]

    def device_s(self, range_name: str) -> float:
        """Device seconds of the kernels launched inside ``range_name``."""
        return sum(o.dur for o in self.kernels(range_name)) * 1e-6

    def idle_pct(self) -> Optional[float]:
        if self.window_s <= 0 or not self.ops:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)


class Tracer:
    """``with Tracer(device) as t: ...`` profiles the block; ``t.view()``
    reduces what it recorded."""

    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.events: list = []

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return False

    def view(self) -> View:
        return reduce_events(self.events)


def _range_index(ranges):
    """name -> (sorted starts, ends) of the benchmark's ranges."""
    by: Dict[str, list] = defaultdict(list)
    for e in ranges:
        by[e["name"][len(PREFIX):]].append((e["ts"], e["ts"] + e["dur"]))
    return {k: ([s for s, _ in sorted(v)], [t for _, t in sorted(v)])
            for k, v in by.items()}


def _inside(index, name, ts) -> bool:
    starts, ends = index[name]
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ts <= ends[i]


def reduce_events(events) -> View:
    """Reduce a chrome trace's events to a :class:`View` of the window
    (``bench.window``)."""
    view = View()
    ranges = [e for e in events if e.get("ph") == "X"
              and str(e.get("name", "")).startswith(PREFIX)
              and e.get("cat") in ("user_annotation", "cpu_op")]
    windows = [e for e in ranges if e["name"] == PREFIX + "window"]
    if not windows:
        return view
    w = windows[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    view.window_s = (w1 - w0) * 1e-6
    index = _range_index([e for e in ranges if e is not w])
    launch = {}
    external = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args") or {}
        if e.get("cat") in LAUNCH_CATS and "correlation" in args:
            launch[args["correlation"]] = float(e["ts"])
        elif e.get("cat") in ("cpu_op", "user_annotation") \
                and "External id" in args:
            external.setdefault(args["External id"], float(e["ts"]))
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if ts + dur < w0 or ts > w1:
            continue
        args = e.get("args") or {}
        at = launch.get(args.get("correlation"))
        if at is None:
            at = external.get(args.get("External id"))
        if at is None:
            view.unmatched += 1
            names = frozenset()
        else:
            names = frozenset(n for n in index if _inside(index, n, at))
        view.ops.append(DeviceOp(str(e.get("name", "")), e["cat"], ts, dur,
                                 names))
    view.ops.sort(key=lambda o: o.ts)
    _busy_and_gaps(view, index, w0, w1)
    return view


def _busy_and_gaps(view: View, index, w0: float, w1: float) -> None:
    """Busy seconds (the union of device operations in the window), the
    operations that took most time, and the idle gaps by the benchmark
    range the host was inside at the gap's middle."""
    busy = 0.0
    gaps: Dict[str, float] = defaultdict(float)
    cur = w0
    for o in view.ops:
        s, t = max(o.ts, w0), min(o.ts + o.dur, w1)
        if t <= cur:
            continue
        if s > cur:
            gaps[_label(index, (cur + s) / 2)] += (s - cur) * 1e-6
            cur = s
        busy += t - cur
        cur = t
    if w1 > cur:
        gaps[_label(index, (cur + w1) / 2)] += (w1 - cur) * 1e-6
    view.busy_s = busy * 1e-6
    by_name: Dict[str, float] = defaultdict(float)
    for o in view.ops:
        by_name[o.name[:160]] += o.dur * 1e-6
    view.device_ops = [[k, v] for k, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:10]]
    view.idle_gaps = [[k, v] for k, v in sorted(
        gaps.items(), key=lambda kv: -kv[1])[:10]]


def _label(index, ts: float) -> str:
    """The innermost benchmark range holding host time ``ts`` (the one
    that started last), or ``host``."""
    best, best_start = "host", None
    for name, (starts, ends) in index.items():
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts <= ends[i] and (best_start is None
                                          or starts[i] > best_start):
            best, best_start = name, starts[i]
    return best
