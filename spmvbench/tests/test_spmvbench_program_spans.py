"""The readers of the port's own spans (``metrics/<name>.py`` with
``source: program_span``) on synthetic views: each takes its span's
durations and the driver's counts, and finds nothing where the span is
absent or the window has no device trace (a run on the host)."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT
from spmvbench import harness
from spmvbench.trace import DeviceOp, View

#: reader -> (span it reads, how it reduces: "per_unit", "per_flush" or
#: "mean"), as BENCHMARK.json's nine program-span metrics of the port
READERS = {
    "copy_out_ms.job": ("transform.copy_out", "per_unit"),
    "upload_ms.job": ("bind.upload", "per_unit"),
    "prepare_ms.job": ("bind.prepare", "per_unit"),
    "enqueue_ms.set": ("matrix.spmv", "mean"),
    "enqueue_ms.pr": ("matrix.spmv", "mean"),
    "stack_ms.serve": ("service.stack", "per_flush"),
    "blocks_ms.serve": ("hybrid.block", "per_flush"),
    "probe_ms.serve": ("guard.probe", "per_flush"),
    "unstack_ms.serve": ("service.unstack", "per_flush"),
}
DURS = [0.004, 0.001, 0.0025]          # seconds, as the program records
OP = DeviceOp("k", "kernel", 0.0, 1.0, frozenset())


def view(spans, ops=True, units=2, flushes=2):
    return View(spans=spans, ops=[OP] if ops else [],
                counts={"units": units, "flushes": flushes})


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reduces_its_span(name):
    span, how = READERS[name]
    read = harness.load_reader(ROOT, name)
    got = read(view({span: list(DURS), "other": [9.0]}))
    want = {"per_unit": sum(DURS) / 2, "per_flush": sum(DURS) / 2,
            "mean": sum(DURS) / len(DURS)}[how] * 1e3
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_finds_nothing_without_its_span_or_the_card(name):
    span, how = READERS[name]
    read = harness.load_reader(ROOT, name)
    assert read(view({})) is None
    assert read(view({"other": list(DURS)})) is None
    assert read(view({span: list(DURS)}, ops=False)) is None
    if how != "mean":
        assert read(view({span: list(DURS)}, units=0, flushes=0)) is None


def test_benchmark_names_the_program_span_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = layer[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert len(m["workloads"]) == 1
