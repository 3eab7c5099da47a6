"""The harness on the CPU at a test size: every cell runs through the
port's plain kernels and comes out correct, and new configurations,
traffic and metric readers are taken as files."""
from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT
from spmvbench import harness

CPU = torch.device("cpu")
CELLS = {"hpcg256.cg50": {"set_ms"}, "kron23.pr20": {"pr_set_ms"},
         "hpcg128.rebind": {"job_ms"},
         "kron23.serve32": {"vectors_per_s", "vector_p95_ms"}}
#: the per-layer metrics a CPU run can read (host clocks and the program's
#: spans; device metrics need the card's trace)
HOST_LAYER = {"hpcg128.rebind": {"plan_ms.job", "bind_ms.job",
                                 "transform_ms.job"},
              "kron23.serve32": {"flush_ms.serve"}}


def run(root, workload, trace, seed=2 ** 31 + 77, seconds=0.2):
    return harness.run(root, workload, seed, seconds, trace, CPU,
                       time.perf_counter(), log=lambda s: None)


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_cpu(tiny_root, workload, trace):
    r = run(tiny_root, workload, trace)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert 0.0 <= c["value"] <= c["limit"]
    if trace:
        assert set(r["metrics"]) == HOST_LAYER.get(workload, set())
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert r["device"]["window_s"] > 0
    else:
        assert set(r["metrics"]) == CELLS[workload] | {"setup_s"}
        assert all(m["value"] > 0 for m in r["metrics"].values())


def test_same_seed_same_inputs(tiny_root):
    a = run(tiny_root, "kron23.pr20", False, seed=5)
    b = run(tiny_root, "kron23.pr20", False, seed=5)
    assert a["checks"] == b["checks"]


def test_benchmark_file_names_its_parts():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        harness.load_cell(ROOT, w["name"])
        e2e = {m["name"] for m in harness.metrics_for(bench, w["name"],
                                                      "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.metrics_for(bench, w["name"], "per_layer")
        assert layer and all(m["moves"] in e2e for m in layer)
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(ROOT, m["name"]))


def test_new_parts_are_files(tiny_root):
    """A configuration, a traffic mix, a cell's limits and a metric reader
    added as files, with no edit to any file the benchmark has."""
    sb = tiny_root / "spmvbench"
    (sb / "configs" / "hpcg-27pt-6.json").write_text(json.dumps(
        {"generator": "stencil27", "nx": 6, "ny": 6, "nz": 6,
         "diagonal": 26.0, "off_diagonal": -1.0}))
    (sb / "traffic" / "cg5.json").write_text(json.dumps(
        {"driver": "sets", "method": "cg", "iterations": 5, "rhs_pool": 2,
         "check_sets": 1, "trace_units": 3, "reports": "set_ms"}))
    (sb / "limits" / "hpcg6.cg5.json").write_text(json.dumps(
        {"x_gap": 1e-4, "r_gap": 1e-4}))
    (sb / "metrics" / "products_seen.set.py").write_text(
        "def read(view):\n    return view.counts.get('products')\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "hpcg-27pt-6", "source": "test",
                             "file": "spmvbench/configs/hpcg-27pt-6.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "hpcg6.cg5", "config": "hpcg-27pt-6",
                               "traffic": "cg5", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("hpcg6.cg5")
    bench["per_layer"].append({"name": "products_seen.set",
                               "unit": "products", "better": "higher",
                               "source": "program_counter", "layer": "entry",
                               "moves": "set_ms",
                               "workloads": ["hpcg6.cg5"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(tiny_root, "hpcg6.cg5", True, seconds=300)   # 3 traced sets
    assert r["correct"]
    assert r["metrics"] == {"products_seen.set": {"value": 15,
                                                  "unit": "products"}}
    r = run(tiny_root, "hpcg6.cg5", False)
    assert set(r["metrics"]) == {"set_ms", "setup_s"}


def test_reader_that_finds_nothing_is_left_out(tiny_root):
    (tiny_root / "spmvbench" / "metrics" / "flush_ms.serve.py").write_text(
        "def read(view):\n    return None\n")
    r = run(tiny_root, "kron23.serve32", True)
    assert "flush_ms.serve" not in r["metrics"]


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "spmvbench.run", "--workload",
         "hpcg256.cg50", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0
    assert not out.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_cell_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "spmvbench.run", "--workload", workload,
         "--seed", "4294967311", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
