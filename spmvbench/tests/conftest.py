"""Fixtures of the benchmark's CPU tests: a copy of the benchmark at a
test size in a temporary directory, and the card for the ``cuda`` ones."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: each configuration cut to a size a test run holds
TINY = {"hpcg-27pt-256": {"nx": 9, "ny": 8, "nz": 7},
        "hpcg-27pt-128": {"nx": 9, "ny": 8, "nz": 7},
        "gap-kron23": {"scale": 9}}
#: fewer iterations where CG would converge to rounding at the test size
TINY_TRAFFIC = {"cg50": {"iterations": 12}, "rebind": {"iterations": 12}}
#: a cell's limit where the test size reads otherwise than the cell's own:
#: 12 iterations leave ``hpcg128.rebind``'s residual at 2.6e-8 of max|b|
#: (the program, 12 seeds; the control 3.5e-4 and up), where 50 at the
#: cell's size leave it at 6.9e-14
TINY_LIMITS = {"hpcg128.rebind": {"r_gap": 1e-5}}


def make_root(dest: Path) -> Path:
    """The benchmark as committed, with its configurations at the test
    size, under ``dest``."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dest / "spmvbench").mkdir(parents=True, exist_ok=True)
    for sub in ("traffic", "metrics", "configs", "limits"):
        shutil.copytree(ROOT / "spmvbench" / sub, dest / "spmvbench" / sub,
                        dirs_exist_ok=True)
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(TINY.get(c["name"], {}))
        (dest / c["file"]).write_text(json.dumps(cfg))
    for name, over in TINY_TRAFFIC.items():
        p = dest / "spmvbench" / "traffic" / f"{name}.json"
        t = json.loads(p.read_text())
        t.update(over)
        p.write_text(json.dumps(t))
    for name, over in TINY_LIMITS.items():
        p = dest / "spmvbench" / "limits" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **over}))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the port's kernels have no CPU "
                    "build)")
    return torch.device("cuda", 0)
