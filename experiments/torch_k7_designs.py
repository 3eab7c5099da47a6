#!/usr/bin/env python3
"""K7 ``ccs_spmv`` as it stands against the designs it was chosen over, on
one CUDA card.

``src/repro_torch/kernels/csrc/ccs_spmv.cu`` adds the entries of a pass that
fall inside a warp's window between two marks, ``// window store: begin``
and ``// window store: end``.  This script builds that source as it stands
and with one change each (one ``nvcc`` a design, all started together, with
``-Xptxas -v`` so that each kernel's registers and spills are printed), and
calls each through the same C entry at the wrapper's default launch:

* ``kept``: the source as it stands (four windows a warp, one per column
  mod 4; a one-shuffle check that rows rise within a column; the
  ``__match_any_sync`` path only on a pass that fails it);
* ``bounds1024``: the same, declared ``__launch_bounds__(1024)``, which
  caps a thread at 64 registers (the kernel never runs more than 256);
* ``match``: ``__match_any_sync`` and the shuffle tree on every pass;
* ``shared_atomic``: a shared-memory float ``atomicAdd`` into the warp's
  first window (a compare-and-swap loop on this card), no check;
* ``unguarded``: a plain read-add-write with no collision handling.  It is
  wrong wherever two lanes of a pass share a window slot, which is every
  band: its error is printed, not checked.  It is the floor of the walk.

Matrices: xenon2 at ``scale=4.0``, viscoplastic2 at ``scale=16.0`` and
torso1 (``core/suite.py``), float32.  Each design is timed 20 times (device
time of one call, ``core.autotune.time_device``) in two turns, the designs
in order and then reversed, beside the library call
(``torch.sparse_csr_tensor @ x``), and held against ``ccs_spmv_plain``
within 1e-4 of sum |a * x| (``unguarded`` excepted).

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_k7_designs.py [--out FILE]

It prints each design's ptxas resource line, one line per case (median ms
of each turn, the mean of the two, the error), the card's name and power
limit, and writes every time to ``--out`` (default
``build/k7_designs.json``, git-ignored).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

REPS = 20
KERNEL_REL_TOL = 1e-4
BEGIN, END = "      // window store: begin\n", "      // window store: end\n"
BOUNDS = "__launch_bounds__(CCS_SPMV_MAX_THREADS)"

#: the window store of each other design (``w``, ``inside``, ``sum``,
#: ``j``, ``lane``, ``win``, ``touched`` and ``window`` are the kernel's)
STORES = {
    "match": """\
      const int w = r - base;
      const bool inside = live && (unsigned)w < (unsigned)window;
      const unsigned peers = __match_any_sync(
          FULL, inside ? (j % CCS_WINDOWS) * window + w : -1 - lane);
      const unsigned below = (1u << lane) - 1u;
      unsigned above = peers & ~below & ~(1u << lane);
      unsigned rank = __popc(peers & below);
      const bool lead = inside && rank == 0;
      float total = sum;
      while (__any_sync(FULL, above)) {
        const int next = __ffs(above);
        const float t = __shfl_sync(FULL, total, (next - 1) & 31);
        if (next) total += t;
        above &= ~__ballot_sync(FULL, rank & 1u);
        rank >>= 1;
      }
      if (lead) {
        win[(j % CCS_WINDOWS) * window + w] += total;
        touched[w] = 1;
      }
""",
    "shared_atomic": """\
      const int w = r - base;
      const bool inside = live && (unsigned)w < (unsigned)window;
      if (inside) {
        atomicAdd(win + w, sum);
        touched[w] = 1;
      }
""",
    "unguarded": """\
      const int w = r - base;
      const bool inside = live && (unsigned)w < (unsigned)window;
      if (inside) {
        win[(j % CCS_WINDOWS) * window + w] += sum;
        touched[w] = 1;
      }
""",
}
DESIGNS = ("kept", "bounds1024", "match", "shared_atomic", "unguarded")


def design_source(name: str, source: str) -> str:
    """``ccs_spmv.cu`` with design ``name``'s change."""
    if name == "kept":
        return source
    if name == "bounds1024":
        assert source.count(BOUNDS) == 1, "launch bounds not found"
        return source.replace(BOUNDS, "__launch_bounds__(1024)")
    head, sep, rest = source.partition(BEGIN)
    _, sep2, tail = rest.partition(END)
    assert sep and sep2, "window store marks not found"
    return head + STORES[name] + tail


def ptxas_usage(log: str) -> str:
    """The spill and register lines ptxas printed for the float32/float32
    instance of the kernel."""
    block = log.split("Compiling entry function")
    mine = next((b for b in block[1:] if "ccs_spmv_warpsIffEv" in
                 b.splitlines()[0]), "")
    return " | ".join(re.sub(r"\s+", " ", line.split(":", 1)[-1]).strip()
                      for line in mine.splitlines()
                      if "spill" in line or "Used" in line)


def build_designs(out_dir: Path) -> dict:
    """``{design: (C entry, ptxas line)}``, one ``nvcc`` a design."""
    from repro_torch.kernels import build

    source = (build.CSRC / "ccs_spmv.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in DESIGNS:
        cu = out_dir / f"ccs_spmv_{name}.cu"
        cu.write_text(design_source(name, source))
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on design {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), "ccs_spmv_launch")
        fn.argtypes = list(build.SIGNATURES["ccs_spmv"])
        fn.restype = ctypes.c_int
        entries[name] = (fn, ptxas_usage(log))
    return entries


def times_of(fn):
    """``REPS`` device times of one call, in ms, after warm-up."""
    import torch

    from repro_torch.core.autotune import time_device
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return [time_device(fn) * 1e3 for _ in range(REPS)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="where to write every time")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_k7_designs: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import suite
    from repro_torch.core import transform as T
    from repro_torch.kernels import ccs_spmv as K7
    from repro_torch.kernels._common import ccs_spmv_launch

    entries = build_designs(ROOT / "build" / "k7_designs")
    for name, (_, usage) in entries.items():
        print(f"ptxas {name}: {usage}", flush=True)
    specs = {s.name: s for s in suite.TABLE1}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for mat, scale in (("xenon2", 4.0), ("viscoplastic2", 16.0),
                       ("torso1", 1.0)):
        csr = suite.synthesize(specs[mat], scale=scale, device="cpu")
        m = T.host_csr_to_ccs(csr).to(dev)
        x = torch.from_numpy(np.random.default_rng(7).normal(
            size=m.n_cols).astype(np.float32)).to(dev)
        want = K7.ccs_spmv_plain(m.data, m.rows, m.indptr, x, m.n_rows)
        mag = K7.ccs_spmv_plain(m.data.abs(), m.rows, m.indptr, x.abs(),
                                m.n_rows)
        threads, _, per_warp, window = ccs_spmv_launch(
            m.n_rows, m.n_cols, m.data.shape[0])
        label = mat if scale == 1.0 else f"{mat}@x{scale:g}"

        def call(fn):
            y = torch.zeros(m.n_rows, device=dev)
            code = fn(m.data.data_ptr(), m.rows.data_ptr(),
                      m.indptr.data_ptr(), x.data_ptr(), y.data_ptr(),
                      m.n_rows, m.n_cols, threads, per_warp, window, 0, 0,
                      stream)
            if code:
                raise RuntimeError(f"ccs_spmv launch failed: {code}")
            return y

        errs = {}
        for name, (fn, _) in entries.items():
            errs[name] = float(((call(fn) - want).abs()
                                / (mag + 1e-30)).max())
            if name != "unguarded" and errs[name] > KERNEL_REL_TOL:
                raise AssertionError(f"{label} {name}: rel err {errs[name]}")
        turns = {name: [] for name in entries}
        for order in (DESIGNS, DESIGNS[::-1]):
            for name in order:
                turns[name].append(times_of(
                    lambda fn=entries[name][0]: call(fn)))
        mc = csr.to(dev)
        lib = torch.sparse_csr_tensor(mc.indptr, mc.cols[:mc.nnz],
                                      mc.data[:mc.nnz], size=mc.shape)
        lib_ms = statistics.median(times_of(lambda: lib @ x))
        for name in DESIGNS:
            med = [statistics.median(t) for t in turns[name]]
            cases.append({"matrix": label, "design": name, "ms": turns[name],
                          "max_rel_err": errs[name], "library_ms": lib_ms})
            print(f"{label},{name},{med[0]:.4f}/{med[1]:.4f},"
                  f"{sum(med) / 2:.4f},err {errs[name]:.2e},"
                  f"library {lib_ms:.4f}", flush=True)
        del m, mc, want, mag, lib, csr
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    out = args.out or ROOT / "build" / "k7_designs.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "cases": cases,
                               "ptxas": {n: u for n, (_, u)
                                         in entries.items()}}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
