#!/usr/bin/env python3
"""K5 ``csr_spmm`` as it stands against variants of its design, on one CUDA
card.

The script builds ``src/repro_torch/kernels/csrc/csr_spmm.cu`` as it stands
and with one change each (one ``nvcc`` a build, all started together, with
``-Xptxas -v`` so that each build's registers and spills are printed):

* ``kept``: the source as it stands (lane group g of a block takes its
  rows g, g + G, ...);
* ``balanced``: the block's entries are cut into equal runs, one a lane
  group, and a row goes to the group whose run holds its middle;
* ``dynamic``: a lane group takes the block's next row from a counter in
  shared memory when it is done with one;
* ``unroll2``, ``unroll8``: 2 or 8 entries' X rows loaded together, not 4;
* ``timeline``: the source as it stands, recording clock64() at each phase
  of each block (thread 0; the rows' end after a barrier) and the global
  timer at its start and end — not timed: it prints each phase's mean
  cycles, the blocks' mean lifetime and how many were resident on average;

and calls each through the same C entry, with the window kernel's launch
as the wrapper makes it (``kernels/_common.py:csr_spmm_launch``) and four
other launches of the kept build: ``stage0`` (no entry staged in shared memory), ``rows64`` (64
rows a block), ``one_sm`` (the window cut to what one block an SM may
hold, not a third of it) and ``row-groups`` (the first port's kernel: a
warp a row, every X row from global).  Matrices: xenon2 at
``scale=4.0``, viscoplastic2 at ``scale=16.0`` and torso1
(``core/suite.py``) at B = 32 and 128, float32 and bfloat16.  Each variant is timed 20 times (device time of one call,
``core.autotune.time_device``) in two turns, the variants in order and then
reversed, and held against ``csr_spmm_plain`` within 1e-4 of sum |a * x|.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_k5_designs.py [--out FILE]

It prints each build's ptxas resource line, one line per case (median ms of
each turn, the mean of the two), the card's name and power limit, and
writes every time to ``--out`` (default ``build/k5_designs.json``,
git-ignored).
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
BALANCED = """\
  const long long total = max(1LL, (long long)ip[nr] - base);
  for (int t = 0; t < nr; ++t) {
    const int e0 = (int)(ip[t] - base), e1 = (int)(ip[t + 1] - base);
    if (e1 - e0 > window ||
        min((long long)(e0 + e1) * groups / (2 * total),
            (long long)groups - 1) != group) {
      continue;
    }
"""
ROUND_ROBIN = """\
  for (int t = group; t < nr; t += groups) {
    const int e0 = (int)(ip[t] - base), e1 = (int)(ip[t + 1] - base);
    if (e1 - e0 > window) continue;
"""
DYNAMIC = """\
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(&s_next, 1);
    t = __shfl_sync(mask, t, 0, lanes);
    if (t >= nr) break;
    const int e0 = (int)(ip[t] - base), e1 = (int)(ip[t + 1] - base);
    if (e1 - e0 > window) continue;
"""
BUILDS = ("kept", "balanced", "dynamic", "unroll2", "unroll8", "timeline")
#: (variant, build, launch change)
VARIANTS = (("kept", "kept", None), ("balanced", "balanced", None),
            ("unroll2", "unroll2", None), ("unroll8", "unroll8", None),
            ("dynamic", "dynamic", None), ("stage0", "kept", "stage0"),
            ("rows64", "kept", "rows64"), ("one_sm", "kept", "one_sm"),
            ("row-groups", "kept", "row-groups"))


#: where the ``timeline`` build records clock64() for block b (thread 0):
#: entry 0 start, 1 IRP in shared memory, 2 the stage filled and the window
#: placed, 3 the window kept or not, 4 the window filled, 5 the block's rows
#: summed (after a barrier), and the global timer at 0 and 5
TIMELINE_MARKS = (
    ("  const int wl = threadIdx.x % 32;\n", 0),
    ("  for (int t = threadIdx.x; t <= nr; t += blockDim.x) ip[t] = "
     "indptr[r0 + t];\n  __syncthreads();\n", 1),
    ("  if (wl == 0 && lo != INT_MAX) atomicMin(&s_lo, lo);\n"
     "  __syncthreads();\n", 2),
    ("  const int wrows = s_hits > 0 && s_hits >= held ? held : 0;  "
     "// 0: no window\n", 3),
)
TIMELINE_BLOCKS = 1 << 16
TIMELINE_TAIL = """
__device__ long long csr_tl[8 * %d];
extern "C" int csr_timeline_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, csr_tl, sizeof(csr_tl));
}
""" % TIMELINE_BLOCKS


def timeline_source(source: str) -> str:
    """``csr_spmm.cu`` recording, for each block of the first column tile,
    clock64() at the marks of ``TIMELINE_MARKS`` and before the rows and
    after them, and the global timer at its start and end."""
    def mark(k, timer=False):
        rec = f"csr_tl[blockIdx.x * 8 + {k}] = clock64();"
        if timer:
            rec += (" { long long g; asm volatile(\"mov.u64 %0, "
                    "%%globaltimer;\" : \"=l\"(g)); csr_tl[blockIdx.x * 8 + "
                    f"{6 + (k == 5)}] = g; }}")
        return (f"  if (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < "
                f"{TIMELINE_BLOCKS}) {{ {rec} }}\n")
    for text, k in TIMELINE_MARKS:
        assert source.count(text) == 1, f"{text!r} not found once"
        source = source.replace(text, text + mark(k, k == 0))
    rows = "  // 5. the rows that fit in a window"
    heavy = "  // 6. heavy rows:"
    assert source.count(rows) == 1 and source.count(heavy) == 1
    source = source.replace(rows, mark(4) + rows)
    source = source.replace(heavy, "  __syncthreads();\n" + mark(5, True)
                            + heavy)
    return source.replace("#include \"common.cuh\"\n",
                          "#include \"common.cuh\"\n" + TIMELINE_TAIL)


def build_source(name: str, source: str) -> str:
    """``csr_spmm.cu`` with build ``name``'s change."""
    def swap(text, old, new):
        assert text.count(old) == 1, f"{old!r} not found once"
        return text.replace(old, new)
    if name == "timeline":
        return timeline_source(source)
    if name.startswith("unroll"):
        source = swap(source, "#define CSR_UNROLL 4",
                      f"#define CSR_UNROLL {name[6:]}")
    if name == "balanced":
        source = swap(source, ROUND_ROBIN, BALANCED)
    if name == "dynamic":
        source = swap(source, "__shared__ int s_lo, s_hits;",
                      "__shared__ int s_lo, s_hits, s_next;")
        source = swap(source, "    s_hits = 0;\n",
                      "    s_hits = 0;\n    s_next = 0;\n")
        source = swap(source, ROUND_ROBIN, DYNAMIC)
    return source


def ptxas_usage(log: str) -> str:
    """The spill and register lines ptxas printed for the float32/float32,
    4-columns-a-thread vector instance of the window kernel."""
    block = log.split("Compiling entry function")
    mine = next((b for b in block[1:] if "csr_spmm_windowIffLi4ELb1E" in
                 b.splitlines()[0]), "")
    return " | ".join(re.sub(r"\s+", " ", line.split(":", 1)[-1]).strip()
                      for line in mine.splitlines()
                      if "spill" in line or "Used" in line)


def build_all(out_dir: Path) -> dict:
    """``{build: (C entry, ptxas line)}``, one ``nvcc`` a build."""
    from repro_torch.kernels import build

    source = (build.CSRC / "csr_spmm.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in BUILDS:
        cu = out_dir / f"csr_spmm_{name}.cu"
        cu.write_text(build_source(name, source))
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on build {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, "csr_spmm_launch")
        fn.argtypes = list(build.SIGNATURES["csr_spmm"])
        fn.restype = ctypes.c_int
        entries[name] = (fn, ptxas_usage(log), lib)
    return entries


def timeline_phases(lib, n_blocks: int) -> dict:
    """Mean cycles of each phase of the window kernel's blocks (from the
    ``timeline`` build's records), the mean block lifetime in µs (global
    timer), and the blocks resident on the card on average (their summed
    lifetimes over the span from the first start to the last end)."""
    import numpy as np
    buf = np.zeros(8 * TIMELINE_BLOCKS, np.int64)
    code = lib.csr_timeline_read(ctypes.c_void_p(buf.ctypes.data))
    if code:
        raise RuntimeError(f"csr_timeline_read failed: {code}")
    t = buf.reshape(-1, 8)[:min(n_blocks, TIMELINE_BLOCKS)].astype(
        np.float64)
    names = ("irp", "stage_and_place", "keep", "fill", "rows")
    out = {n: float((t[:, k + 1] - t[:, k]).mean())
           for k, n in enumerate(names)}
    life = t[:, 7] - t[:, 6]
    out["lifetime_us"] = float(life.mean()) / 1e3
    out["resident_blocks"] = float(life.sum() / (t[:, 7].max()
                                                  - t[:, 6].min()))
    return out


def times_of(fn):
    """``REPS`` device times of one call, in ms, after warm-up."""
    import torch

    from repro_torch.core.autotune import time_device
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return [time_device(fn) * 1e3 for _ in range(REPS)]


def launch_of(change, batch, m, x_size):
    """``(kt, lanes, per_lane, threads, rows, window, stage)`` of a
    variant's launch."""
    from repro_torch import launch_shapes as LS
    from repro_torch.kernels import _common as C

    if change == "row-groups":
        kt, lanes, per_lane = C.rhs_tile(batch)
        groups = C.rows_per_block(lanes)
        return kt, lanes, per_lane, groups * lanes, groups, 0, 0
    share = LS.CSR_SPMM_BLOCKS_PER_SM
    if change == "one_sm":
        LS.CSR_SPMM_BLOCKS_PER_SM = 1
    launch = C.csr_spmm_launch(batch, m.n_rows, m.n_cols, m.nnz_pad,
                               64 if change == "rows64" else None, None,
                               x_size, window=True)
    LS.CSR_SPMM_BLOCKS_PER_SM = share
    return launch[:6] + ((0,) if change == "stage0" else launch[6:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, help="where to write every time")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_k5_designs: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.core import suite
    from repro_torch.kernels import csr_spmv as K2

    entries = build_all(ROOT / "build" / "k5_designs")
    for name, (_, usage, _) in entries.items():
        print(f"ptxas {name}: {usage}", flush=True)
    specs = {s.name: s for s in suite.TABLE1}
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    names = [v[0] for v in VARIANTS]
    cases = []
    for mat, scale in (("xenon2", 4.0), ("viscoplastic2", 16.0),
                       ("torso1", 1.0)):
        m = suite.synthesize(specs[mat], scale=scale, device="cpu").to(dev)
        label = mat if scale == 1.0 else f"{mat}@x{scale:g}"
        for dtype in (torch.float32, torch.bfloat16):
            d = m.data.to(dtype)
            for batch in (32, 128):
                X = torch.from_numpy(np.random.default_rng(8).normal(
                    size=(m.n_cols, batch)).astype(np.float32)).to(
                    dev).to(dtype)
                want = K2.csr_spmm_plain(d, m.cols, m.indptr, X)
                mag = K2.csr_spmm_plain(d.abs(), m.cols, m.indptr, X.abs())

                def call(build, change):
                    launch = launch_of(change, batch, m, X.element_size())
                    y = torch.empty((m.n_rows, batch), device=dev)
                    code = entries[build][0](
                        d.data_ptr(), m.cols.data_ptr(), m.indptr.data_ptr(),
                        X.data_ptr(), y.data_ptr(), m.n_rows, m.n_cols,
                        batch, *launch, int(dtype == torch.bfloat16),
                        int(dtype == torch.bfloat16), stream)
                    if code:
                        raise RuntimeError(f"csr_spmm launch failed: {code}")
                    return y

                errs = {}
                for name, build, change in VARIANTS:
                    errs[name] = float(((call(build, change) - want).abs()
                                        / (mag + 1e-30)).max())
                    if errs[name] > KERNEL_REL_TOL:
                        raise AssertionError(f"{label} {dtype} B={batch} "
                                             f"{name}: rel err {errs[name]}")
                turns = {name: [] for name in names}
                for order in (VARIANTS, VARIANTS[::-1]):
                    for name, build, change in order:
                        turns[name].append(times_of(
                            lambda b=build, c=change: call(b, c)))
                key = f"{label}/{dtype}/B={batch}".replace("torch.", "")
                call("timeline", None)
                torch.cuda.synchronize()
                phases = timeline_phases(
                    entries["timeline"][2],
                    -(-m.n_rows // launch_of(None, batch, m,
                                             X.element_size())[4]))
                print(f"{key},timeline,{json.dumps(phases)}", flush=True)
                cases.append({"case": key, "variant": "timeline",
                              "phases": phases})
                for name in names:
                    med = [statistics.median(t) for t in turns[name]]
                    cases.append({"case": key, "variant": name,
                                  "ms": turns[name],
                                  "max_rel_err": errs[name]})
                    print(f"{key},{name},{med[0]:.4f}/{med[1]:.4f},"
                          f"{sum(med) / 2:.4f}", flush=True)
                del X, want, mag
        del m
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    out = args.out or ROOT / "build" / "k5_designs.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "cases": cases,
                               "ptxas": {n: u for n, (_, u, _)
                                         in entries.items()}}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
