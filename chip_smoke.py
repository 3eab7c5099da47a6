#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — the paper's loop: matrix statistics -> D_mat
rule -> run-time transform CRS -> ELL / COO / SELL -> SpMV — through the
entry points a user calls (``offline_phase``, ``Planner().plan(csr)
.bind(csr) @ x``) at the published sizes of the paper's Table 1, plus one
matrix scaled past the card's L2 cache.  On the way it builds the three CUDA
kernels from the sources in this checkout, holds each against its plain
PyTorch version on the card, times it beside its memory bound, and checks
every served product against an independent float64 oracle.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It prints one JSON object per phase, then one line ``{"kernels": [...]}``,
then the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  Any failure (no card, a kernel that does
not build, launch or agree, a wrong product) ends the run with a non-zero
exit code and without that last line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

#: H100 SXM data-sheet peaks the bounds are stated against
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

REPS = 20     # timed repetitions per kernel case (median)
ITERS = 20    # launches per timing in the offline and serve phases

F32_REL_TOL = 1e-4     # relative to sum_k |data_k * x_k| of the row
BF16_REL_TOL = 2e-2

OFFLINE_MATRICES = ("chem_master1", "torso2", "xenon2", "torso3",
                    "poisson3Db", "epb2", "viscoplastic2", "memplus")
OFFLINE_FORMATS = ("ell_row", "ell_col", "coo_row", "sell")
#: (matrix, scale) each kernel is timed at (it is held against its plain
#: version on every matrix of the offline and serve phases).  The last
#: exceeds the 50 MB L2, so its times are the ones a bound stated against
#: device memory applies to.
KERNEL_MATRICES = (("xenon2", 1.0), ("memplus", 1.0), ("xenon2", 4.0))
#: (matrix, scale) served through the planner; the last exceeds the 50 MB L2
SERVED = (("xenon2", 1.0), ("torso3", 1.0), ("memplus", 1.0), ("xenon2", 4.0))
#: formats forced through the planner so every kernel serves at least once
FORCED_FORMATS = ("ell_row", "ell_col", "coo_row", "coo_col", "sell", "csr")

KERNEL_INFO = {
    "ell_spmv": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "replaces": "src/repro/kernels/ell_spmv.py:65"},
    "csr_spmv": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/csr_spmv.cu",
                 "replaces": "src/repro/kernels/csr_spmv.py:178"},
    "coo_spmv": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/coo_spmv.cu",
                 "replaces": "src/repro/kernels/coo_spmv.py:44"},
}


def matrix_label(name: str, scale: float) -> str:
    return name if scale == 1.0 else f"{name}@x{scale:g}"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
_flush_buf = None


def flush_l2() -> None:
    """Overwrite a buffer larger than the L2 so the next launch reads from
    device memory."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(128 * 1024 * 1024, dtype=torch.uint8,
                                 device="cuda")
    _flush_buf.zero_()


#: cycles the card spins before each timed call (~0.5 ms), so that the host
#: has enqueued the call by the time the start event fires and the events
#: bracket device work, not the host's launch latency
HEAD_START_CYCLES = 1_000_000


def time_ms(fn, reps: int = 20, warmup: int = 3, cold: bool = False) -> float:
    """Median over ``reps`` of one call's device time (CUDA events), after
    warm-up.  ``cold`` flushes the L2 before every timed call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if cold:
            flush_l2()
        torch.cuda._sleep(HEAD_START_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: int, flops: int):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------
def kernel_cases(csr, dtype):
    """The calls the main path makes on one matrix at one value dtype, as
    dicts: kernel ``name``, ``layout``, ``kernel`` / ``plain`` / ``mag``
    thunks and the ``bytes`` / ``flops`` of the call.  ``mag`` is the plain
    version on |data|, |x|: the per-row magnitude the error is held against.
    Every format the offline and serve phases run is here, each SELL bucket
    as the ELL panel it is launched on.  Also returns the library call (a
    sparse CSR product, float32 only)."""
    from repro_torch.core import transform as T
    from repro_torch.kernels import coo_spmv as K3
    from repro_torch.kernels import csr_spmv as K2
    from repro_torch.kernels import ell_spmv as K1

    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    x = torch.from_numpy(
        rng.normal(size=csr.n_cols).astype(np.float32)).to(dev).to(dtype)
    xa = x.abs()
    val = x.element_size()
    n, nnz = csr.n_rows, csr.nnz
    cases = []

    def ell_case(layout, d, c, transposed=False):
        d, c = d.to(dev).to(dtype), c.to(dev)
        if transposed:      # column-major storage, viewed (n_rows, width)
            d, c = d.t(), c.t()
        rows, width = d.shape
        cases.append({
            "name": "ell_spmv", "layout": layout,
            "kernel": lambda: K1.ell_spmv(d, c, x),
            "plain": lambda: K1.ell_spmv_plain(d, c, x),
            "mag": lambda: K1.ell_spmv_plain(d.abs(), c, xa),
            "bytes": rows * width * (val + 4) + val * csr.n_cols + 4 * rows,
            "flops": 2 * rows * width})

    for order in ("row", "col"):
        ell = T.host_csr_to_ell(csr, order=order)
        ell_case(f"ell_{order}", ell.data, ell.cols, transposed=order == "col")
    for i, bucket in enumerate(T.host_csr_to_sell(csr).buckets):
        ell_case(f"sell[{i}]", bucket.data, bucket.cols)

    m = csr.to(dev)
    md = m.data.to(dtype)
    cases.append({
        "name": "csr_spmv", "layout": "csr",
        "kernel": lambda: K2.csr_spmv(md, m.cols, m.indptr, x),
        "plain": lambda: K2.csr_spmv_plain(md, m.cols, m.indptr, x),
        "mag": lambda: K2.csr_spmv_plain(md.abs(), m.cols, m.indptr, xa),
        "bytes": nnz * (val + 4) + 4 * (n + 1) + val * csr.n_cols + 4 * n,
        "flops": 2 * nnz})

    for layout, recipe in (("coo_row", T.host_csr_to_coo_row),
                           ("coo_col", T.host_csr_to_coo_col)):
        coo = recipe(csr).to(dev)
        cd = coo.data.to(dtype)
        cases.append({
            "name": "coo_spmv", "layout": layout,
            "kernel": lambda c=coo, d=cd: K3.coo_spmv(d, c.rows, c.cols, x, n),
            "plain": lambda c=coo, d=cd: K3.coo_spmv_plain(
                d, c.rows, c.cols, x, n),
            "mag": lambda c=coo, d=cd: K3.coo_spmv_plain(
                d.abs(), c.rows, c.cols, xa, n),
            "bytes": coo.nnz_pad * (val + 8) + val * csr.n_cols + 4 * n,
            "flops": 2 * coo.nnz_pad})

    library = None
    if dtype == torch.float32:
        a = torch.sparse_csr_tensor(m.indptr, m.cols[:nnz], m.data[:nnz],
                                    size=csr.shape)
        library = lambda: a @ x
    return cases, library


def phase_kernels(reps: int):
    """Hold every kernel against its plain version on every matrix the main
    path runs (all its formats, both value dtypes); time the cases of
    ``KERNEL_MATRICES``."""
    from repro_torch.core import suite

    specs = {s.name: s for s in suite.TABLE1}
    todo = [(name, 1.0) for name in OFFLINE_MATRICES]
    for matrix in SERVED + KERNEL_MATRICES:
        if matrix not in todo:
            todo.append(matrix)
    results = []
    for name, scale in todo:
        csr = suite.synthesize(specs[name], scale=scale)
        timed = (name, scale) in KERNEL_MATRICES
        name = matrix_label(name, scale)
        for dtype in (torch.float32, torch.bfloat16):
            tol = F32_REL_TOL if dtype == torch.float32 else BF16_REL_TOL
            cases, library = kernel_cases(csr, dtype)
            library_ms = (time_ms(library, reps)
                          if library and timed else None)
            for case in cases:
                kname, layout = case["name"], case["layout"]
                y_k, y_p, mag = case["kernel"](), case["plain"](), case["mag"]()
                torch.cuda.synchronize()
                if y_k.shape != y_p.shape or y_k.dtype != torch.float32:
                    raise AssertionError(f"{kname}/{layout}: bad output "
                                         f"{y_k.shape} {y_k.dtype}")
                if not bool(torch.isfinite(y_k).all()):
                    raise AssertionError(f"{kname}/{layout}: non-finite y")
                err = (y_k - y_p).abs()
                rel = float((err / (mag + 1e-30)).max())
                if rel > tol:
                    raise AssertionError(
                        f"{kname}/{layout} {name} {dtype}: kernel disagrees "
                        f"with its plain version: rel err {rel} > {tol}")
                result = {
                    "name": kname, "layout": layout, "matrix": name,
                    "dtype": str(dtype).replace("torch.", ""),
                    "n_rows": int(y_k.shape[0]), "nnz": csr.nnz,
                    "max_abs_err": float(err.max()), "max_rel_err": rel,
                    "tolerance": tol}
                if timed and not layout.startswith("sell"):
                    b_ms, b_by = bound(case["bytes"], case["flops"])
                    result.update({
                        "ms": time_ms(case["kernel"], reps),
                        "ms_cold_l2": time_ms(case["kernel"], reps, cold=True),
                        "plain_ms": time_ms(case["plain"], reps),
                        "bound_ms": b_ms, "bound_by": b_by,
                        "bytes": case["bytes"], "library_ms": library_ms})
                results.append(result)
    emit("kernels", cases=results)
    return results


def kernels_line(cases, launches):
    """One entry per kernel: its float32 case on xenon2 at scale 4 — past the
    L2, where the card does real memory work (ELL: row-major, the layout
    the paper's rule serves) — carries the times; the error is the
    largest over all of the kernel's cases (listed by the ``kernels``
    phase line)."""
    out = []
    for kname, info in KERNEL_INFO.items():
        mine = [c for c in cases if c["name"] == kname]
        head = next(c for c in mine if c["matrix"] == "xenon2@x4"
                    and c["dtype"] == "float32"
                    and c["layout"] in ("ell_row", "csr", "coo_row"))
        out.append({
            "name": kname, **info, "launches": launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": {"matrix": head["matrix"], "layout": head["layout"],
                      "dtype": head["dtype"], "n_rows": head["n_rows"],
                      "nnz": head["nnz"]},
            "cases_checked": len(mine)})
    return {"kernels": out}


# ---------------------------------------------------------------------------
# phase: offline
# ---------------------------------------------------------------------------
def phase_offline(names, iters: int):
    from repro_torch import api
    from repro_torch.core import suite
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    mats = suite.paper_suite(scale=1.0, include=names)
    t_synth = time.perf_counter() - t0
    db = api.offline_phase(mats, formats=OFFLINE_FORMATS,
                           machine=torch.cuda.get_device_name(0),
                           spmv_impls=ops.KERNEL_SPMV_IMPLS, iters=iters)
    rows = []
    for r in sorted(db.records, key=lambda r: r.d_mat):
        rows.append({"matrix": r.name, "n": r.n, "nnz": r.nnz,
                     "d_mat": r.d_mat, "t_crs": r.t_crs,
                     "formats": {f: {"t_f": m.t_spmv, "t_trans": m.t_trans,
                                     "SP": m.sp, "TT": m.tt, "R": m.r}
                                 for f, m in r.formats.items()}})
        for f, m in r.formats.items():
            if not (np.isfinite(m.t_spmv) and m.t_spmv > 0
                    and np.isfinite(m.t_trans) and m.t_trans > 0):
                raise AssertionError(f"offline: bad timing {r.name}/{f}")
    # the artifact survives its own JSON
    db2 = api.TuningDB.from_json(db.to_json())
    if db2.d_star != db.d_star or len(db2.records) != len(db.records):
        raise AssertionError("TuningDB JSON round trip changed the db")
    emit("offline", seconds_synthesize=t_synth, c=db.c, d_star=db.d_star,
         records=rows)
    return db


# ---------------------------------------------------------------------------
# phase: serve
# ---------------------------------------------------------------------------
def oracle_f64(csr, x):
    """Independent float64 product on the card: expand IRP to row ids,
    index_add_ the float64 contributions.  Also returns sum |a x| per row."""
    dev = x.device
    ip = csr.indptr.to(dev)
    k = torch.arange(csr.nnz, dtype=torch.int32, device=dev)
    rows = torch.searchsorted(ip, k, right=True) - 1
    data = csr.data[: csr.nnz].to(dev).double()
    cols = csr.cols[: csr.nnz].to(dev).long()
    contrib = data * x.double()[cols]
    y = torch.zeros(csr.n_rows, dtype=torch.float64, device=dev)
    s = torch.zeros_like(y)
    return y.index_add_(0, rows, contrib), s.index_add_(0, rows,
                                                        contrib.abs())


def serve_one(api, planner, csr, label, plan_kw, iters):
    from repro_torch import kernels
    from repro_torch.core.autotune import time_fn, time_host

    rng = np.random.default_rng(99)
    x = torch.from_numpy(
        rng.normal(size=csr.n_cols).astype(np.float32)).cuda()
    t0 = time.perf_counter()
    plan = planner.plan(csr, **plan_kw)
    t_plan = time.perf_counter() - t0
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    P = plan.bind(csr, db=planner.db)
    torch.cuda.synchronize()
    t_bind = time.perf_counter() - t0
    if P.tiers["spmv"] != "kernel":
        raise AssertionError(f"{label}: spmv resolved to {P.tiers['spmv']}")
    y = P @ x
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    risen = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    if not risen:
        raise AssertionError(f"{label}: no kernel launch counter rose")
    want, scale = oracle_f64(csr, x)
    if y.shape != want.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{label}: bad product {y.shape}")
    rel = float(((y.double() - want).abs() / (scale + 1e-30)).max())
    if rel > F32_REL_TOL:
        raise AssertionError(f"{label}: product off the float64 oracle: "
                             f"rel err {rel} > {F32_REL_TOL}")
    # the plan survives its own JSON and re-binds to the same product
    plan2 = api.ExecutionPlan.from_json(plan.to_json())
    if plan2.to_dict() != plan.to_dict():
        raise AssertionError(f"{label}: plan JSON round trip changed it")
    y2 = plan2.bind(csr, db=planner.db) @ x
    rel2 = float(((y2.double() - want).abs() / (scale + 1e-30)).max())
    if rel2 > F32_REL_TOL:
        raise AssertionError(f"{label}: re-bound plan off the oracle")
    t_trans = time_host(plan.transform.apply, csr, iters=1) \
        if plan.fmt != "csr" else 0.0
    t_spmv = time_fn(P.spmv, x, iters=iters)
    return {"matrix": label, "n": csr.n_rows, "nnz": csr.nnz,
            "rule": plan.rule, "fmt": plan.fmt, "d_mat": plan.d_mat,
            "d_star": None if not np.isfinite(plan.d_star) else plan.d_star,
            "tier": P.tiers["spmv"], "launched": risen,
            "max_rel_err": rel, "t_plan": t_plan, "t_trans": t_trans,
            "t_bind": t_bind, "t_spmv": t_spmv}


def phase_serve(db, iters: int):
    from repro_torch import api
    from repro_torch.core import suite

    specs = {s.name: s for s in suite.TABLE1}
    paper = api.Planner(db=db, rule="paper", tier="kernel")
    served = []
    mats = {}
    for name, scale in SERVED:
        csr = suite.synthesize(specs[name], scale=scale)
        mats[matrix_label(name, scale)] = csr
        served.append(serve_one(api, paper, csr,
                                matrix_label(name, scale), {},
                                iters))
    # the generalized rule, for a long solve (many products per transform)
    gen = api.Planner(db=db, rule="generalized", tier="kernel")
    for k in (100, 1_000_000):
        served.append(serve_one(api, gen, mats["xenon2"], "xenon2",
                                {"expected_iterations": k}, iters))
    # every format once through the planner, so each kernel serves
    for f in FORCED_FORMATS:
        served.append(serve_one(api, paper, mats["xenon2@x4"], "xenon2@x4",
                                {"fmt": f}, iters))
    emit("serve", served=served)
    return served


# ---------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < 1:
        return 1

    import repro_torch
    from repro_torch import kernels
    from repro_torch.kernels import build

    smi = nvidia_smi_line()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         repro_torch=repro_torch.__version__,
         kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    t0 = time.perf_counter()
    build.build_all(force=True)
    for name in build.KERNELS:
        build.load(name)
    emit("build", seconds=time.perf_counter() - t0,
         libraries={n: str(build.library_path(n).name) for n in build.KERNELS})

    cases = phase_kernels(REPS)

    # the main path: every launch from here on is counted
    kernels.reset_launch_counts()
    db = phase_offline(OFFLINE_MATRICES, ITERS)
    phase_serve(db, ITERS)
    launches = kernels.launch_counts()
    emit("launches", main_path=launches)
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"the main path never launched {idle}")
    print(json.dumps(kernels_line(cases, launches)), flush=True)

    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
