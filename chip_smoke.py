#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two paths — the paper's loop: matrix statistics -> D_mat
rule -> run-time transform CRS -> ELL / COO / SELL -> SpMV, and the same loop
with a batch axis, where each call carries B products (SpMM, ``X: (n_cols,
B)``) — through the entry points a user calls (``offline_phase``,
``Planner().plan(csr, batch=B).bind(csr) @ X``) at the published sizes of the
paper's Table 1, plus one matrix scaled past the card's L2 cache.  On the way
it builds the six CUDA kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card, times it beside its bound,
checks every served product against an independent float64 oracle, and runs
the launch-geometry tuner (``KernelTuner``) on the card.

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

#: a float32 product against the float64 oracle, relative to
#: sum_k |data_k * x_k| of the output element
F32_REL_TOL = 1e-4
#: a kernel against its plain version, relative to the same sum: both read
#: the same float32 or bfloat16 values and accumulate in float32, so only
#: the order of the sum differs, and bfloat16 is held as tightly as float32
KERNEL_REL_TOL = 1e-4

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
#: right-hand sides the SpMM kernels are timed at (on xenon2 at scale 4)
SPMM_TIMED = (8, 128)
#: batches of the off-line phase's SpMM runs (the per-B D* table)
OFFLINE_BATCHES = (8, 32, 128)
#: batch the batched path serves at; xenon2 at scale 4 is also served at 8
SERVE_BATCH = 128
#: right-hand sides each SpMM kernel is held against its plain version at:
#: B = 1 and every B the main path launches the SpMM kernels at
SPMM_CHECKED = tuple(sorted({1, 8, SERVE_BATCH, *OFFLINE_BATCHES}))
#: the matrix the SpMM kernels are timed and the tuner runs on
BIG = ("xenon2", 4.0)

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
    "ell_spmm": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ell_spmm.cu",
                 "replaces": "src/repro/kernels/ell_spmv.py:111"},
    "csr_spmm": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/csr_spmm.cu",
                 "replaces": "src/repro/kernels/csr_spmv.py:241"},
    "coo_spmm": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/coo_spmm.cu",
                 "replaces": "src/repro/kernels/coo_spmv.py:92"},
}
#: the SpMM kernel each format's batched product launches
SPMM_KERNEL_OF = {"csr": "csr_spmm", "coo_row": "coo_spmm",
                  "coo_col": "coo_spmm", "ell_row": "ell_spmm",
                  "ell_col": "ell_spmm", "sell": "ell_spmm"}


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


def time_ms(fn, reps: int = 20, warmup: int = 3, cold: bool = False) -> float:
    """Median over ``reps`` of one call's device time (CUDA events behind a
    head start that outlasts the host's enqueue), after warm-up.  ``cold``
    flushes the L2 before every timed call."""
    from repro_torch.core.autotune import time_device
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return statistics.median(
        time_device(fn, before=flush_l2 if cold else None) * 1e3
        for _ in range(reps))


def bound(bytes_moved: int, flops: int):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------
def matrix_layouts(csr):
    """``csr`` in every format the main path runs, on the card: the host
    recipes run once per matrix, not once per kernel case."""
    from repro_torch.core import transform as T

    dev = torch.device("cuda")
    return {"csr": csr.to(dev),
            "ell_row": T.host_csr_to_ell(csr, order="row").to(dev),
            "ell_col": T.host_csr_to_ell(csr, order="col").to(dev),
            "sell": T.host_csr_to_sell(csr).to(dev),
            "coo_row": T.host_csr_to_coo_row(csr).to(dev),
            "coo_col": T.host_csr_to_coo_col(csr).to(dev)}


def kernel_cases(csr, layouts, dtype, batch=None, block_k=None):
    """The calls the main path makes on one matrix (``layouts``: its
    formats, from :func:`matrix_layouts`) at one value dtype, as dicts:
    kernel ``name``, ``layout``, ``kernel`` / ``plain`` / ``mag`` thunks
    and the ``bytes`` / ``flops`` of the call.  ``batch=None`` gives the
    SpMV kernels on a vector x; ``batch=B`` the SpMM kernels on an
    ``(n_cols, B)`` panel, launched with ``block_k`` right-hand-side columns
    per CUDA block (``None``: the wrapper's default).  ``mag`` is the plain
    version on |data|, |x|: the per-element magnitude the error is held
    against.  ``bytes`` counts A once, x once (``val * n_cols * B``) and y
    once (``4 * n_rows * B``); ``flops`` is ``2 * nnz * B``.  Every format
    the offline and serve phases run is here, each SELL bucket as the ELL
    panel it is launched on.  Also returns the library call (a sparse CSR
    product, float32 only)."""
    from repro_torch.kernels import coo_spmv as K3
    from repro_torch.kernels import csr_spmv as K2
    from repro_torch.kernels import ell_spmv as K1

    op = "spmv" if batch is None else "spmm"
    b = batch or 1
    ell, ell_plain = getattr(K1, f"ell_{op}"), getattr(K1, f"ell_{op}_plain")
    csr_k, csr_plain = getattr(K2, f"csr_{op}"), getattr(K2, f"csr_{op}_plain")
    coo_k, coo_plain = getattr(K3, f"coo_{op}"), getattr(K3, f"coo_{op}_plain")
    kw = {} if block_k is None else {"block_k": block_k}
    dev = torch.device("cuda")
    rng = np.random.default_rng(1234 + b)
    shape = (csr.n_cols,) if batch is None else (csr.n_cols, batch)
    x = torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)).to(dev).to(dtype)
    xa = x.abs()
    val = x.element_size()
    n, nnz = csr.n_rows, csr.nnz
    xy_bytes = val * csr.n_cols * b + 4 * n * b
    flops = 2 * nnz * b
    cases = []

    def ell_case(layout, d, c, transposed=False):
        d = d.to(dtype)
        if transposed:      # column-major storage, viewed (n_rows, width)
            d, c = d.t(), c.t()
        rows, width = d.shape
        cases.append({
            "name": f"ell_{op}", "layout": layout,
            "kernel": lambda: ell(d, c, x, **kw),
            "plain": lambda: ell_plain(d, c, x),
            "mag": lambda: ell_plain(d.abs(), c, xa),
            "bytes": rows * width * (val + 4) + xy_bytes, "flops": flops})

    for order in ("row", "col"):
        m_ell = layouts[f"ell_{order}"]
        ell_case(f"ell_{order}", m_ell.data, m_ell.cols,
                 transposed=order == "col")
    for i, bucket in enumerate(layouts["sell"].buckets):
        ell_case(f"sell[{i}]", bucket.data, bucket.cols)

    m = layouts["csr"]
    md = m.data.to(dtype)
    cases.append({
        "name": f"csr_{op}", "layout": "csr",
        "kernel": lambda: csr_k(md, m.cols, m.indptr, x, **kw),
        "plain": lambda: csr_plain(md, m.cols, m.indptr, x),
        "mag": lambda: csr_plain(md.abs(), m.cols, m.indptr, xa),
        "bytes": nnz * (val + 4) + 4 * (n + 1) + xy_bytes, "flops": flops})

    for layout in ("coo_row", "coo_col"):
        coo = layouts[layout]
        cd = coo.data.to(dtype)
        cases.append({
            "name": f"coo_{op}", "layout": layout,
            "kernel": lambda c=coo, d=cd: coo_k(d, c.rows, c.cols, x, n,
                                                **kw),
            "plain": lambda c=coo, d=cd: coo_plain(d, c.rows, c.cols, x, n),
            "mag": lambda c=coo, d=cd: coo_plain(d.abs(), c.rows, c.cols,
                                                 xa, n),
            "bytes": coo.nnz_pad * (val + 8) + xy_bytes, "flops": flops})

    library = None
    if dtype == torch.float32:
        a = torch.sparse_csr_tensor(m.indptr, m.cols[:nnz], m.data[:nnz],
                                    size=csr.shape)
        library = lambda: a @ x
    return cases, library


def check_cases(cases, library, label, nnz, dtype, timed, reps, **extra):
    """Hold each case's kernel against its plain version (relative to the
    plain version on |data|, |x|); time the kernel, the plain version and
    the library call when ``timed``.  Returns one result dict per case."""
    tol = KERNEL_REL_TOL    # for both value dtypes
    library_ms = time_ms(library, reps) if library and timed else None
    results = []
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
                f"{kname}/{layout} {label} {dtype} {extra}: kernel disagrees "
                f"with its plain version: rel err {rel} > {tol}")
        result = {
            "name": kname, "layout": layout, "matrix": label, **extra,
            "dtype": str(dtype).replace("torch.", ""),
            "n_rows": int(y_k.shape[0]), "nnz": nnz,
            "max_abs_err": float(err.max()), "max_rel_err": rel,
            "tolerance": tol}
        del y_k, y_p, mag, err
        if timed and not layout.startswith("sell"):
            b_ms, b_by = bound(case["bytes"], case["flops"])
            result.update({
                "ms": time_ms(case["kernel"], reps),
                "ms_cold_l2": time_ms(case["kernel"], reps, cold=True),
                "plain_ms": time_ms(case["plain"], reps),
                "bound_ms": b_ms, "bound_by": b_by,
                "bytes": case["bytes"], "library_ms": library_ms})
        results.append(result)
    return results


def phase_kernels(reps: int):
    """Hold every kernel against its plain version on every matrix the main
    path runs (all its formats, both value dtypes; the SpMM kernels at each
    B of ``SPMM_CHECKED``, and on ``BIG`` at B = ``SERVE_BATCH`` also at
    each column tile the tuner's grid launches); time the SpMV cases of
    ``KERNEL_MATRICES`` and the SpMM cases of ``BIG`` at each B of
    ``SPMM_TIMED``."""
    from repro_torch.core import suite
    from repro_torch.core.kernel_tune import GPU_K_TILES

    specs = {s.name: s for s in suite.TABLE1}
    todo = [(name, 1.0) for name in OFFLINE_MATRICES]
    for matrix in SERVED + KERNEL_MATRICES:
        if matrix not in todo:
            todo.append(matrix)
    results = []
    for name, scale in todo:
        csr = suite.synthesize(specs[name], scale=scale)
        layouts = matrix_layouts(csr)
        label = matrix_label(name, scale)
        for dtype in (torch.float32, torch.bfloat16):
            cases, library = kernel_cases(csr, layouts, dtype)
            results += check_cases(cases, library, label, csr.nnz, dtype,
                                   (name, scale) in KERNEL_MATRICES, reps)
            for batch in SPMM_CHECKED:
                cases, library = kernel_cases(csr, layouts, dtype, batch)
                timed = (name, scale) == BIG and batch in SPMM_TIMED
                results += check_cases(cases, library, label, csr.nnz,
                                       dtype, timed, reps, batch=batch)
                del cases, library
            if (name, scale) == BIG:
                for block_k in (k for k in GPU_K_TILES if k < SERVE_BATCH):
                    cases, _ = kernel_cases(csr, layouts, dtype, SERVE_BATCH,
                                            block_k)
                    results += check_cases(cases, None, label, csr.nnz,
                                           dtype, False, reps,
                                           batch=SERVE_BATCH, block_k=block_k)
                    del cases
        del csr, layouts
        torch.cuda.empty_cache()
    emit("kernels", cases=results)
    return results


def kernels_line(cases, launches):
    """One entry per kernel: its float32 case on xenon2 at scale 4 — past the
    L2, where the card does real memory work (ELL: row-major, the layout
    the paper's rule serves; SpMM at B = ``SERVE_BATCH``) — carries the
    times; the error is the largest over all of the kernel's cases (listed
    by the ``kernels`` phase line).  ``launches`` is the count from the
    run of the path the kernel serves."""
    out = []
    for kname, info in KERNEL_INFO.items():
        mine = [c for c in cases if c["name"] == kname]
        head = next(c for c in mine if c["matrix"] == matrix_label(*BIG)
                    and c["dtype"] == "float32"
                    and c.get("batch", SERVE_BATCH) == SERVE_BATCH
                    and "block_k" not in c
                    and c["layout"] in ("ell_row", "csr", "coo_row"))
        shape = {k: head[k] for k in ("matrix", "layout", "dtype", "n_rows",
                                      "nnz", "batch") if k in head}
        out.append({
            "name": kname, **info, "launches": launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": shape,
            "cases_checked": len(mine)})
    return {"kernels": out}


# ---------------------------------------------------------------------------
# phase: offline
# ---------------------------------------------------------------------------
def offline_rows(db):
    """One row per matrix: t_crs, and per format t_f, t_trans, SP, TT, R;
    fails on a timing that is not a positive finite number."""
    rows = []
    for r in sorted(db.records, key=lambda r: r.d_mat):
        rows.append({"matrix": r.name, "n": r.n, "nnz": r.nnz,
                     "d_mat": r.d_mat, "t_crs": r.t_crs, "batch": r.batch,
                     "formats": {f: {"t_f": m.t_spmv, "t_trans": m.t_trans,
                                     "SP": m.sp, "TT": m.tt, "R": m.r}
                                 for f, m in r.formats.items()}})
        for f, m in r.formats.items():
            if not (np.isfinite(m.t_spmv) and m.t_spmv > 0
                    and np.isfinite(m.t_trans) and m.t_trans > 0):
                raise AssertionError(f"offline: bad timing {r.name}/{f}")
    return rows


def round_trip(api, db):
    """The artifact survives its own JSON."""
    db2 = api.TuningDB.from_json(db.to_json())
    if (db2.d_star != db.d_star or len(db2.records) != len(db.records)
            or [r.batch for r in db2.records] != [r.batch
                                                   for r in db.records]):
        raise AssertionError("TuningDB JSON round trip changed the db")


def phase_offline(mats, seconds_synthesize: float, iters: int):
    from repro_torch import api
    from repro_torch.kernels import ops

    db = api.offline_phase(mats, formats=OFFLINE_FORMATS,
                           machine=torch.cuda.get_device_name(0),
                           spmv_impls=ops.KERNEL_SPMV_IMPLS, iters=iters)
    rows = offline_rows(db)
    round_trip(api, db)
    emit("offline", seconds_synthesize=seconds_synthesize, c=db.c,
         d_star=db.d_star, records=rows)
    return db


def phase_offline_spmm(mats, iters: int):
    """The off-line phase with a batch axis: one run per B of
    ``OFFLINE_BATCHES``, each timing the SpMM kernels on ``(n_cols, B)``
    panels — the per-B D* table."""
    from repro_torch import api
    from repro_torch.kernels import ops

    dbs, tables = {}, []
    for batch in OFFLINE_BATCHES:
        t0 = time.perf_counter()
        db = api.offline_phase(mats, formats=OFFLINE_FORMATS, batch=batch,
                               machine=torch.cuda.get_device_name(0),
                               spmm_impls=ops.KERNEL_SPMM_IMPLS, iters=iters)
        if any(r.batch != batch for r in db.records):
            raise AssertionError(f"offline B={batch}: records of another B")
        rows = offline_rows(db)
        round_trip(api, db)
        tables.append({"batch": batch, "c": db.c, "d_star": db.d_star,
                       "seconds": time.perf_counter() - t0,
                       "records": rows})
        dbs[batch] = db
    emit("offline_spmm", tables=tables)
    return dbs


# ---------------------------------------------------------------------------
# phase: serve
# ---------------------------------------------------------------------------
#: elements of the largest float64 temporary the oracle builds (1 GiB)
ORACLE_CHUNK_ELEMS = 1 << 27


def oracle_f64(csr, x):
    """Independent float64 product on the card: expand IRP to row ids,
    index_add_ the float64 contributions, a few columns of ``x`` (1-D, or
    ``(n_cols, B)``) at a time so that no temporary passes 1 GiB.  Also
    returns sum |a x| per output element."""
    dev = x.device
    ip = csr.indptr.to(dev)
    k = torch.arange(csr.nnz, dtype=torch.int32, device=dev)
    rows = torch.searchsorted(ip, k, right=True) - 1
    data = csr.data[: csr.nnz].to(dev).double()
    cols = csr.cols[: csr.nnz].to(dev).long()
    x2 = x.double().reshape(x.shape[0], -1)
    y = torch.zeros((csr.n_rows, x2.shape[1]), dtype=torch.float64,
                    device=dev)
    s = torch.zeros_like(y)
    step = max(1, ORACLE_CHUNK_ELEMS // max(csr.nnz, 1))
    for c0 in range(0, x2.shape[1], step):
        c1 = min(c0 + step, x2.shape[1])
        contrib = data[:, None] * x2[cols, c0:c1]
        y[:, c0:c1] = torch.zeros_like(y[:, c0:c1]).index_add_(0, rows,
                                                                contrib)
        s[:, c0:c1] = torch.zeros_like(s[:, c0:c1]).index_add_(
            0, rows, contrib.abs_())
        del contrib
    if x.ndim == 1:
        return y[:, 0], s[:, 0]
    return y, s


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
        served.append(serve_one(api, paper, mats[matrix_label(*BIG)],
                                matrix_label(*BIG), {"fmt": f}, iters))
    emit("serve", served=served)
    return served


def check_product(label, y, csr, x):
    """``y`` against the float64 oracle, relative to sum |a x|."""
    want, scale = oracle_f64(csr, x)
    if y.shape != want.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{label}: bad product {tuple(y.shape)}")
    rel = float(((y.double() - want).abs() / (scale + 1e-30)).max())
    if rel > F32_REL_TOL:
        raise AssertionError(f"{label}: product off the float64 oracle: "
                             f"rel err {rel} > {F32_REL_TOL}")
    return rel


def serve_spmm_one(api, planner, csr, label, batch, plan_kw, iters):
    """``planner.plan(csr, batch=B).bind(csr) @ X`` on the card: the SpMM
    must resolve to the kernel tier, launch the format's SpMM kernel and
    match the oracle; the plan must survive its JSON and re-bind."""
    from repro_torch import kernels
    from repro_torch.core.autotune import time_fn, time_host

    rng = np.random.default_rng(98)
    x = torch.from_numpy(rng.normal(size=(csr.n_cols, batch)).astype(
        np.float32)).cuda()
    t0 = time.perf_counter()
    plan = planner.plan(csr, batch=batch, **plan_kw)
    t_plan = time.perf_counter() - t0
    before = kernels.launch_counts()
    t0 = time.perf_counter()
    P = plan.bind(csr, db=planner.db)
    torch.cuda.synchronize()
    t_bind = time.perf_counter() - t0
    if P.tiers["spmm"] != "kernel":
        raise AssertionError(f"{label}: spmm resolved to {P.tiers['spmm']}")
    y = P @ x
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    risen = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    if not risen.get(SPMM_KERNEL_OF[plan.fmt]):
        raise AssertionError(f"{label} {plan.fmt}: {SPMM_KERNEL_OF[plan.fmt]}"
                             f" was not launched ({risen})")
    rel = check_product(f"{label} B={batch} {plan.fmt}", y, csr, x)
    del y
    plan2 = api.ExecutionPlan.from_json(plan.to_json())
    if plan2.to_dict() != plan.to_dict():
        raise AssertionError(f"{label}: plan JSON round trip changed it")
    check_product(f"{label} re-bound", plan2.bind(csr, db=planner.db) @ x,
                  csr, x)
    t_trans = time_host(plan.transform.apply, csr, iters=1) \
        if plan.fmt != "csr" else 0.0
    t_spmm = time_fn(P.spmm, x, iters=iters)
    return {"matrix": label, "n": csr.n_rows, "nnz": csr.nnz, "batch": batch,
            "rule": plan.rule, "fmt": plan.fmt, "d_mat": plan.d_mat,
            "d_star": None if not np.isfinite(plan.d_star) else plan.d_star,
            "tier": P.tiers["spmm"], "launched": risen, "max_rel_err": rel,
            "t_plan": t_plan, "t_trans": t_trans, "t_bind": t_bind,
            "t_spmm": t_spmm}


def phase_serve_spmm(dbs, iters: int):
    """The batched path: the paper's rule (D* learned at the same B) on
    every served matrix at B = ``SERVE_BATCH``, the big matrix also at
    B = 8, and every format forced once on the big matrix."""
    from repro_torch import api
    from repro_torch.core import suite

    specs = {s.name: s for s in suite.TABLE1}
    paper = api.Planner(db=dbs[SERVE_BATCH], rule="paper", tier="kernel")
    served, mats = [], {}
    for name, scale in SERVED:
        csr = suite.synthesize(specs[name], scale=scale)
        mats[(name, scale)] = csr
        served.append(serve_spmm_one(api, paper, csr,
                                     matrix_label(name, scale), SERVE_BATCH,
                                     {}, iters))
    big, label = mats[BIG], matrix_label(*BIG)
    served.append(serve_spmm_one(
        api, api.Planner(db=dbs[8], rule="paper", tier="kernel"), big, label,
        8, {}, iters))
    for f in FORCED_FORMATS:
        served.append(serve_spmm_one(api, paper, big, label, SERVE_BATCH,
                                     {"fmt": f}, iters))
    emit("serve_spmm", served=served)
    return big


def phase_tune(db, csr):
    """``KernelTuner`` on the card: every format's SpMV and SpMM (B =
    ``SERVE_BATCH``) launch geometry on ``csr``, then the planner with that
    tuner binds each winner and still serves the right product."""
    from repro_torch import api
    from repro_torch.core.formats import MatrixStats

    label = matrix_label(*BIG)
    tuner = api.KernelTuner(db)
    stats = MatrixStats.of(csr)
    rng = np.random.default_rng(97)
    x = torch.from_numpy(rng.normal(size=(csr.n_cols, SERVE_BATCH)).astype(
        np.float32)).cuda()
    tuned, served = [], []
    for f in FORCED_FORMATS:
        obj = api.TRANSFORMS_HOST[f](csr).to("cuda")
        recs = {}
        for op, batch in (("spmv", 1), ("spmm", SERVE_BATCH)):
            t0 = time.perf_counter()
            rec = tuner.tune(obj, op=op, batch=batch, stats=stats)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            # a second sweep from scratch: whether the winner reproduces
            again = tuner.tune(obj, op=op, batch=batch, stats=stats,
                               force=True)
            recs[op] = again
            tuned.append({"matrix": label, "fmt": f, "op": op,
                          "batch": batch, "t_default": rec.t_default,
                          "t_best": rec.t_best, "speedup": rec.speedup,
                          "geometry": rec.geometry.to_dict(),
                          "seconds": seconds,
                          "again": {"t_default": again.t_default,
                                    "t_best": again.t_best,
                                    "speedup": again.speedup,
                                    "geometry": again.geometry.to_dict()}})
        del obj
        t0 = time.perf_counter()
        plan = api.Planner(db, tuner=tuner).plan(csr, batch=SERVE_BATCH,
                                                 fmt=f)
        P = plan.bind(csr, db=db)
        t_plan_bind = time.perf_counter() - t0
        for op, rec in recs.items():
            bound = P.tunings[op]
            if P.tiers[op] != "kernel" or bound is None or \
                    bound.without_slab_bound() != \
                    rec.geometry.without_slab_bound():
                raise AssertionError(f"tune {f}/{op}: bound {bound}, "
                                     f"tuned {rec.geometry}")
        rel = check_product(f"tune {f} spmm", P @ x, csr, x)
        rel_v = check_product(f"tune {f} spmv", P @ x[:, 0], csr, x[:, 0])
        served.append({"fmt": f, "tunings": {
                           op: g.to_dict() if g is not None else None
                           for op, g in P.tunings.items()},
                       "max_rel_err": max(rel, rel_v),
                       "t_plan_bind": t_plan_bind})
        del P, plan
    emit("tune", tuned=tuned, served=served, records=len(db.geometries))


# ---------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < 1:
        return 1

    t_start = time.perf_counter()
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

    phases = {}               # seconds per phase, in the summary line

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        return out

    cases = timed("kernels", phase_kernels, REPS)

    from repro_torch.core import suite
    t0 = time.perf_counter()
    mats = suite.paper_suite(scale=1.0, include=OFFLINE_MATRICES)
    t_synth = time.perf_counter() - t0

    # the SpMV path: every launch from here to the read is counted
    kernels.reset_launch_counts()
    db = timed("offline", phase_offline, mats, t_synth, ITERS)
    timed("serve", phase_serve, db, ITERS)
    spmv_path = kernels.launch_counts()
    # the batched (SpMM) path, counted on its own
    kernels.reset_launch_counts()
    dbs = timed("offline_spmm", phase_offline_spmm, mats, ITERS)
    big = timed("serve_spmm", phase_serve_spmm, dbs, ITERS)
    spmm_path = kernels.launch_counts()
    launches = {k: (spmm_path if k.endswith("_spmm") else spmv_path)[k]
                for k in KERNEL_INFO}
    emit("launches", main_path=launches, spmv_path=spmv_path,
         spmm_path=spmm_path)
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"the main path never launched {idle}")

    timed("tune", phase_tune, dbs[SERVE_BATCH], big)
    emit("summary", seconds=time.perf_counter() - t_start, phases=phases)
    print(json.dumps(kernels_line(cases, launches)), flush=True)

    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
