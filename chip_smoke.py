#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's three paths — the paper's loop: matrix statistics -> D_mat
rule -> run-time transform CRS -> ELL / COO / SELL / CCS / BCSR -> SpMV; the
same loop with a batch axis, where each call carries B products (SpMM,
``X: (n_cols, B)``); and the LM server, continuous-batching decode over an
int8 KV cache — through the entry points a user calls (``offline_phase``,
``Planner().plan(csr, batch=B).bind(csr) @ X``, ``ServeEngine``) at the
published sizes of the paper's Table 1, plus one matrix scaled past the
card's L2 cache, and qwen3-1.7b at full width and depth (weights from a
seed).  On the way it builds the eleven CUDA kernels from the sources in
this checkout, holds each against its plain PyTorch version on the card,
times it beside its bound, checks every served product against an
independent float64 oracle, runs the launch-geometry tuner
(``KernelTuner``) on the card, and holds one full-width decode step against
the same step with the plain attention in the kernel's place.

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
OFFLINE_FORMATS = ("ell_row", "ell_col", "coo_row", "sell", "ccs", "bcsr")
#: (matrix, scale) each kernel is timed at (it is held against its plain
#: version on every matrix of the offline and serve phases).  The last
#: exceeds the 50 MB L2, so its times are the ones a bound stated against
#: device memory applies to.
KERNEL_MATRICES = (("xenon2", 1.0), ("memplus", 1.0), ("xenon2", 4.0))
#: (matrix, scale) served through the planner; the last exceeds the 50 MB L2
SERVED = (("xenon2", 1.0), ("torso3", 1.0), ("memplus", 1.0), ("xenon2", 4.0))
#: formats forced through the planner so every kernel serves at least once
FORCED_FORMATS = ("ell_row", "ell_col", "coo_row", "coo_col", "sell", "csr",
                  "ccs", "bcsr")
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
#: the matrix whose entries the COO kernels are also checked on in every
#: order of ``suite.COO_ORDERS``, and the CCS kernels with each column's rows
#: in random order
COO_ORDER_MATRIX = ("xenon2", 1.0)
#: the heavy-tailed matrix the CSR and CCS kernels are also checked and timed
#: on (D_mat 5.72; 857 rows of 4959 entries hold half of them): only those
#: two formats, since its ELL panel would take gigabytes
HEAVY = ("torso1", 1.0)
#: the hash-scattered matrix ``ccs_spmv`` is also checked and timed on
#: (SpMV, float32; 6.1 M entries, 91 % of them outside any warp's window of
#: y rows): there the window must cost next to nothing
SCATTERED = ("viscoplastic2", 16.0)

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
    "ccs_spmv": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ccs_spmv.cu",
                 "replaces": "src/repro/kernels/ccs_spmv.py:115"},
    "ccs_spmm": {"route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/ccs_spmm.cu",
                 "replaces": "src/repro/kernels/ccs_spmv.py:176"},
    "bcsr_spmv": {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/bcsr_spmv.cu",
                  "replaces": "src/repro/kernels/bcsr_spmv.py:106"},
    "bcsr_spmm": {"route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/bcsr_spmm.cu",
                  "replaces": "src/repro/kernels/bcsr_spmv.py:175"},
    "decode_attention_int8": {
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention_int8.cu",
        "replaces": "src/repro/kernels/decode_attention.py:95"},
}
#: the SpMV and SpMM kernels (the sparse paths)
SPARSE_KERNELS = tuple(k for k in KERNEL_INFO
                       if k != "decode_attention_int8")

#: the LM the serve_lm phase serves at full width and depth, int8 KV cache
LM_ARCH = "qwen3-1.7b"
LM_SLOTS = 8
LM_MAX_LEN = 8192
#: prompt lengths the requests draw from (flash attention over a prompt
#: longer than 1024 needs a multiple of 1024, as in the reference)
LM_PROMPTS = tuple(range(1024, 6145, 1024))
LM_MAX_NEW = 32
LM_SEED = 0
#: a full-width decode step with the plain attention in the kernel's place,
#: relative to max |logits|: every attention output may differ by one
#: bfloat16 ulp (2^-8 relative) between the two, and 28 bfloat16 layers carry
#: that to the logits; a wrong head, mask or scale moves them by O(1)
LM_STEP_REL_TOL = 4e-2
#: the SpMM kernel each format's batched product launches
SPMM_KERNEL_OF = {"csr": "csr_spmm", "coo_row": "coo_spmm",
                  "coo_col": "coo_spmm", "ell_row": "ell_spmm",
                  "ell_col": "ell_spmm", "sell": "ell_spmm",
                  "ccs": "ccs_spmm", "bcsr": "bcsr_spmm"}


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


def time_events_ms(fn, reps: int = 20, warmup: int = 1) -> float:
    """Median over ``reps`` of one call between two CUDA events recorded on
    either side of it, the host's launch path included — for the plain
    versions: they read a count back from the card mid-call, so no head
    start can run ahead of them (:func:`time_ms` would double its spin up
    to its cap on every repetition), and their host path is part of what
    they cost."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
            "coo_col": T.host_csr_to_coo_col(csr).to(dev),
            "ccs": T.host_csr_to_ccs(csr).to(dev),
            "bcsr": T.host_csr_to_bcsr(csr).to(dev)}


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
    once (``4 * n_rows * B``); ``flops`` is ``2 * nnz * B`` (BCSR:
    ``2 * nblocks * b * b * B``, the block products it computes, explicit
    zeros included).  Every format the offline and serve phases run is
    here, each SELL bucket as the ELL panel it is launched on.  Also returns
    the library call (a sparse CSR product, float32 only)."""
    from repro_torch.core.formats import bcsr_fill_ratio
    from repro_torch.kernels import bcsr_spmv as K9
    from repro_torch.kernels import ccs_spmv as K7
    from repro_torch.kernels import coo_spmv as K3
    from repro_torch.kernels import csr_spmv as K2
    from repro_torch.kernels import ell_spmv as K1

    op = "spmv" if batch is None else "spmm"
    b = batch or 1
    ell, ell_plain = getattr(K1, f"ell_{op}"), getattr(K1, f"ell_{op}_plain")
    csr_k, csr_plain = getattr(K2, f"csr_{op}"), getattr(K2, f"csr_{op}_plain")
    coo_k, coo_plain = getattr(K3, f"coo_{op}"), getattr(K3, f"coo_{op}_plain")
    ccs_k, ccs_plain = getattr(K7, f"ccs_{op}"), getattr(K7, f"ccs_{op}_plain")
    bcsr_k = getattr(K9, f"bcsr_{op}")
    bcsr_plain = getattr(K9, f"bcsr_{op}_plain")
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
        if f"ell_{order}" in layouts:
            m_ell = layouts[f"ell_{order}"]
            ell_case(f"ell_{order}", m_ell.data, m_ell.cols,
                     transposed=order == "col")
    for i, bucket in enumerate(layouts["sell"].buckets if "sell" in layouts
                               else ()):
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
        if layout not in layouts:
            continue
        coo = layouts[layout]
        cd = coo.data.to(dtype)
        cases.append({
            "name": f"coo_{op}", "layout": layout,
            "kernel": lambda c=coo, d=cd: coo_k(d, c.rows, c.cols, x, n,
                                                **kw),
            "plain": lambda c=coo, d=cd: coo_plain(d, c.rows, c.cols, x, n),
            "mag": lambda c=coo, d=cd: coo_plain(d.abs(), c.rows, c.cols,
                                                 xa, n),
            "bytes": coo.nnz_pad * (val + 8) + xy_bytes, "flops": flops,
            "info": coo_segments(coo.rows, batch, block_k)})

    for layout in ("ccs", "ccs[shuffled]"):
        if layout not in layouts:
            continue
        ccs = layouts[layout]
        sd = ccs.data.to(dtype)
        cases.append({
            "name": f"ccs_{op}", "layout": layout,
            "kernel": lambda c=ccs, d=sd: ccs_k(d, c.rows, c.indptr, x, n,
                                                **kw),
            "plain": lambda c=ccs, d=sd: ccs_plain(d, c.rows, c.indptr, x,
                                                   n),
            "mag": lambda c=ccs, d=sd: ccs_plain(d.abs(), c.rows, c.indptr,
                                                 xa, n),
            "bytes": nnz * (val + 4) + 4 * (csr.n_cols + 1) + xy_bytes,
            "flops": flops,
            "info": ccs_flushes(layouts, layout, batch, block_k)})

    if "bcsr" not in layouts:
        return cases, library_of(layouts, csr, x, dtype)
    bm = layouts["bcsr"]
    bd = bm.data.to(dtype)
    nblocks, blk = int(bm.indptr[-1]), bm.block
    cases.append({
        "name": f"bcsr_{op}", "layout": "bcsr",
        "kernel": lambda: bcsr_k(bd, bm.block_cols, bm.indptr, x, n, **kw),
        "plain": lambda: bcsr_plain(bd, bm.block_cols, bm.indptr, x, n),
        "mag": lambda: bcsr_plain(bd.abs(), bm.block_cols, bm.indptr, xa, n),
        "bytes": nblocks * (blk * blk * val + 4) + 4 * (bm.n_block_rows + 1)
        + xy_bytes,
        "flops": 2 * nblocks * blk * blk * b,
        "info": {"block": blk, "nblocks": nblocks,
                 "fill_ratio": bcsr_fill_ratio(bm)}})

    return cases, library_of(layouts, csr, x, dtype)


def library_of(layouts, csr, x, dtype):
    """The library call for ``x`` (a sparse CSR product; float32 only)."""
    if dtype != torch.float32:
        return None
    m = layouts["csr"]
    a = torch.sparse_csr_tensor(m.indptr, m.cols[:csr.nnz],
                                m.data[:csr.nnz], size=csr.shape)
    return lambda: a @ x


def ccs_flushes(layouts, layout, batch, block_k):
    """K7's (``batch=None``: ``ccs_spmv_flushes``) or K8's
    (``ccs_spmm_flushes``) global atomics at this launch, counted once per
    matrix, layout, B and column tile."""
    from repro_torch.kernels.ccs_spmv import (ccs_spmm_flushes,
                                              ccs_spmv_flushes)
    memo = layouts.setdefault("flushes", {})
    key = (layout, batch, block_k)
    if key not in memo:
        m = layouts[layout]
        memo[key] = (ccs_spmv_flushes(m.rows, m.indptr, m.n_rows)
                     if batch is None else
                     ccs_spmm_flushes(m.rows, m.indptr, m.n_rows, batch,
                                      block_k=block_k))
    return memo[key]


def coo_segments(rows, batch=None, block_k=None):
    """The runs of equal rows a COO kernel flushes at its launch for
    ``batch`` (``None``: SpMV) and ``block_k``, host-computed from ``rows``:
    one per maximal run inside each warp's span (SpMV, ``32 * chunk``
    entries) or each lane group's sub-run (SpMM).  ``atomics`` is the float32
    atomics that makes (SpMM: one per run and column)."""
    from repro_torch.kernels._common import coo_launch
    from repro_torch.kernels.coo_spmv import coo_spmm_launch

    if batch is None:
        _, bn, chunk = coo_launch()
        span = 32 * chunk
    else:
        _, _, _, _, bn, span = coo_spmm_launch(batch, None, block_k)
    r = rows.cpu().numpy()
    k = np.arange(r.shape[0])
    starts = k % bn % span == 0
    starts[1:] |= r[1:] != r[:-1]
    segments = int(starts.sum())
    return {"segments": segments,
            "segments_per_block": segments / -(-r.shape[0] // bn),
            "atomics": segments * (batch or 1)}


def coo_order_results(csr, label):
    """K3 and K6 held against their plain versions on ``csr``'s entries in
    each order of ``suite.COO_ORDERS`` (one row across every block, rows
    alternating every entry, ...), both value dtypes: SpMV at the default
    launch and at each entries-per-block tile of the tuner's grid, SpMM at
    B = ``SERVE_BATCH``.  Not timed."""
    from repro_torch.core import suite
    from repro_torch.core import transform as T
    from repro_torch.core.kernel_tune import GPU_NNZ_TILES
    from repro_torch.kernels import coo_spmv as K3

    coo = T.host_csr_to_coo_row(csr)
    entries = (coo.rows[:coo.nnz].numpy(), coo.cols[:coo.nnz].numpy(),
               coo.data[:coo.nnz].float().numpy())
    dev = torch.device("cuda")
    results = []
    for i, order in enumerate(suite.COO_ORDERS):
        rows, cols, data, n = suite.coo_entries(*entries, csr.n_rows, order,
                                                seed=i)
        rows = torch.from_numpy(rows).to(dev)
        cols = torch.from_numpy(cols).to(dev)
        data = torch.from_numpy(data).to(dev)
        rng = np.random.default_rng(4321 + i)
        for dtype in (torch.float32, torch.bfloat16):
            d = data.to(dtype)
            for batch in (None, SERVE_BATCH):
                shape = (csr.n_cols,) if batch is None else (csr.n_cols,
                                                             batch)
                x = torch.from_numpy(rng.normal(size=shape).astype(
                    np.float32)).to(dev).to(dtype)
                kern, plain = ((K3.coo_spmv, K3.coo_spmv_plain)
                               if batch is None
                               else (K3.coo_spmm, K3.coo_spmm_plain))
                tiles = (None,) + GPU_NNZ_TILES if batch is None else (None,)
                for bn in tiles:
                    case = {
                        "name": kern.__name__, "layout": f"coo[{order}]",
                        "kernel": lambda x=x, bn=bn: kern(d, rows, cols, x,
                                                          n, block_nnz=bn),
                        "plain": lambda x=x: plain(d, rows, cols, x, n),
                        "mag": lambda x=x: plain(d.abs(), rows, cols,
                                                 x.abs(), n)}
                    if bn is None:
                        case["info"] = coo_segments(rows, batch)
                    extra = {} if batch is None else {"batch": batch}
                    if bn is not None:
                        extra["block_nnz"] = bn
                    results += check_cases([case], None, label,
                                           int(rows.shape[0]), dtype, False,
                                           REPS, **extra)
        del rows, cols, data
    return results


def shuffled_ccs(ccs, seed):
    """``ccs`` with each column's entries in random order (the kernels take
    any order within a column); the pads stay last."""
    import dataclasses

    ip = ccs.indptr.cpu().numpy()
    nnz = int(ip[-1])
    col = np.repeat(np.arange(ip.shape[0] - 1), np.diff(ip))
    perm = np.lexsort((np.random.default_rng(seed).random(nnz), col))
    perm = torch.from_numpy(np.concatenate(
        [perm, np.arange(nnz, ccs.rows.shape[0])])).to(ccs.rows.device)
    return dataclasses.replace(ccs, rows=ccs.rows[perm].contiguous(),
                               data=ccs.data[perm].contiguous())


def shuffled_ccs_results(csr, layouts, label):
    """K7 and K8 held against their plain versions on ``csr``'s CCS with
    each column's rows shuffled: SpMV, and SpMM at B = 8 (a lane group a
    column) and ``SERVE_BATCH`` (the shared window), both value dtypes.  Not
    timed."""
    mine = {"csr": layouts["csr"],
            "ccs[shuffled]": shuffled_ccs(layouts["ccs"], 17)}
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (None, 8, SERVE_BATCH):
            cases, _ = kernel_cases(csr, mine, dtype, batch)
            extra = {} if batch is None else {"batch": batch}
            results += check_cases(
                [c for c in cases if c["name"].startswith("ccs")], None,
                label, csr.nnz, dtype, False, REPS, **extra)
    return results


def ell_nonfinite_results(csr, layouts, label):
    """K4 held against its plain version where ``X[0, :]`` cycles through
    +inf, 1.5, -inf and NaN: the kernel gathers no X row for a padded
    ``(0, column 0)`` slot and adds ``0 * X[0]`` once a row, so NaN must sit
    exactly where the plain version has it (the rows whose band holds such a
    slot, where ``X[0, b]`` is not finite), infinities too; the finite
    values are held to ``KERNEL_REL_TOL``.  ELL-Row, ELL-Col and each SELL
    bucket, B = 1, 8 and ``SERVE_BATCH``, both value dtypes.  Not timed."""
    from repro_torch.kernels import ell_spmv as K1

    panels = [("ell_row", layouts["ell_row"].data, layouts["ell_row"].cols),
              ("ell_col", layouts["ell_col"].data.t(),
               layouts["ell_col"].cols.t())]
    panels += [(f"sell[{i}]", b.data, b.cols)
               for i, b in enumerate(layouts["sell"].buckets)]
    rng = np.random.default_rng(99)
    results = []
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (1, 8, SERVE_BATCH):
            x = rng.normal(size=(csr.n_cols, batch)).astype(np.float32)
            x[0] = np.resize(np.array([np.inf, 1.5, -np.inf, np.nan],
                                      np.float32), batch)
            x = torch.from_numpy(x).to("cuda").to(dtype)
            xa = torch.where(torch.isfinite(x), x, 0.0).abs()
            for layout, d, c in panels:
                d = d.to(dtype)
                got = K1.ell_spmm(d, c, x)
                want = K1.ell_spmm_plain(d, c, x)
                mag = K1.ell_spmm_plain(d.abs(), c, xa)
                torch.cuda.synchronize()
                fin = torch.isfinite(want)
                same = (torch.equal(torch.isnan(got), torch.isnan(want))
                        and torch.equal(torch.isinf(got), torch.isinf(want))
                        and torch.equal(got[torch.isinf(want)],
                                        want[torch.isinf(want)]))
                err = (got[fin] - want[fin]).abs()
                rel = float((err / (mag[fin] + 1e-30)).max()) if err.numel() \
                    else 0.0
                if not same or rel > KERNEL_REL_TOL:
                    raise AssertionError(
                        f"ell_spmm/{layout} {label} {dtype} B={batch}, "
                        f"non-finite X[0]: NaN or inf placed apart from the "
                        f"plain version's ({same}) or rel err {rel}")
                results.append({
                    "name": "ell_spmm", "layout": f"{layout}[x0 non-finite]",
                    "matrix": label, "batch": batch,
                    "dtype": str(dtype).replace("torch.", ""),
                    "n_rows": int(got.shape[0]), "nnz": csr.nnz,
                    "nan_rows": int(torch.isnan(want).any(dim=1).sum()),
                    "max_abs_err": float(err.max()) if err.numel() else 0.0,
                    "max_rel_err": rel, "tolerance": KERNEL_REL_TOL})
                del got, want, mag
    if not any(r["nan_rows"] for r in results):
        raise AssertionError("ell_spmm: no padded slot met a non-finite "
                             "X[0]; the check has no case")
    return results


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
            "tolerance": tol, **case.get("info", {})}
        del y_k, y_p, mag, err
        if timed and not layout.startswith("sell"):
            b_ms, b_by = bound(case["bytes"], case["flops"])
            result.update({
                "ms": time_ms(case["kernel"], reps),
                "ms_cold_l2": time_ms(case["kernel"], reps, cold=True),
                "plain_ms": time_events_ms(case["plain"], reps),
                "bound_ms": b_ms, "bound_by": b_by,
                "bytes": case["bytes"], "library_ms": library_ms})
        results.append(result)
    return results


def phase_kernels(reps: int):
    """Hold every kernel against its plain version on every matrix the main
    path runs (all its formats, both value dtypes; the SpMM kernels at each
    B of ``SPMM_CHECKED``, and on ``BIG`` at B = ``SERVE_BATCH`` also at
    each column tile the tuner's grid launches; the COO kernels also on
    ``COO_ORDER_MATRIX``'s entries in every adversarial order, the CCS
    kernels on its columns with their rows shuffled, K4 with a non-finite
    ``X[0]``; the CSR and CCS kernels on ``HEAVY``, K7 on ``SCATTERED``);
    time the SpMV cases of ``KERNEL_MATRICES``, ``HEAVY`` and ``SCATTERED``
    and the SpMM cases of ``BIG`` and ``HEAVY`` at each B of
    ``SPMM_TIMED``.  The phase line also gives the seconds spent on
    each matrix."""
    from repro_torch.core import suite
    from repro_torch.core import transform as T
    from repro_torch.core.kernel_tune import GPU_K_TILES

    specs = {s.name: s for s in suite.TABLE1}
    todo = [(name, 1.0) for name in OFFLINE_MATRICES]
    for matrix in SERVED + KERNEL_MATRICES:
        if matrix not in todo:
            todo.append(matrix)
    results, seconds = [], {}
    for name, scale in todo:
        t0 = time.perf_counter()
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
        if (name, scale) == COO_ORDER_MATRIX:
            results += coo_order_results(csr, label)
            results += shuffled_ccs_results(csr, layouts, label)
            results += ell_nonfinite_results(csr, layouts, label)
        del csr, layouts
        torch.cuda.empty_cache()
        seconds[label] = time.perf_counter() - t0
    # the heavy-tailed matrix: CSR and CCS only, every case timed
    t0 = time.perf_counter()
    csr = suite.synthesize(specs[HEAVY[0]], scale=HEAVY[1])
    layouts = {"csr": csr.to("cuda"),
               "ccs": T.host_csr_to_ccs(csr).to("cuda")}
    label = matrix_label(*HEAVY)
    for dtype in (torch.float32, torch.bfloat16):
        cases, library = kernel_cases(csr, layouts, dtype)
        results += check_cases(cases, library, label, csr.nnz, dtype, True,
                               reps)
        for batch in SPMM_CHECKED:
            cases, library = kernel_cases(csr, layouts, dtype, batch)
            results += check_cases(cases, library, label, csr.nnz, dtype,
                                   batch in SPMM_TIMED, reps, batch=batch)
    del csr, layouts
    torch.cuda.empty_cache()
    seconds[label] = time.perf_counter() - t0
    # the scattered matrix: K7 alone, float32 SpMV, timed
    t0 = time.perf_counter()
    csr = suite.synthesize(specs[SCATTERED[0]], scale=SCATTERED[1])
    layouts = {"csr": csr.to("cuda"),
               "ccs": T.host_csr_to_ccs(csr).to("cuda")}
    label = matrix_label(*SCATTERED)
    cases, library = kernel_cases(csr, layouts, torch.float32)
    results += check_cases([c for c in cases if c["name"] == "ccs_spmv"],
                           library, label, csr.nnz, torch.float32, True, reps)
    del csr, layouts, cases, library
    torch.cuda.empty_cache()
    seconds[label] = time.perf_counter() - t0
    emit("kernels", seconds=seconds, cases=results)
    return results


def kernels_line(cases, k11_cases, launches):
    """One entry per kernel.  A sparse kernel's float32 case on xenon2 at
    scale 4 — past the L2, where the card does real memory work (ELL:
    row-major, the layout the paper's rule serves; SpMM at B =
    ``SERVE_BATCH``) — carries the times; K11's served case (the shape and
    sequence lengths of the serve_lm phase).  The error is the largest over
    all of the kernel's cases (listed by the ``kernels`` and
    ``decode_attention`` phase lines).  ``launches`` is the count from the
    run of the path the kernel serves."""
    out = []
    for kname in SPARSE_KERNELS:
        info = KERNEL_INFO[kname]
        mine = [c for c in cases if c["name"] == kname]
        head = next(c for c in mine if c["matrix"] == matrix_label(*BIG)
                    and c["dtype"] == "float32"
                    and c.get("batch", SERVE_BATCH) == SERVE_BATCH
                    and "block_k" not in c
                    and c["layout"] in ("ell_row", "csr", "coo_row", "ccs",
                                        "bcsr"))
        shape = {k: head[k] for k in ("matrix", "layout", "dtype", "n_rows",
                                      "nnz", "batch", "block", "nblocks",
                                      "fill_ratio") if k in head}
        out.append({
            "name": kname, **info, "launches": launches[kname],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": shape,
            "cases_checked": len(mine)})
    head = k11_cases[0]
    out.append({
        "name": "decode_attention_int8", **KERNEL_INFO["decode_attention_int8"],
        "launches": launches["decode_attention_int8"],
        "max_abs_err": max(c["max_abs_err"] for c in k11_cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": {k: head[k] for k in ("case", "B", "S", "KV", "G", "Dh",
                                       "window", "dtype")},
        "cases_checked": len(k11_cases)})
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


#: host seconds of each (matrix, recipe) transform, timed once for both
#: serve phases
_T_TRANS = {}


def trans_seconds(plan, csr, label):
    """Host seconds of ``plan``'s transform of ``csr`` (0 for CSR), timed
    once per matrix and recipe."""
    from repro_torch.core.autotune import time_host
    if plan.fmt == "csr":
        return 0.0
    key = (label, json.dumps(plan.transform.to_dict(), sort_keys=True))
    if key not in _T_TRANS:
        _T_TRANS[key] = time_host(plan.transform.apply, csr, iters=1)
    return _T_TRANS[key]


def serve_one(api, planner, csr, label, plan_kw, iters):
    from repro_torch import kernels
    from repro_torch.core.autotune import time_fn

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
    t_trans = trans_seconds(plan, csr, label)
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
    from repro_torch.core.autotune import time_fn

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
    t_trans = trans_seconds(plan, csr, label)
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
# phase: decode_attention (K11 against its plain version)
# ---------------------------------------------------------------------------
def lm_prompt_lengths():
    """The serve_lm phase's prompt lengths, drawn from ``LM_SEED``."""
    rng = np.random.default_rng(LM_SEED)
    return [int(n) for n in rng.choice(LM_PROMPTS, size=LM_SLOTS)]


#: (label, B, S, KV, G, Dh, window, q dtype, logit softcap): the first is
#: the shape the serve_lm phase launches K11 at (qwen3-1.7b, 8 slots of 8192,
#: bfloat16 q); the softcap cases cap the scores (of about one unit here)
#: at 1.0, so that the cap bends most of them
K11_CASES = (
    ("served", 8, 8192, 8, 2, 128, None, torch.bfloat16, 0.0),
    ("served_f32", 8, 8192, 8, 2, 128, None, torch.float32, 0.0),
    ("window", 8, 8192, 8, 2, 128, 4096, torch.bfloat16, 0.0),
    ("g1", 8, 8192, 8, 1, 128, None, torch.bfloat16, 0.0),
    ("g6", 4, 4096, 4, 6, 128, None, torch.bfloat16, 0.0),
    ("ragged", 8, 8000, 8, 2, 128, None, torch.bfloat16, 0.0),
    ("ragged_f32_window", 3, 1000, 2, 3, 64, 256, torch.float32, 0.0),
    ("softcap", 8, 8192, 8, 2, 128, None, torch.bfloat16, 1.0),
    ("softcap_f32_window", 3, 1000, 2, 3, 64, 256, torch.float32, 1.0),
)


def k11_inputs(B, S, KV, G, Dh, q_dtype, lens, seed):
    """Random int8 codes, bfloat16 scales and q on the card; sequence b
    holds positions 0 .. lens[b] - 1 and queries at lens[b] - 1."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = lambda: torch.randint(-127, 128, (B, S, KV, Dh), generator=g,
                                  device=dev, dtype=torch.int8)
    scales = lambda: (torch.rand((B, S, KV), generator=g, device=dev)
                      * 0.02).to(torch.bfloat16)
    q = torch.randn((B, KV, G, Dh), generator=g, device=dev).to(q_dtype)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    idx = torch.arange(S, dtype=torch.int32, device=dev)
    key_pos = torch.where(idx[None, :] < lens_t[:, None], idx[None, :],
                          torch.full_like(idx[None, :], -1))
    return [q, codes(), scales(), codes(), scales(), key_pos.contiguous(),
            lens_t - 1]


def k11_bytes_flops(args, window):
    """What one call must move and compute on these inputs: a sequence with
    a valid slot needs the codes and scales of its valid slots only (a
    masked slot's weight is exactly 0); one with none needs every slot's V
    (its output is their mean); plus key_pos, q_pos, q and the output.
    Also the bytes of the whole cache, which the kernel reads."""
    q, k_q, _, _, _, key_pos, q_pos = args
    B, S, KV, Dh = k_q.shape
    G = q.shape[2]
    valid = (key_pos >= 0) & (key_pos <= q_pos[:, None])
    if window is not None:
        valid &= key_pos > (q_pos[:, None] - window)
    n_valid = valid.sum(dim=1).tolist()
    per_slot = KV * (2 * Dh + 2 * 2)           # K and V codes, two scales
    io = 4 * B * S + 4 * B + 2 * q.numel() * q.element_size()
    needed = io + sum(n * per_slot if n else S * KV * (Dh + 2)
                      for n in n_valid)
    flops = sum(4 * KV * G * Dh * (n or S) for n in n_valid)
    return needed, flops, io + B * S * per_slot


#: bfloat16 outputs: besides one bfloat16 ulp, the float32 sums' own error
#: before the rounding — near zero (a mean of +-v over thousands of slots
#: cancels) it exceeds one bfloat16 ulp of the value
K11_BF16_ATOL = 1e-6


def k11_close(got, want, q_dtype):
    """``(max_abs_err, ok)``: float32 q within 2e-4 + 2e-4 |want| (the
    reference's tolerance); bfloat16 q within one bfloat16 ulp of the larger
    of the two plus ``K11_BF16_ATOL`` (both round float32 values that differ
    only in summation order)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if q_dtype == torch.float32:
        ok = bool((err <= 2e-4 + 2e-4 * want.abs()).all())
    else:
        ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(
            got.abs(), want.abs()).clamp_min(
                torch.finfo(torch.float32).tiny))) - 7)
        ok = bool((err <= ulp + K11_BF16_ATOL).all())
    return float(err.max()), ok


def phase_decode_attention(reps: int):
    """K11 against its plain version on the card at the served shape (with
    the serve_lm phase's sequence lengths, mid-decode) and at the others of
    ``K11_CASES``; each timed beside its bound and the plain version."""
    from repro_torch.kernels import decode_attention as K11

    results = []
    for i, (label, B, S, KV, G, Dh, window, q_dtype, cap) in enumerate(
            K11_CASES):
        if label.startswith("served"):
            lens = [n + LM_MAX_NEW // 2 for n in lm_prompt_lengths()]
        else:
            lens = np.random.default_rng(100 + i).integers(
                S // 2, S, size=B).tolist()
        args = k11_inputs(B, S, KV, G, Dh, q_dtype, lens, 200 + i)
        kw = {"window": window, "softcap": cap}
        got = K11.decode_attention_int8(*args, **kw)
        want = K11.decode_attention_int8_plain(*args, **kw)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != q_dtype or \
                not bool(torch.isfinite(got).all()):
            raise AssertionError(f"decode_attention_int8 {label}: bad output "
                                 f"{tuple(got.shape)} {got.dtype}")
        err, ok = k11_close(got, want, q_dtype)
        if not ok:
            raise AssertionError(f"decode_attention_int8 {label}: kernel "
                                 f"disagrees with its plain version "
                                 f"(max abs err {err})")
        needed, flops, full = k11_bytes_flops(args, window)
        b_ms, b_by = bound(needed, flops)
        results.append({
            "name": "decode_attention_int8", "case": label, "B": B, "S": S,
            "KV": KV, "G": G, "Dh": Dh, "window": window, "softcap": cap,
            "dtype": str(q_dtype).replace("torch.", ""), "lens": lens,
            "max_abs_err": err,
            "tolerance": "2e-4" if q_dtype == torch.float32
            else f"1 bf16 ulp + {K11_BF16_ATOL}",
            "ms": time_ms(lambda: K11.decode_attention_int8(*args, **kw),
                          reps),
            "ms_cold_l2": time_ms(lambda: K11.decode_attention_int8(
                *args, **kw), reps, cold=True),
            "plain_ms": time_events_ms(lambda: K11.decode_attention_int8_plain(
                *args, **kw), reps),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": needed,
            "bound_ms_whole_cache": full / PEAK_BYTES_PER_S * 1e3,
            "bytes_whole_cache": full, "library_ms": None})
        del args, got, want
    torch.cuda.empty_cache()
    emit("decode_attention", cases=results)
    return results


# ---------------------------------------------------------------------------
# phase: serve_lm (the LM server at full width, int8 KV cache)
# ---------------------------------------------------------------------------
def clone_caches(caches):
    return {"layers": [{"attn": {n: t.clone() for n, t in c["attn"].items()}}
                       for c in caches["layers"]]}


def decode_step_bytes(cfg, lengths, slots):
    """Bytes one decode step must move: every matmul weight once (bfloat16),
    the norm scales, the B token embeddings read and, per layer, the valid
    slots' int8 codes and bfloat16 scales of K and V (the new token's
    included) — the least a step at these lengths needs."""
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import tree_leaves
    weights = 0
    for s in tree_leaves({k: v for k, v in M.model_spec(cfg).items()
                          if k != "embed"}):
        weights += int(np.prod(s.shape)) * (4 if len(s.shape) == 1 else 2)
    B = len(lengths)
    embed = B * cfg.d_model * 2
    per_slot = cfg.n_kv_heads * (2 * cfg.head_dim + 2 * 2)
    cache = cfg.n_layers * per_slot * sum(min(n + 1, slots)
                                          for n in lengths)
    return weights + embed + cache, weights


def profile_decode(params, cfg, snapshot, steps: int = 2):
    """``torch.profiler`` over ``steps`` decode steps from a copy of
    ``snapshot``: the card's busy time and the kernels launched per step,
    and the kernels that take most of the busy time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as M

    caches, toks, lengths = snapshot
    caches = clone_caches(caches)
    toks = torch.from_numpy(toks).long().cuda()
    pos = torch.from_numpy(lengths).cuda()
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            M.decode_step(params, toks, caches, pos + i, cfg)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)
    # the kernels themselves (an operator's row repeats its kernels' time)
    busy = [(e.key, dev_us(e), e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and dev_us(e) > 0]
    busy.sort(key=lambda t: -t[1])
    total = sum(t[1] for t in busy)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                "cuLaunchKernel"))
    return {"steps": steps, "device_ms_per_step": total / 1e3 / steps,
            "launches_per_step": launches / steps,
            "top_kernels": [{"name": k[:80], "ms_per_step": us / 1e3 / steps,
                             "share": us / total, "calls_per_step":
                             n / steps} for k, us, n in busy[:10]]}


def phase_serve_lm():
    """``ServeEngine`` at full width and depth on the card: 8 requests into
    8 slots of ``LM_MAX_LEN``, prompts drawn from ``LM_PROMPTS``,
    ``LM_MAX_NEW`` tokens each.  The K11 launches are counted from just
    before the requests are admitted to just after the last step; then one
    decode step (from a snapshot taken before the first) is held against
    the same step with the plain attention in the kernel's place."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as K11
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine

    # on by default: cuBLAS may reduce bfloat16 products in bfloat16; off
    # here, so the served numbers are those of float32 reductions
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(LM_ARCH).replace(kv_quant=True)
    dev = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(LM_SEED),
                    device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(params, cfg, max_batch=LM_SLOTS, max_len=LM_MAX_LEN,
                      device=dev)
    rng = np.random.default_rng(LM_SEED + 1)
    lens = lm_prompt_lengths()
    for n in lens:
        eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=LM_MAX_NEW)

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._admit()              # one prefill per request, caches copied in
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    snapshot = (clone_caches(eng.caches), eng.last_tokens.copy(),
                eng.lengths.copy())
    step_ms, step_tokens, step_bytes = [], [], []
    while any(r is not None for r in eng.active):
        lengths = eng.lengths.tolist()
        t0 = time.perf_counter()
        n = eng.step()        # reads the tokens back: the card is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_tokens.append(n)
        step_bytes.append(decode_step_bytes(cfg, lengths, LM_MAX_LEN)[0])
    lm_path = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = len(step_ms)
    if lm_path["decode_attention_int8"] != cfg.n_layers * steps:
        raise AssertionError(
            f"serve_lm: {lm_path['decode_attention_int8']} K11 launches for "
            f"{steps} decode steps of {cfg.n_layers} layers")
    done = eng.finished
    if len(done) != LM_SLOTS or any(
            len(r.generated) != LM_MAX_NEW or not r.done or
            not all(0 <= t < cfg.vocab_size for t in r.generated)
            for r in done.values()):
        raise AssertionError("serve_lm: a request did not finish with "
                             f"{LM_MAX_NEW} tokens in the vocabulary")

    # one full-width step: K11 against its plain version in its place
    caches, toks, lengths = snapshot
    toks = torch.from_numpy(toks).long().to(dev)
    pos = torch.from_numpy(lengths).to(dev)
    with torch.no_grad():
        logits_k, _ = M.decode_step(params, toks, clone_caches(caches), pos,
                                    cfg)
        A.decode_attention_int8 = (
            lambda *a, **kw: K11.decode_attention_int8_plain(*a, **kw))
        try:
            logits_p, _ = M.decode_step(params, toks, caches, pos, cfg)
        finally:
            A.decode_attention_int8 = K11.decode_attention_int8
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        reduced
    lk, lp = logits_k.float(), logits_p.float()
    if lk.shape != (LM_SLOTS, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"serve_lm: bad logits {tuple(lk.shape)}")
    rel = float((lk - lp).abs().max() / lp.abs().max())
    if rel > LM_STEP_REL_TOL:
        raise AssertionError(f"serve_lm: the decode step with K11 is "
                             f"{rel} (of max |logits|) off the plain step")
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    trace = profile_decode(params, cfg, snapshot)
    first_step = [r.generated[1] for r in sorted(done.values(),
                                                 key=lambda r: r.rid)]

    decode_s = sum(step_ms) / 1e3
    decode_tokens = sum(step_tokens)
    generated = sum(len(r.generated) for r in done.values())
    _, weight_bytes = decode_step_bytes(cfg, [0] * LM_SLOTS, LM_MAX_LEN)
    whole_cache = cfg.n_layers * LM_SLOTS * LM_MAX_LEN * cfg.n_kv_heads * (
        2 * cfg.head_dim + 4)
    out = {
        "arch": LM_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
        "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
        "kv_quant": True, "n_params": M.n_params(cfg), "slots": LM_SLOTS,
        "max_len": LM_MAX_LEN, "prompt_lengths": lens,
        "max_new_tokens": LM_MAX_NEW,
        "bf16_reduced_precision_reduction": False,
        "t_init_s": t_init,
        "prefill_ms_per_request": t_prefill * 1e3 / LM_SLOTS,
        "prefill_tokens_per_s": sum(lens) / t_prefill,
        "decode_steps": steps,
        "decode_ms_per_step": decode_s * 1e3 / steps,
        "decode_ms_median": statistics.median(step_ms),
        "decode_ms_steps": step_ms,
        "decode_tokens_per_s": decode_tokens / decode_s,
        "tokens_per_s": generated / (t_prefill + decode_s),
        "generated_tokens": generated,
        "peak_memory_gb": peak / 1e9,
        "step_bound_ms": sum(step_bytes) / steps / PEAK_BYTES_PER_S * 1e3,
        "step_bytes_mean": sum(step_bytes) / steps,
        "weight_bytes": weight_bytes, "whole_cache_bytes": whole_cache,
        "step_bound_ms_whole_cache": (weight_bytes + whole_cache)
        / PEAK_BYTES_PER_S * 1e3,
        "trace": trace,
        # the card's idle share of a decode step: 1 - busy time / step time
        "idle_share": 1.0 - trace["device_ms_per_step"]
        / statistics.median(step_ms),
        "k11_launches": lm_path["decode_attention_int8"],
        "k11_launches_per_step": lm_path["decode_attention_int8"] / steps,
        "step_vs_plain": {"max_rel_err": rel, "tolerance": LM_STEP_REL_TOL,
                          "argmax_agree": agree,
                          "argmax_is_served_token": float(np.mean(
                              [a == b for a, b in zip(
                                  lk.argmax(-1)[:, 0].tolist(),
                                  first_step)]))}}
    emit("serve_lm", **out)
    del eng, params, snapshot, caches, logits_k, logits_p
    torch.cuda.empty_cache()
    return out, lm_path


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
    k11_cases = timed("decode_attention", phase_decode_attention, REPS)

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
    timed("tune", phase_tune, dbs[SERVE_BATCH], big)
    del big, dbs, db, mats
    torch.cuda.empty_cache()
    # the LM server, counted on its own inside the phase
    lm, lm_path = timed("serve_lm", phase_serve_lm)
    launches = {k: (spmm_path if k.endswith("_spmm") else spmv_path)[k]
                for k in SPARSE_KERNELS}
    launches["decode_attention_int8"] = lm_path["decode_attention_int8"]
    emit("launches", main_path=launches, spmv_path=spmv_path,
         spmm_path=spmm_path, lm_path=lm_path,
         lm_decode_steps=lm["decode_steps"],
         k11_per_decode_step=lm["k11_launches_per_step"])
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"the main path never launched {idle}")

    emit("summary", seconds=time.perf_counter() - t_start, phases=phases)
    print(json.dumps(kernels_line(cases, k11_cases, launches)), flush=True)

    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
