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
(``KernelTuner``) on the card, serves the register-once service
(``SpMVService``), its streaming keys (deltas applied on the card,
``apply_delta``) and the sharded tier (``plan_sharded``, shard by shard,
then ``shard_map`` in a world of two ranks on the one card over ``gloo``,
which also trains qwen3-1.7b at full width on a 2x1 mesh against one
rank); then serves one model of each LM family at full width (qwen3-1.7b,
zamba2-1.2b and xlstm-1.3b whole, dbrx-132b cut to 2 layers with the
paper's dispatch rule on) and holds one decode step of each against the
same step with the plain attention in the kernel's place; then trains
(``Trainer``, autograd through every block kind, AdamW): five smoke models'
steps held against the host's, qwen3-1.7b and zamba2-1.2b whole at full
width in float32 masters and bf16, and a restart drill from a checkpoint.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

#: H100 SXM data-sheet peaks the bounds are stated against
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

REPS = 10     # timed repetitions per kernel case (median)
#: timed repetitions of a sparse kernel's plain version (10-400x slower than
#: the kernel, so a median of a few settles it)
PLAIN_REPS = 3
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
OFFLINE_FORMATS = ("ell_row", "ell_col", "coo_row", "sell", "ccs", "bcsr",
                   "hybrid")
#: (matrix, scale) each kernel is timed at (it is held against its plain
#: version on every matrix of the offline and serve phases): past the 50 MB
#: L2, so its times are the ones a bound stated against device memory
#: applies to.
KERNEL_MATRICES = (("xenon2", 4.0),)
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
#: the heavy-tailed matrix the CSR, CCS and BCSR kernels are also checked
#: and timed on (D_mat 5.72; 857 rows of 4959 entries hold half of them):
#: only those formats, since its ELL panel would take gigabytes
HEAVY = ("torso1", 1.0)
#: the hash-scattered matrix ``ccs_spmv`` (SpMV, float32; 6.1 M entries,
#: 91 % of them outside any warp's window of y rows), ``csr_spmm`` (its
#: blocks keep no window of X rows) and ``bcsr_spmm`` (3 % of its blocks'
#: scalars are entries, 1.7 a block) are also checked and timed on: there a
#: window must cost next to nothing, and a block product next to nothing
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

#: the LM servers of the serve_families phase, bf16 with the int8 KV cache:
#: (arch, layers (None: the config's), slots, max_len, prompt lengths the
#: requests draw from, new tokens, moe_dispatch, dtype of the decode step
#: held against the plain one).  qwen3-1.7b whole (the attention family;
#: its K11 launches are the main path's), dbrx cut to 2 of its 40 layers
#: (7.75 G parameters), zamba2 and xLSTM whole; prompts as flash attention
#: (a multiple of 1024 past 1024) and the chunked SSD (a multiple of 256
#: past 256) take them, xLSTM's short (its prefill is a loop over time).
#: zamba2's step is held in float32: with seeded weights each of the six
#: applications of its shared attention block grows a difference of its
#: input, so half a bfloat16 ulp of noise on the plain attention's outputs
#: moves the bfloat16 logits by ~0.45 of theirs
#: (experiments/torch_lm_step_divergence.py, PERF.md §6); its bfloat16 K11
#: calls are held one by one (``hold_family_step``) and at its shape in the
#: decode_attention phase
FAMILIES = (
    ("qwen3-1.7b", None, 8, 8192, tuple(range(1024, 6145, 1024)), 32, None,
     torch.bfloat16),
    ("dbrx-132b", 2, 8, 4096, (512, 768, 1024, 2048), 16, "auto",
     torch.bfloat16),
    ("zamba2-1.2b", None, 8, 2048, (256, 512, 768, 1024), 32, None,
     torch.float32),
    ("xlstm-1.3b", None, 4, 256, (32, 64, 96, 128), 16, None, None),
)
#: the family whose K11 launches the kernels line reports
LM_ARCH = "qwen3-1.7b"
FAMILY_SEED = 1
#: a full-width decode step with the plain attention in the kernel's place,
#: relative to max |logits|: every attention output may differ by one
#: bfloat16 ulp (2^-8 relative) between the two, and 28 bfloat16 layers carry
#: that to the logits; a wrong head, mask or scale moves them by O(1)
LM_STEP_REL_TOL = 4e-2
#: the train phase's held steps: the archs whose grads the reference's
#: smoke test takes (smoke configs, float32, TF32 off), each with the
#: tolerances of tests/test_torch_train_model.py: a gradient leaf (and a
#: parameter leaf after one AdamW step) relative to its max magnitude, and
#: a looser one by the leaf's path suffix.  gemma3 without its qk-norm at
#: 5e-2: a one-ulp perturbation of these masters moves its grads by up to
#: 2.4e-2; with it, 1e-4.  zamba2's per-channel SSM leaves at 4e-4: the
#: reference's own jitted and op-by-op grads differ there by 1.4e-4
#: (experiments/torch_train_grad_spread.py reads both)
SSM_LOOSE = {f"mamba/{k}": 4e-4 for k in ("D", "A_log", "dt_bias", "norm")}
TRAIN_HELD = (("qwen3-1.7b", {}, 1e-4, {}), ("gemma3-12b", {}, 5e-2, {}),
              ("gemma3-12b", {"qk_norm": True}, 1e-4, {}),
              ("dbrx-132b", {}, 1e-4, {}),
              ("zamba2-1.2b", {}, 1e-4, SSM_LOOSE),
              ("xlstm-1.3b", {}, 1e-4, {}))
#: a held step's loss, relative
TRAIN_LOSS_RTOL = 1e-4
#: whole models trained at full width: (arch, batch, seq, steps, whether
#: the last step's loss must be below the first's: the motif data is
#: learnable); float32 masters, bf16 compute, remat "full", SyntheticLM
#: seed 0, no checkpoint
TRAIN_FULL = (("qwen3-1.7b", 8, 1024, 8, True), ("zamba2-1.2b", 4, 512, 4,
                                                 False))
#: H100 SXM data-sheet dense bf16 peak, the MFU's and the step bound's
PEAK_BF16_FLOPS = 989e12
#: (matrix, scale) served as hybrid plans (``None``: the power-law matrix
#: ``synthesize_power_law(n=8192, alpha=1.3)``), with the four partition
#: strategies of ``benchmarks/hybrid_blocks.py``'s sweep
HYBRID_MATRICES = (("memplus", 1.0), ("torso1", 1.0), None, ("xenon2", 4.0))
HYBRID_SWEEP = (("fixed_256", "fixed", {"block_rows": 256}),
                ("fixed_1024", "fixed", {"block_rows": 1024}),
                ("balanced_8", "balanced_nnz", {"n_blocks": 8}),
                ("variance_16", "variance", {"max_blocks": 16,
                                             "min_rows": 64}))
#: launches per timing in the serve_hybrid phase (a product there is up to
#: thousands of launches)
HYBRID_ITERS = 3
#: a call whose host enqueue takes longer than this outruns the longest head
#: start of ``autotune.time_device``: its device time is not measured
HYBRID_MAX_ENQUEUE_S = 0.05
#: the SpMV kernel a block of each format a hybrid container holds (CSR and
#: ``partition.hybrid.BLOCK_FORMATS``) launches (SELL: once a bucket)
SPMV_KERNEL_OF = {"csr": "csr_spmv", "coo_row": "coo_spmv",
                  "coo_col": "coo_spmv", "ell_row": "ell_spmv",
                  "ell_col": "ell_spmv", "sell": "ell_spmv",
                  "ccs": "ccs_spmv", "bcsr": "bcsr_spmv"}
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


def device_normal(shape, seed: int) -> torch.Tensor:
    """Standard normal float32 values of ``shape`` made on the card from
    ``seed`` (the host's generator takes seconds for an ``(n_cols, 128)``
    panel of a matrix past the L2)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda")


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


def kernel_cases(csr, layouts, dtype, batch=None, block_k=None,
                 with_band=False):
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
    here, each SELL bucket as the ELL panel it is launched on.  The ELL SpMV
    cases read each row up to its live extent, as the main path's bound
    panels do: their ``bytes`` count the live slots, the extents, x and y
    (``bound_ms_panel``: the whole band's); ``with_band`` adds each panel
    read whole.  The CSR SpMM cases carry the entries their windows miss
    (``csr_spmm_window_misses``).  Also returns the library call (a sparse
    CSR product, float32 only)."""
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
    shape = (csr.n_cols,) if batch is None else (csr.n_cols, batch)
    x = device_normal(shape, 1234 + b).to(dtype)
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
        panel = rows * width * (val + 4) + xy_bytes
        if batch is not None:
            cases.append({
                "name": "ell_spmm", "layout": layout,
                "kernel": lambda: ell(d, c, x, **kw),
                "plain": lambda: ell_plain(d, c, x),
                "mag": lambda: ell_plain(d.abs(), c, xa),
                "bytes": panel, "flops": flops})
            return
        # K1 as the main path launches it: each row up to its live extent
        # where that pays (kernels.ops.prepare decides at bind time), else
        # the whole band; with_band adds each reading forced
        ext = K1.ell_extent(d, c)
        live = int(ext.sum())

        def add(tag, e):
            cases.append({
                "name": "ell_spmv", "layout": layout + tag,
                "kernel": lambda: ell(d, c, x, extent=e, **kw),
                "plain": lambda: ell_plain(d, c, x, e),
                "mag": lambda: ell_plain(d.abs(), c, xa),
                "bytes": panel if e is None
                else live * (val + 4) + 4 * rows + xy_bytes,
                "flops": flops,
                "info": {"live_slots": live, "slots": rows * width,
                         "extent_read": e is not None,
                         "bound_ms_panel": panel / PEAK_BYTES_PER_S * 1e3}})
        add("", ext if K1.extent_pays(ext, width) else None)
        if with_band:
            add("[extent]", ext)
            add("[band]", None)

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
    # K5 in the kernel the main path picks for this bound matrix
    ckw = dict(kw) if batch is None else {
        **kw, "window": csr_window(m, batch, block_k)}
    cases.append({
        "name": f"csr_{op}", "layout": "csr",
        "kernel": lambda: csr_k(md, m.cols, m.indptr, x, **ckw),
        "plain": lambda: csr_plain(md, m.cols, m.indptr, x),
        "mag": lambda: csr_plain(md.abs(), m.cols, m.indptr, xa),
        "bytes": nnz * (val + 4) + 4 * (n + 1) + xy_bytes, "flops": flops,
        "info": {} if batch is None else csr_windows(layouts, batch, block_k,
                                                     dtype, ckw["window"])})

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
    info = {"block": blk, "nblocks": nblocks,
            "fill_ratio": bcsr_fill_ratio(bm)}
    if batch is not None:
        # K10 as the main path launches it: the tensor-core kernel where
        # _common.bcsr_spmm_mma says so
        from repro_torch.kernels import _common as KC
        info["mma"] = KC.bcsr_spmm_mma(batch, blk, block_k)
    cases.append({
        "name": f"bcsr_{op}", "layout": "bcsr",
        "kernel": lambda: bcsr_k(bd, bm.block_cols, bm.indptr, x, n, **kw),
        "plain": lambda: bcsr_plain(bd, bm.block_cols, bm.indptr, x, n),
        "mag": lambda: bcsr_plain(bd.abs(), bm.block_cols, bm.indptr, xa, n),
        "bytes": nblocks * (blk * blk * val + 4) + 4 * (bm.n_block_rows + 1)
        + xy_bytes,
        "flops": 2 * nblocks * blk * blk * b, "info": info})

    return cases, library_of(layouts, csr, x, dtype)


def bcsr_probe_results(label):
    """The 3xTF32 probe: K10's tensor-core kernel on values whose bits below
    TF32's tenth matter (1 + 2^-12 (1 + r/2), positive, so a single TF32
    product errs by ~2^-12 of every term, one way), in every pairing with a
    float32 operand, at b = 8 and B = 32 and 128: within ``KERNEL_REL_TOL``
    of the plain version, where the plain version on operands rounded to
    TF32 is shown to miss it."""
    from repro_torch.core import transform as T
    from repro_torch.kernels import bcsr_spmv as K9

    dev = torch.device("cuda")
    rng = np.random.default_rng(77)

    def probe(shape):
        return torch.from_numpy((1.0 + 2.0 ** -12 * (
            1.0 + 0.5 * rng.random(shape))).astype(np.float32))

    def tf32(t):
        bits = t.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    dense = (torch.from_numpy(rng.random((4000, 3000)) < 0.01)
             * probe((4000, 3000))).numpy()
    csr = T.csr_from_dense(dense, pad=8, device="cpu")
    bm = T.host_csr_to_bcsr(csr).to(dev)
    results = []
    for dd, xd in ((torch.float32, torch.float32),
                   (torch.float32, torch.bfloat16),
                   (torch.bfloat16, torch.float32)):
        d = bm.data.to(dd)
        for batch in (32, 128):
            x = probe((csr.n_cols, batch)).to(dev).to(xd)
            args = (d, bm.block_cols, bm.indptr)
            got = K9.bcsr_spmm(*args, x, bm.n_rows, mma=True)
            want = K9.bcsr_spmm_plain(*args, x, bm.n_rows)
            mag = K9.bcsr_spmm_plain(d.abs(), bm.block_cols, bm.indptr,
                                     x.abs(), bm.n_rows)
            single = K9.bcsr_spmm_plain(tf32(d), bm.block_cols, bm.indptr,
                                        tf32(x), bm.n_rows)
            torch.cuda.synchronize()
            rel = float(((got - want).abs() / (mag + 1e-30)).max())
            rel_single = float(((single - want).abs() / (mag + 1e-30)).max())
            if rel > KERNEL_REL_TOL or rel_single <= KERNEL_REL_TOL:
                raise AssertionError(
                    f"bcsr_spmm 3xTF32 probe {dd}/{xd} B={batch}: rel err "
                    f"{rel} (a single TF32 product: {rel_single})")
            results.append({
                "name": "bcsr_spmm", "layout": "bcsr[tf32 probe]",
                "matrix": label, "batch": batch,
                "dtype": f"{dd}/{xd}".replace("torch.", ""),
                "max_abs_err": float((got - want).abs().max()),
                "max_rel_err": rel, "single_tf32_rel_err": rel_single,
                "tolerance": KERNEL_REL_TOL})
            del got, want, mag, single
    return results


def library_of(layouts, csr, x, dtype):
    """The library call for ``x`` (a sparse CSR product; float32 only)."""
    if dtype != torch.float32:
        return None
    m = layouts["csr"]
    a = torch.sparse_csr_tensor(m.indptr, m.cols[:csr.nnz],
                                m.data[:csr.nnz], size=csr.shape)
    return lambda: a @ x


def csr_window(m, batch, block_k):
    """Whether the main path runs the bound CSR matrix ``m`` through K5's
    window kernel at ``batch`` (``kernels.ops.prepare`` reads its structure
    once, as ``bind`` does)."""
    from repro_torch.kernels import ops
    return ops.csr_window_of(ops.prepare(m), batch, block_k)


def csr_windows(layouts, batch, block_k, dtype, window):
    """K5's windows at this launch (``csr_spmm_window_misses``: the entries
    whose X row comes from global; every entry outside the window kernel),
    counted once per matrix, B, column tile and value size."""
    from repro_torch.kernels.csr_spmv import csr_spmm_window_misses
    memo = layouts.setdefault("windows", {})
    key = (batch, block_k, dtype)
    if key not in memo:
        m = layouts["csr"]
        memo[key] = {**csr_spmm_window_misses(
            m.cols, m.indptr, m.n_cols, batch, block_k=block_k,
            x_dtype=dtype, window=window), "window_kernel": window}
    return memo[key]


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
    ``batch`` (``None``: SpMV) and ``block_k``, computed from ``rows``:
    one per maximal run inside each warp's span (SpMV, ``32 * chunk``
    entries) or each lane group's sub-run (SpMM), counted on ``rows``'s
    device.  ``atomics`` is the float32 atomics that makes (SpMM: one per
    run and column)."""
    from repro_torch.kernels._common import coo_launch
    from repro_torch.kernels.coo_spmv import coo_spmm_launch

    if batch is None:
        _, bn, chunk = coo_launch()
        span = 32 * chunk
    else:
        _, _, _, _, bn, span = coo_spmm_launch(batch, None, block_k)
    k = torch.arange(rows.shape[0], device=rows.device)
    starts = k % bn % span == 0
    starts[1:] |= rows[1:] != rows[:-1]
    segments = int(starts.sum())
    return {"segments": segments,
            "segments_per_block": segments / -(-rows.shape[0] // bn),
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
        seed = 4321 + 4 * i
        for dtype in (torch.float32, torch.bfloat16):
            d = data.to(dtype)
            for batch in (None, SERVE_BATCH):
                shape = (csr.n_cols,) if batch is None else (csr.n_cols,
                                                             batch)
                x = device_normal(shape, seed).to(dtype)
                seed += 1
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


def nonfinite_result(name, layout, got, want, mag, label, dtype, **extra):
    """One kernel output held against its plain version's where inputs are
    not finite: NaN and infinities (of the same sign) in the same places,
    the finite values to ``KERNEL_REL_TOL``."""
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    same = (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isinf(got), torch.isinf(want))
            and torch.equal(got[torch.isinf(want)], want[torch.isinf(want)]))
    err = (got[fin] - want[fin]).abs()
    rel = float((err / (mag[fin] + 1e-30)).max()) if err.numel() else 0.0
    if not same or rel > KERNEL_REL_TOL:
        raise AssertionError(
            f"{name}/{layout} {label} {dtype} {extra}: NaN or inf placed "
            f"apart from the plain version's ({same}) or rel err {rel}")
    nan = torch.isnan(want)
    return {"name": name, "layout": layout, "matrix": label, **extra,
            "dtype": str(dtype).replace("torch.", ""),
            "n_rows": int(got.shape[0]),
            "nan_rows": int((nan.any(dim=1) if nan.ndim > 1 else nan).sum()),
            "max_abs_err": float(err.max()) if err.numel() else 0.0,
            "max_rel_err": rel, "tolerance": KERNEL_REL_TOL}


def ell_nonfinite_results(csr, layouts, label):
    """K4 and K1 held against their plain versions where x is not finite.
    ``X[0, :]`` cycles through +inf, 1.5, -inf and NaN: K4 gathers no X row
    for a padded ``(0, column 0)`` slot and K1 reads no slot past a row's
    extent, each adding ``0 * X[0]`` once a row, so NaN must sit exactly
    where the plain version has it (the rows whose band holds such a slot,
    where ``X[0, b]`` is not finite), infinities too (K4: B = 1, 8 and
    ``SERVE_BATCH``; K1, with extents: each of the four as x[0]).  K1 also
    on the panel with stored zeros at one column c != 0 in every other row
    that holds it and x[c] = +inf: those rows NaN, the others +-inf.
    ELL-Row, ELL-Col and each SELL bucket, both value dtypes; the finite
    values held to ``KERNEL_REL_TOL``.  Not timed."""
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
                results.append(nonfinite_result(
                    "ell_spmm", f"{layout}[x0 non-finite]",
                    K1.ell_spmm(d, c, x), K1.ell_spmm_plain(d, c, x),
                    K1.ell_spmm_plain(d.abs(), c, xa), label, dtype,
                    batch=batch, nnz=csr.nnz))
            if batch != 8:
                continue
            for layout, d, c in panels:
                d = d.to(dtype)
                ext = K1.ell_extent(d, c)
                for b in range(4):
                    xv = x[:, b].contiguous()
                    results.append(nonfinite_result(
                        "ell_spmv", f"{layout}[x0 non-finite]",
                        K1.ell_spmv(d, c, xv, extent=ext),
                        K1.ell_spmv_plain(d, c, xv, ext),
                        K1.ell_spmv_plain(d.abs(), c, xa[:, b]), label, dtype,
                        x0=float(x[0, b]), nnz=csr.nnz))
                # stored zeros at column c0 != 0 under x[c0] = +inf
                c0 = int(c[c.shape[0] // 2, 0])
                even = torch.arange(c.shape[0], device=c.device)[:, None] % 2
                dz = torch.where((c == c0) & (even == 0),
                                 torch.zeros((), dtype=dtype,
                                             device=d.device), d)
                cz = torch.empty_strided(dz.shape, dz.stride(),
                                         dtype=c.dtype,
                                         device=c.device).copy_(c)
                ext = K1.ell_extent(dz, cz)
                xv = x[:, 1].clone()            # x[0] = 1.5: finite
                xv[c0] = float("inf")
                xf = torch.where(torch.isfinite(xv), xv, 0.0).abs()
                results.append(nonfinite_result(
                    "ell_spmv", f"{layout}[stored 0 under inf]",
                    K1.ell_spmv(dz, cz, xv, extent=ext),
                    K1.ell_spmv_plain(dz, cz, xv, ext),
                    K1.ell_spmv_plain(dz.abs(), cz, xf), label, dtype,
                    column=c0, nnz=csr.nnz))
    for name in ("ell_spmm", "ell_spmv"):
        if not any(r["nan_rows"] for r in results if r["name"] == name):
            raise AssertionError(f"{name}: no non-finite x met a padded "
                                 f"slot; the check has no case")
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
                "plain_ms": time_events_ms(case["plain"], PLAIN_REPS),
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
    kernels on its columns with their rows shuffled, K4 and K1 with a
    non-finite x; the CSR, CCS and BCSR kernels on ``HEAVY``, K7, K5 and
    K10 on ``SCATTERED``; K1 on ``BIG`` also reading each band whole; K10's
    3xTF32 probe);
    time the SpMV cases of ``KERNEL_MATRICES``, ``HEAVY`` and ``SCATTERED``
    and the SpMM cases of ``BIG``, ``HEAVY`` and ``SCATTERED`` (K5, K10) at
    each B of ``SPMM_TIMED``.  The phase line also gives the seconds spent on
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
            cases, library = kernel_cases(csr, layouts, dtype,
                                          with_band=(name, scale) == BIG)
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
               "ccs": T.host_csr_to_ccs(csr).to("cuda"),
               "bcsr": T.host_csr_to_bcsr(csr).to("cuda")}
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
    # the scattered matrix: K7 (float32 SpMV) and K5 (each B of
    # SPMM_CHECKED, both value dtypes), timed as on the heavy-tailed one
    t0 = time.perf_counter()
    csr = suite.synthesize(specs[SCATTERED[0]], scale=SCATTERED[1])
    layouts = {"csr": csr.to("cuda"),
               "ccs": T.host_csr_to_ccs(csr).to("cuda"),
               "bcsr": T.host_csr_to_bcsr(csr).to("cuda")}
    label = matrix_label(*SCATTERED)
    cases, library = kernel_cases(csr, layouts, torch.float32)
    results += check_cases([c for c in cases if c["name"] == "ccs_spmv"],
                           library, label, csr.nnz, torch.float32, True, reps)
    for dtype in (torch.float32, torch.bfloat16):
        for batch in SPMM_CHECKED:
            cases, library = kernel_cases(csr, layouts, dtype, batch)
            results += check_cases(
                [c for c in cases if c["name"] in ("csr_spmm", "bcsr_spmm")],
                library,
                label, csr.nnz, dtype, batch in SPMM_TIMED, reps,
                batch=batch)
    del csr, layouts, cases, library
    torch.cuda.empty_cache()
    seconds[label] = time.perf_counter() - t0
    t0 = time.perf_counter()
    results += bcsr_probe_results("tf32_probe")
    seconds["tf32_probe"] = time.perf_counter() - t0
    emit("kernels", seconds=seconds, cases=results)
    return results


def kernels_line(cases, k11_cases, launches):
    """One entry per kernel.  A sparse kernel's float32 case on xenon2 at
    scale 4 — past the L2, where the card does real memory work (ELL:
    row-major, the layout the paper's rule serves; SpMM at B =
    ``SERVE_BATCH``) — carries the times; K11's served case (the shape and
    sequence lengths of qwen3-1.7b in the serve_families phase).  The error is the largest over
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
            "cases_checked": len(mine),
            **{k: head[k] for k in ("bound_ms_panel", "window", "misses")
               if k in head}})
    head = k11_cases[0]
    out.append({
        "name": "decode_attention_int8", **KERNEL_INFO["decode_attention_int8"],
        "launches": launches["decode_attention_int8"],
        "max_abs_err": max(c["max_abs_err"] for c in k11_cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "shape": {k: head[k] for k in ("case", "B", "S", "KV", "G", "Dh",
                                       "window", "dtype", "valid_share")},
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
    panels — the per-B D* table.  The host transforms do not depend on B
    and the SpMV phase has taken the best of three of each: here each
    ``t_trans`` is one transform (their sum moved 3.7 % across the three
    tables of a best-of-three run, whose ``TT`` were all >= 12.6 and ``SP``
    <= 2.4: every ``R`` < 0.2, far from crossing ``c`` = 1)."""
    from repro_torch import api
    from repro_torch.kernels import ops

    dbs, tables = {}, []
    for batch in OFFLINE_BATCHES:
        t0 = time.perf_counter()
        db = api.offline_phase(mats, formats=OFFLINE_FORMATS, batch=batch,
                               machine=torch.cuda.get_device_name(0),
                               spmm_impls=ops.KERNEL_SPMM_IMPLS, iters=iters,
                               trans_iters=1)
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


def check_extents(label, P):
    """A bound ELL or SELL matrix carries each panel's live extents on the
    card (``kernels.ops.prepare``, at bind time), so K1 reads each row up to
    its extent on the main path."""
    from repro_torch.kernels import ops
    panels = {"ell_row": lambda m: (m,), "ell_col": lambda m: (m,),
              "sell": lambda m: m.buckets}.get(P.plan.fmt, lambda m: ())
    for p in panels(P.matrix):
        ext = ops.ell_extent_of(p)
        if ext is None or not ext.is_cuda:
            raise AssertionError(f"{label} {P.plan.fmt}: a bound panel has "
                                 f"no extents on the card")


def serve_one(api, planner, csr, label, plan_kw, iters):
    from repro_torch import kernels
    from repro_torch.core.autotune import time_fn

    x = device_normal(csr.n_cols, 99)
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
    check_extents(label, P)
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


def close_to(label, y, oracle):
    """``y`` against ``(float64 product, sum |a x|)``, relative to the
    latter."""
    want, scale = oracle
    if y.shape != want.shape or not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{label}: bad product {tuple(y.shape)}")
    rel = float(((y.double() - want).abs() / (scale + 1e-30)).max())
    if rel > F32_REL_TOL:
        raise AssertionError(f"{label}: product off the float64 oracle: "
                             f"rel err {rel} > {F32_REL_TOL}")
    return rel


def check_product(label, y, csr, x, oracle=None):
    """``y`` against the float64 oracle (``oracle``, else computed here),
    relative to sum |a x|."""
    return close_to(label, y, oracle if oracle is not None
                    else oracle_f64(csr, x))


#: float64 oracles of the batched path, by (matrix, seed of x, shape of x):
#: each call makes its x anew from the same seed
_ORACLES = {}


def oracle_of(key, csr, x):
    if key not in _ORACLES:
        _ORACLES[key] = oracle_f64(csr, x)
    return _ORACLES[key]


def serve_spmm_one(api, planner, csr, label, batch, plan_kw, iters):
    """``planner.plan(csr, batch=B).bind(csr) @ X`` on the card: the SpMM
    must resolve to the kernel tier, launch the format's SpMM kernel and
    match the oracle; the plan must survive its JSON and re-bind."""
    from repro_torch import kernels
    from repro_torch.core.autotune import time_fn

    x = device_normal((csr.n_cols, batch), 98)
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
    oracle = oracle_of((label, 98, tuple(x.shape)), csr, x)
    rel = check_product(f"{label} B={batch} {plan.fmt}", y, csr, x, oracle)
    del y
    plan2 = api.ExecutionPlan.from_json(plan.to_json())
    if plan2.to_dict() != plan.to_dict():
        raise AssertionError(f"{label}: plan JSON round trip changed it")
    check_product(f"{label} re-bound", plan2.bind(csr, db=planner.db) @ x,
                  csr, x, oracle)
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
    _ORACLES.clear()
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
    x = device_normal((csr.n_cols, SERVE_BATCH), 97)
    oracle_m, oracle_v = oracle_f64(csr, x), oracle_f64(csr, x[:, 0])
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
        rel = check_product(f"tune {f} spmm", P @ x, csr, x, oracle_m)
        rel_v = check_product(f"tune {f} spmv", P @ x[:, 0], csr, x[:, 0],
                              oracle_v)
        served.append({"fmt": f, "tunings": {
                           op: g.to_dict() if g is not None else None
                           for op, g in P.tunings.items()},
                       "max_rel_err": max(rel, rel_v),
                       "t_plan_bind": t_plan_bind})
        del P, plan
    emit("tune", tuned=tuned, served=served, records=len(db.geometries))


# ---------------------------------------------------------------------------
# phase: serve_hybrid (partitioned plans, each block through its kernel)
# ---------------------------------------------------------------------------
def served_times(fn, x, iters):
    """``(t, t_host, t_device)`` seconds of one call of ``fn(x)``: CUDA
    events around ``iters`` back-to-back calls (``autotune.time_fn``), the
    host's time to enqueue one call, and the device time of one call behind
    a head start (``autotune.time_device``; ``None`` where the enqueue
    outruns the longest head start, and the device time is not
    measured).  ``fn`` has run once before (warm).  A call whose enqueue
    outruns the head start is bound by the host: its ``t`` is one call."""
    from repro_torch.core.autotune import time_device, time_fn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(x)
    t_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    if t_host >= HYBRID_MAX_ENQUEUE_S:
        return time_fn(fn, x, iters=1, warmup=0), t_host, None
    t = time_fn(fn, x, iters=iters, warmup=0)
    return t, t_host, time_device(lambda: fn(x))


def expected_block_launches(hyb, op):
    """Launches a product of the hybrid container makes, per kernel."""
    want = {}
    for f, b in zip(hyb.formats, hyb.blocks):
        k = (SPMV_KERNEL_OF if op == "spmv" else SPMM_KERNEL_OF)[f]
        want[k] = want.get(k, 0) + (len(b.buckets) if f == "sell" else 1)
    return want


def counted(fn, *args):
    """``fn(*args)`` and the kernel launches it made."""
    from repro_torch import kernels
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    out = fn(*args)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    return out, {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}


def serve_hybrid_one(api, planner, csr, label, plan_kw, iters, inputs):
    """One plan: minted, bound, its SpMV and SpMM (B = ``SERVE_BATCH``)
    against the float64 oracle and against the reference tier on the same
    container, each block format's kernel launched, then timed.
    ``inputs``: ``{op: (x, oracle of x)}``."""
    from repro_torch.core import dispatch

    t0 = time.perf_counter()
    plan = planner.plan(csr, batch=SERVE_BATCH, **plan_kw)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    P = plan.bind(csr, db=planner.db)
    torch.cuda.synchronize()
    t_bind = time.perf_counter() - t0
    if set(P.tiers.values()) != {"kernel"}:
        raise AssertionError(f"{label}: tiers {P.tiers}")
    hyb = P.matrix
    if plan.fmt != "hybrid":                    # a leaf the rule picked
        hyb = None
    row = {"matrix": label, "n": csr.n_rows, "nnz": csr.nnz,
           "rule": plan.rule, "fmt": plan.fmt, "plan": plan_kw,
           "t_plan": t_plan, "t_bind": t_bind}
    if hyb is not None:
        row.update(blocks=hyb.n_blocks, formats=hyb.format_counts(),
                   t_partition=P.report.t_partition,
                   t_transform=P.report.t_transform)
    for op, (v, oracle) in inputs.items():
        y, launched = counted(P.spmv if op == "spmv" else P.spmm, v)
        rel = close_to(f"{label} {plan_kw} {op}", y, oracle)
        if hyb is not None:
            want = expected_block_launches(hyb, op)
            if launched != want:
                raise AssertionError(f"{label} {plan_kw} {op}: launched "
                                     f"{launched}, the blocks call for "
                                     f"{want}")
            ref = dispatch.dispatch(hyb, v, op=op, tier="reference")
            rel_ref = float(((y.double() - ref.double()).abs()
                             / (oracle[1] + 1e-30)).max())
            if rel_ref > KERNEL_REL_TOL:
                raise AssertionError(f"{label} {plan_kw} {op}: kernel tier "
                                     f"off the reference tier by {rel_ref}")
            row[f"{op}_vs_reference_tier"] = rel_ref
            del ref
        del y
        t, t_host, t_dev = served_times(
            P.spmv if op == "spmv" else P.spmm, v, iters)
        row.update({f"{op}_max_rel_err": rel, f"{op}_launched": launched,
                    f"t_{op}": t, f"t_{op}_host": t_host,
                    f"t_{op}_device": t_dev})
    del P
    return row, plan


def stale_extent_results():
    """A bound ELL panel and a SELL bucket, each edited in place after
    ``bind`` (a pad slot of a row read short of its band given a value):
    the product must still match the oracle of the edited matrix."""
    from repro_torch import api
    from repro_torch.core import suite
    from repro_torch.kernels import ops

    spec = next(s for s in suite.TABLE1 if s.name == "memplus")
    csr = suite.synthesize(spec)
    x = device_normal(csr.n_cols, 96)
    base, scale = oracle_f64(csr, x)
    out = []
    for fmt in ("ell_row", "sell"):
        P = api.Planner(tier="kernel", rule="cost_model").plan(
            csr, fmt=fmt).bind(csr)
        P @ x                                   # read once before the edit
        panels = ([(P.matrix, 0)] if fmt == "ell_row" else
                  list(zip(P.matrix.buckets, P.matrix.row_offsets)))
        panel, off = next((p, o) for p, o in panels
                          if ops._extent_read(p) is not None)
        ext = ops.ell_extent_of(panel)
        r = int(torch.nonzero(ext < panel.width)[0])
        slot = int(ext[r])
        row = (r if fmt == "ell_row" else int(P.matrix.perm[off + r]))
        col, val = (row * 7919 + 13) % csr.n_cols, 0.75
        panel.data[r, slot] = val
        panel.cols[r, slot] = col
        y, launched = counted(P.spmv, x)
        want = base.clone()
        want[row] += val * float(x[col])
        sc = scale.clone()
        sc[row] += abs(val * float(x[col]))
        rel = float(((y.double() - want).abs() / (sc + 1e-30)).max())
        if rel > F32_REL_TOL or not launched.get("ell_spmv"):
            raise AssertionError(f"stale extents {fmt}: rel err {rel}, "
                                 f"launched {launched}")
        out.append({"fmt": fmt, "row": row, "slot": slot,
                    "extent_before": int(ext[r]),
                    "extent_after": int(ops.ell_extent_of(panel)[r]),
                    "max_rel_err": rel})
    return out


def check_variance_blocks(label, csr, plan, formats):
    """Under ``variance`` the heavy tail gets blocks of its own: on torso1
    (a two-point mixture: 857 rows of 4959 entries among rows of 37-38) the
    first block holds exactly the rows of the longest length; the
    power-law matrix, whose lengths spread, gets two block formats or more
    (each of torso1's blocks is uniform, and ELL serves every one)."""
    if label == "torso1":
        lens = csr.row_lengths()
        heavy = int((lens == lens.max()).sum())
        if tuple(plan.blocks[0].rows) != (0, heavy):
            raise AssertionError(f"torso1 under variance: first block "
                                 f"{plan.blocks[0].rows}, the {heavy} "
                                 f"heavy rows not isolated")
    if label.startswith("powerlaw") and len(formats) < 2:
        raise AssertionError(f"{label} under variance: one block format "
                             f"only {formats}")


def phase_serve_hybrid(dbs, iters: int):
    """The hybrid path: ``Planner(tier="kernel").plan(csr, partition=s,
    **kw)`` under each strategy of ``HYBRID_SWEEP`` and the generalized rule
    on the off-line TuningDB (B = ``SERVE_BATCH``, hybrid among its
    formats) on each of ``HYBRID_MATRICES``, bound and served (SpMV and SpMM
    at B = ``SERVE_BATCH``) beside the whole-matrix CSR kernel; then the
    stale-extent repair case.  Fails unless every block format a plan holds
    launched its kernel and ``check_variance_blocks`` holds."""
    from repro_torch import api
    from repro_torch.core import suite

    specs = {s.name: s for s in suite.TABLE1}
    partitioned = api.Planner(tier="kernel")
    generalized = api.Planner(db=dbs[SERVE_BATCH], rule="generalized",
                              tier="kernel")
    served, baseline, seconds = [], [], {}
    for m in HYBRID_MATRICES:
        t0 = time.perf_counter()
        if m is None:
            label = "powerlaw_a1.3"
            csr = suite.synthesize_power_law(n=8192, alpha=1.3)
        else:
            label = matrix_label(*m)
            csr = suite.synthesize(specs[m[0]], scale=m[1])
        x = device_normal(csr.n_cols, 95)
        X = device_normal((csr.n_cols, SERVE_BATCH), 94)
        inputs = {"spmv": (x, oracle_f64(csr, x)),
                  "spmm": (X, oracle_f64(csr, X))}
        P = partitioned.plan(csr, fmt="csr").bind(csr)
        row = {"matrix": label, "n": csr.n_rows, "nnz": csr.nnz}
        for op, v in (("spmv", x), ("spmm", X)):
            t, t_host, t_dev = served_times(
                P.spmv if op == "spmv" else P.spmm, v, iters)
            row.update({f"t_{op}": t, f"t_{op}_host": t_host,
                        f"t_{op}_device": t_dev})
        baseline.append(row)
        del P
        for name, strategy, kw in HYBRID_SWEEP:
            out, plan = serve_hybrid_one(
                api, partitioned, csr, label,
                {"partition": strategy, **kw}, iters, inputs)
            out["strategy"] = name
            served.append(out)
            if strategy == "variance":
                check_variance_blocks(label, csr, plan, out["formats"])
        out, plan = serve_hybrid_one(api, generalized, csr, label, {},
                                     iters, inputs)
        out["strategy"] = "generalized"
        served.append(out)
        del csr, x, X, inputs
        torch.cuda.empty_cache()
        seconds[label] = time.perf_counter() - t0
    stale = stale_extent_results()
    emit("serve_hybrid", seconds=seconds, csr=baseline, served=served,
         stale_extents=stale)
    return served


# ---------------------------------------------------------------------------
# phase: serve_service (SpMVService: the tuned registration, the queue, the
# plan store, the guard ladder under armed faults)
# ---------------------------------------------------------------------------
#: matrices the service registers: the full-size one the other phases use
#: and a Table-1 matrix
SERVICE_MATRICES = (("xenon2", 4.0), ("memplus", 1.0))
#: the service's micro-batch panel width (B of its SpMM)
SERVICE_BATCH = 32
#: full panels, then a ragged one, submitted a vector at a time
SERVICE_SUBMITS = 3 * SERVICE_BATCH + 5
#: timed repetitions of a flush of ``SERVICE_BATCH`` vectors (median)
SERVICE_FLUSH_REPS = 5


def service_block_launches(entry, op, products=1):
    """Launches ``products`` products of a registered key make, per
    kernel: each block's kernel (a SELL block once a bucket)."""
    return {k: v * products
            for k, v in expected_block_launches(entry.matrix, op).items()}


def check_served(label, launched, want):
    if launched != want:
        raise AssertionError(f"serve_service {label}: launched {launched}, "
                             f"the blocks call for {want}")


def check_guards(svc, key, served_by=("tuned",)):
    """Every product of ``key`` served by the rungs ``served_by`` only, no
    fallback, no short circuit."""
    for op, g in svc.stats()[key]["guard"].items():
        used = {r for r, n in g["served_by"].items() if n}
        if not used <= set(served_by) or g["fallback_calls"] \
                or g["short_circuits"] or g["failures"]:
            raise AssertionError(f"serve_service {key} {op}: guard {g}")


def service_one(svc, csr, label, seed):
    """``label`` registered on ``svc`` (tuned), then served three ways:
    direct SpMV, direct SpMM at B = ``SERVICE_BATCH``, and
    ``SERVICE_SUBMITS`` submits (full panels and a ragged one) with a
    flush; each product's launches and its error against the float64
    oracle checked, the flush timed."""
    from repro_torch.core.autotune import time_device

    t0 = time.perf_counter()
    entry = svc.register(label, csr, batch=SERVICE_BATCH)
    t_register = time.perf_counter() - t0
    if entry.plan is None or entry.plan.tier != "kernel" \
            or entry.plan.rule == "degraded" or entry.from_plan:
        raise AssertionError(f"serve_service {label}: plan "
                             f"{entry.plan and entry.plan.rule} "
                             f"{entry.plan and entry.plan.tier}")
    n = csr.n_cols
    x = device_normal(n, seed)
    X = device_normal((n, SERVICE_BATCH), seed + 1)
    V = device_normal((n, SERVICE_SUBMITS), seed + 2)
    errs = []
    y, launched = counted(svc.spmv, label, x)
    check_served(f"{label} spmv", launched, service_block_launches(entry,
                                                                   "spmv"))
    errs.append(check_product(f"{label} spmv", y, csr, x))
    Y, launched = counted(svc.spmm, label, X)
    check_served(f"{label} spmm", launched, service_block_launches(entry,
                                                                   "spmm"))
    errs.append(check_product(f"{label} spmm", Y, csr, X))
    del y, Y

    def submit_all():
        futs = [svc.submit(label, V[:, i]) for i in range(SERVICE_SUBMITS)]
        return futs, svc.flush(label)

    (futs, tail), launched = counted(submit_all)
    flushes = -(-SERVICE_SUBMITS // SERVICE_BATCH)
    check_served(f"{label} submit", launched,
                 service_block_launches(entry, "spmm", flushes))
    if tail != SERVICE_SUBMITS % SERVICE_BATCH:
        raise AssertionError(f"serve_service {label}: ragged flush {tail}")
    got = torch.stack([f.result() for f in futs], dim=1)
    errs.append(check_product(f"{label} submit", got, csr, V))
    del got, futs

    # one flush of SERVICE_BATCH vectors: wall ms (the last submit flushes
    # and waits for the card), then the tuned dispatcher alone on the
    # padded panel, its host and device time, and the finite probe
    flush_ms = []
    for _ in range(SERVICE_FLUSH_REPS):
        for i in range(SERVICE_BATCH - 1):
            svc.submit(label, V[:, i])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc.submit(label, V[:, SERVICE_BATCH - 1])
        flush_ms.append((time.perf_counter() - t0) * 1e3)
    panel = V[:, :SERVICE_BATCH].contiguous()
    spmm = lambda v: entry.spmm_fn(entry.matrix, v)
    t, t_host, t_dev = served_times(spmm, panel, HYBRID_ITERS)
    Yp = spmm(panel)
    torch.cuda.synchronize()
    probe = []
    for _ in range(SERVICE_FLUSH_REPS):
        t0 = time.perf_counter()
        bool(torch.isfinite(Yp).all().item())
        probe.append((time.perf_counter() - t0) * 1e3)
    del Yp
    fl = statistics.median(flush_ms)
    return entry, {
        "matrix": label, "n": csr.n_rows, "nnz": csr.nnz,
        "rule": entry.plan.rule, "blocks": entry.matrix.n_blocks,
        "formats": entry.matrix.format_counts(),
        "tuned": svc.stats()[label]["tuned"],
        "t_register_s": t_register, "t_build_s": entry.t_build,
        "t_csr_s": entry.t_csr, "t_hybrid_s": entry.t_hybrid,
        "flush_ms": fl, "flush_ms_runs": flush_ms,
        "vectors_per_s": SERVICE_BATCH / (fl / 1e3),
        "spmm_t_ms": t * 1e3, "spmm_host_ms": t_host * 1e3,
        "spmm_device_ms": None if t_dev is None else t_dev * 1e3,
        "finite_probe_ms": statistics.median(probe),
        "launches_per_flush": service_block_launches(entry, "spmm"),
        "compiled": svc.stats()[label]["compiled"],
        "max_rel_err": max(errs)}


def service_faults(api, store, csr, label):
    """Faults armed on purpose on a replayed registration of ``label``
    (manual clock): three ``kernel.raise`` open the breaker, calls then
    short-circuit to the reference rung, a probe past the cooldown closes
    it, one ``kernel.nan`` is answered by the reference rung; every answer
    meets the oracle, the ladder's counts are the armed counts, and the
    tuned rung serves again once the faults are cleared."""
    from repro_torch.obs import FakeClock
    from repro_torch.serve import faults

    clk = FakeClock()
    svc = api.SpMVService(tuner=api.KernelTuner(timer=_no_tuning),
                          max_batch=SERVICE_BATCH, plan_store=store,
                          clock=clk, breaker_failures=3,
                          breaker_cooldown_s=10.0)
    entry = svc.register(label, csr, batch=SERVICE_BATCH)
    if not entry.from_plan:
        raise AssertionError(f"serve_service faults: {label} not replayed")
    x = device_normal(csr.n_cols, 93)
    oracle = oracle_f64(csr, x)
    errs = []

    def serve(n):
        for _ in range(n):
            errs.append(close_to(f"faults {label}", svc.spmv(label, x),
                                 oracle))

    faults.clear()
    try:
        faults.arm("kernel.raise", prob=1.0)
        serve(3)
        opened = svc.stats()[label]["guard"]["spmv"]["breaker"]["state"]
        serve(2)                                 # short-circuited
        raised = faults.counts()["kernel.raise"]
        faults.disarm("kernel.raise")
        clk.advance(10.0)
        serve(1)                                 # the half-open probe
        closed = svc.stats()[label]["guard"]["spmv"]["breaker"]["state"]
        faults.arm("kernel.nan", prob=1.0)
        serve(1)
        nan = faults.counts()["kernel.nan"]
    finally:
        faults.clear()
    g = svc.stats()[label]["guard"]["spmv"]
    want = {"failures": {"tuned/exception": 3, "tuned/non_finite": 1},
            "short_circuits": 2, "fallback_calls": 6,
            "served_by": {"tuned": 1, "reference": 6, "csr": 0}}
    got = {k: g[k] for k in want}
    if (opened, closed) != ("open", "closed") or got != want or \
            raised != {"checked": 3, "fired": 3} or \
            nan != {"checked": 1, "fired": 1}:
        raise AssertionError(f"serve_service faults: breaker {opened} -> "
                             f"{closed}, guard {got}, fired {raised} {nan}")
    _, launched = counted(svc.spmv, label, x)
    tuned_after = svc.stats()[label]["guard"]["spmv"]["served_by"]["tuned"]
    if tuned_after != 2 or not launched:
        raise AssertionError(f"serve_service faults: tuned rung not back "
                             f"({tuned_after}, launched {launched})")
    return {"matrix": label, "breaker": [opened, closed], "guard": got,
            "kernel_raise": raised, "kernel_nan": nan,
            "max_rel_err": max(errs)}


def _no_tuning(thunk, geometry):
    raise AssertionError("serve_service: a replayed registration tuned")


def phase_serve_service(dbs):
    """The SpMV service (``repro_torch.serve.SpMVService``) on the card:
    a tuner, the off-line TuningDB at B = ``SERVICE_BATCH``, a plan store
    in a temporary directory.  Each of ``SERVICE_MATRICES`` is registered
    (tuned) and served three ways, and xenon2@x4 once more on a service
    without a TuningDB (cost-model blocks); every product goes through the
    tuned rung's kernels, no fallback and no degraded registration.  Then
    a second service on the store replays xenon2@x4 with no tuning,
    eviction fails pending futures, and the fault sub-phase runs the
    ladder under armed faults."""
    import tempfile
    from repro_torch import api, obs
    from repro_torch.core import suite

    specs = {s.name: s for s in suite.TABLE1}
    tel = obs.Telemetry(enabled=True, sinks=[obs.InMemorySink()])
    prev = obs.set_default(tel)
    try:
        with tempfile.TemporaryDirectory() as root:
            store = api.PlanStore(root)
            svc = api.SpMVService(tuner=api.KernelTuner(),
                                  db=dbs[SERVICE_BATCH],
                                  max_batch=SERVICE_BATCH, plan_store=store)
            served, mats = [], {}
            for i, m in enumerate(SERVICE_MATRICES):
                label = matrix_label(*m)
                mats[label] = suite.synthesize(specs[m[0]], scale=m[1])
                entry, row = service_one(svc, mats[label], label, 90 - 4 * i)
                served.append(row)
                check_guards(svc, label)
            big = matrix_label(*SERVICE_MATRICES[0])
            svc.evict(big)
            torch.cuda.empty_cache()
            # the rule on the TuningDB keeps CSR blocks (D* = 0); the cost
            # model's ELL and SELL blocks put K1 and K4 behind the service
            cost = api.SpMVService(tuner=api.KernelTuner(),
                                   max_batch=SERVICE_BATCH)
            entry, row = service_one(cost, mats[big], big, 80)
            served.append(row)
            check_guards(cost, big)
            cost.evict(big)
            del entry, cost
            torch.cuda.empty_cache()
            counters = tel.snapshot()["counters"]
            fallback = [k for k in counters if k.startswith(
                "service.fallback")]
            if fallback:
                raise AssertionError(f"serve_service: fallbacks {fallback}")

            # a second replica: the same store, no tuning at all
            replica = api.SpMVService(tuner=api.KernelTuner(timer=_no_tuning),
                                      db=dbs[SERVICE_BATCH],
                                      max_batch=SERVICE_BATCH,
                                      plan_store=store)
            t0 = time.perf_counter()
            entry = replica.register(big, mats[big], batch=SERVICE_BATCH)
            t_replay = time.perf_counter() - t0
            if not entry.from_plan or entry.plan.tier != "kernel":
                raise AssertionError(f"serve_service: replica of {big} "
                                     f"not replayed ({entry.from_plan})")
            x = device_normal(mats[big].n_cols, 92)
            y, launched = counted(replica.spmv, big, x)
            check_served(f"{big} replayed", launched,
                         service_block_launches(entry, "spmv"))
            rel_replay = check_product(f"{big} replayed", y, mats[big], x)
            check_guards(replica, big)
            pending = [replica.submit(big, x) for _ in range(3)]
            replica.evict(big)
            evicted = 0
            for f in pending:
                if isinstance(f.exception(timeout=0), api.EvictedError):
                    evicted += 1
            if evicted != len(pending):
                raise AssertionError(f"serve_service: {evicted} of "
                                     f"{len(pending)} pending futures "
                                     f"failed with EvictedError")
            del entry, y, pending
            torch.cuda.empty_cache()

            small = matrix_label(*SERVICE_MATRICES[1])
            fault = service_faults(api, store, mats[small], small)
            plan_store = store.stats()
    finally:
        obs.set_default(prev)
    out = {"batch": SERVICE_BATCH, "submits": SERVICE_SUBMITS,
           "served": served,
           "replayed": {"matrix": big, "t_register_s": t_replay,
                        "max_rel_err": rel_replay,
                        "evicted_futures": evicted},
           "faults": fault, "plan_store": plan_store}
    emit("serve_service", **out)
    return out


# ---------------------------------------------------------------------------
# phase: serve_stream (deltas on the service's streaming keys)
# ---------------------------------------------------------------------------
#: the matrix the streaming and sharded phases serve
STREAM_MATRIX = ("xenon2", 4.0)
#: mixed deltas a streaming key absorbs, a panel of submits after each
STREAM_DELTAS = 8
STREAM_DELTA_KW = {"n_appends": 256, "n_updates": 4096, "n_deletes": 256,
                   "row_len": 24}
#: the same mix at an eighth of the size: launches per apply beside it
STREAM_SMALL_KW = {"n_appends": 32, "n_updates": 512, "n_deletes": 32,
                   "row_len": 24}
#: updates of stored entries in the value-only (in place) delta
STREAM_VALUE_UPDATES = 4096
#: queried epochs the captured trace replays through the off-line phase
#: (each one timed host SELL transforms of the whole matrix, ~3 s)
STREAM_REPLAY_EPOCHS = 1


def clone_csr(csr):
    """A CSR of its own on the card: a streaming key edits its matrix in
    place, so each key gets a copy of the phase's matrix."""
    from repro_torch.core.formats import CSR
    return CSR(data=csr.data.clone(), cols=csr.cols.clone(),
               indptr=csr.indptr.clone(), shape=csr.shape, nnz=csr.nnz)


def value_delta(csr, n, seed):
    """``n`` updates of stored entries (the first entry of ``n`` rows that
    store one): a delta an apply absorbs in place."""
    from repro_torch.stream import DeltaBatch
    rng = np.random.default_rng(seed)
    ip = csr.indptr.cpu().numpy().astype(np.int64)
    rows = np.sort(rng.choice(np.nonzero(np.diff(ip))[0], size=n,
                              replace=False))
    cols = csr.cols[torch.from_numpy(ip[rows]).to(csr.cols.device)]
    return DeltaBatch(n_cols=csr.n_cols, update_rows=rows,
                      update_cols=cols.cpu().numpy().astype(np.int64),
                      update_vals=rng.standard_normal(n).astype(np.float32))


def counted_calls(fn):
    """``fn()`` and the torch calls it made on the card's tensors (each
    one kernel launch or copy, or more, or none for a view), counted by a
    function mode: no profiler, whose tracing would stay attached to every
    later launch of the run, and no dispatch mode, which takes seconds to
    set up on its first use."""
    from torch.overrides import TorchFunctionMode

    class Count(TorchFunctionMode):
        n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(isinstance(a, torch.Tensor) and a.is_cuda
                   for a in (*args, *kwargs.values())):
                Count.n += 1
            return func(*args, **kwargs)

    torch.cuda.synchronize()
    with Count():
        out = fn()
    return out, Count.n


def stream_key(api, svc, base, key, fmt, seed, capture=None):
    """A streaming key (``fmt``, a kernel-tier leaf plan) on a copy of
    ``base``: ``STREAM_DELTAS`` mixed deltas with a flush of
    ``SERVICE_BATCH`` submits after each, then an append-only and a
    value-only delta, the torch calls of one apply at an eighth of the size
    and at the full size; every flush against the float64 oracle of the
    current matrix.  Beside it, what a full re-transform costs: the
    registration's host recipe alone, and its whole build."""
    from repro_torch.stream import random_delta
    csr = clone_csr(base)
    plan = api.Planner(tier="kernel").plan(csr, fmt=fmt)
    t0 = time.perf_counter()
    entry = svc.register(key, csr, plan=plan, streaming=True,
                         batch=SERVICE_BATCH, measure_baseline=False)
    t_register = time.perf_counter() - t0
    # the full re-transform a delta would otherwise pay: the host recipe
    # alone, and the whole build (validate, transform, upload, prepare)
    t_trans, t_bind = entry.report.t_transform, entry.t_build
    if capture is not None:
        capture.base(key, csr)
    rng = np.random.default_rng(seed)
    applies, errs, flushes = [], [], [0]

    def serve():
        entry = svc.entries[key]
        V = device_normal((csr.n_cols, SERVICE_BATCH), seed + flushes[0])
        futs, launched = counted(lambda: [svc.submit(key, V[:, j])
                                          for j in range(SERVICE_BATCH)])
        check_served(f"stream {key} flush", launched,
                     service_block_launches(entry, "spmm"))
        if capture is not None:
            for _ in range(SERVICE_BATCH):
                capture.query(key, batch=1)
        got = torch.stack([f.result() for f in futs], dim=1)
        errs.append(check_product(f"serve_stream {key}", got,
                                  entry.source, V))
        flushes[0] += 1

    def apply(delta, what):
        if capture is not None:
            capture.delta(key, delta)
        res = svc.apply_delta(key, delta)
        applies.append({"delta": what, "mode": res.mode,
                        "fallback": res.fallback_reason or None,
                        "t_apply_s": res.t_apply_s,
                        "rows_changed": int(res.changed_rows.shape[0]),
                        "appended": int(res.appended_lens.shape[0]),
                        "buckets_rebuilt": res.buckets_rebuilt})
        return res

    serve()
    for _ in range(STREAM_DELTAS):
        apply(random_delta(rng, svc.entries[key].source, **STREAM_DELTA_KW),
              "mixed")
        serve()
    apply(random_delta(rng, svc.entries[key].source, n_appends=256,
                       row_len=24), "appends")
    apply(value_delta(svc.entries[key].source, STREAM_VALUE_UPDATES,
                      seed + 1), "values")
    serve()
    ops = {}
    for what, kw in (("small", STREAM_SMALL_KW), ("full", STREAM_DELTA_KW)):
        delta = random_delta(rng, svc.entries[key].source, **kw)
        _, n = counted_calls(lambda: apply(delta, what))
        ops[what] = {"torch_calls": n,
                     "rows_changed": applies[-1]["rows_changed"],
                     "buckets_rebuilt": applies[-1]["buckets_rebuilt"]}
    if ops["full"]["torch_calls"] > 2 * ops["small"]["torch_calls"]:
        raise AssertionError(f"serve_stream {key}: the calls of an apply "
                             f"grow with the rows changed: {ops}")
    serve()
    return {"key": key, "fmt": fmt, "t_trans_s": t_trans, "t_bind_s": t_bind,
            "t_register_s": t_register, "applies": applies,
            "calls_per_apply": ops, "errs": errs, "serve": serve,
            "apply": apply, "rng": rng}


def by_mode(applies):
    """Median ``t_apply_s`` of each apply mode, with its count (the two
    applies whose calls were counted left out)."""
    modes = {}
    for a in applies:
        if a["delta"] not in ("small", "full"):
            modes.setdefault(a["mode"], []).append(a["t_apply_s"])
    return {m: {"n": len(t), "t_apply_s": statistics.median(t)}
            for m, t in modes.items()}


def phase_serve_stream(base):
    """Streaming keys of the SpMV service on the card
    (``register(streaming=True)``, ``apply_delta``): a CSR key and a SELL
    key each absorb ``STREAM_DELTAS`` mixed deltas, an append-only and a
    value-only one; every apply stays incremental and on the card, its
    torch calls do not grow with the rows it changes, and every flush
    between
    deltas meets the oracle of the current matrix.  Then the SELL key under
    ``delta.corrupt`` (a rebuild, products still right), a direct SpMV on
    each key, an ``ell_row`` key (the rebuild fallback), a re-plan driven
    by an explicit ``d_star``, and the SELL key's traffic, captured as a
    trace, replayed through ``offline_phase`` (``formats=("sell",)``)."""
    import tempfile
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.serve import faults
    from repro_torch.stream import (ReplanPolicy, TraceCapture, random_delta,
                                    replay_file)

    svc = api.SpMVService(tuner=api.KernelTuner(), max_batch=SERVICE_BATCH)
    keys, seconds, t_step = {}, {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = now - t_step[0]
        t_step[0] = now
    with tempfile.TemporaryDirectory() as root:
        trace = os.path.join(root, "trace.jsonl")
        cap = TraceCapture(trace)
        for i, fmt in enumerate(("csr", "sell")):
            keys[fmt] = stream_key(api, svc, base, f"stream_{fmt}", fmt,
                                   700 + 100 * i,
                                   capture=cap if fmt == "sell" else None)
            for a in keys[fmt]["applies"]:
                if a["fallback"]:
                    raise AssertionError(f"serve_stream {fmt}: {a}")
            lap(f"key_{fmt}")
        sell = keys["sell"]
        # a poisoned apply degrades to a rebuild; answers stay right
        faults.clear()
        try:
            with faults.inject("delta.corrupt", prob=1.0):
                res = sell["apply"](random_delta(
                    sell["rng"], svc.entries["stream_sell"].source,
                    **STREAM_DELTA_KW), "corrupt")
        finally:
            faults.clear()
        if (res.mode, res.fallback_reason) != ("rebuild", "corrupt"):
            raise AssertionError(f"serve_stream corrupt: {res.mode} "
                                 f"{res.fallback_reason}")
        sell["serve"]()
        x = device_normal(base.n_cols, 790)
        for k in keys.values():
            entry = svc.entries[k["key"]]
            y, launched = counted(svc.spmv, k["key"], x)
            check_served(f"stream {k['key']} spmv", launched,
                         service_block_launches(entry, "spmv"))
            k["errs"].append(check_product(f"serve_stream {k['key']} spmv",
                                           y, entry.source, x))
            if sell is k:
                cap.query(k["key"], batch=1)
            check_guards(svc, k["key"])
        cap.close()
        out = {"matrix": matrix_label(*STREAM_MATRIX), "n": base.n_rows,
               "nnz": base.nnz, "deltas": STREAM_DELTA_KW,
               "submits_between": SERVICE_BATCH, "keys": []}
        for k in keys.values():
            st = svc.stats()[k["key"]]["streaming"]
            out["keys"].append({
                "key": k["key"], "fmt": k["fmt"], "t_trans_s": k["t_trans_s"],
                "t_bind_s": k["t_bind_s"],
                "t_register_s": k["t_register_s"],
                "t_apply_by_mode": by_mode(k["applies"]),
                "applies": k["applies"],
                "calls_per_apply": k["calls_per_apply"],
                "deltas": st["deltas"],
                "n_rows_after": svc.entries[k["key"]].source.n_rows,
                "max_rel_err": max(k["errs"])})
            svc.evict(k["key"])
        del keys, sell
        torch.cuda.empty_cache()
        lap("corrupt_and_spmv")

        # ell_row is not incrementally updatable: a CSR apply and a rebuild
        rng = np.random.default_rng(880)
        csr = clone_csr(base)
        svc.register("stream_ell", csr, streaming=True, batch=SERVICE_BATCH,
                     plan=api.Planner(tier="kernel").plan(csr, fmt="ell_row"),
                     measure_baseline=False)
        res = svc.apply_delta("stream_ell", random_delta(
            rng, csr, **STREAM_DELTA_KW))
        entry = svc.entries["stream_ell"]
        if (res.mode, res.fallback_reason) != ("rebuild", "nonleaf") \
                or entry.plan.tier != "kernel":
            raise AssertionError(f"serve_stream ell_row: {res.mode} "
                                 f"{res.fallback_reason} {entry.plan.tier}")
        y, launched = counted(svc.spmv, "stream_ell", x)
        check_served("stream ell_row rebuilt", launched,
                     service_block_launches(entry, "spmv"))
        rel_ell = check_product("serve_stream ell_row", y, entry.source, x)
        check_guards(svc, "stream_ell")
        out["ell_row"] = {"mode": res.mode, "fallback": res.fallback_reason,
                          "t_apply_s": res.t_apply_s,
                          "blocks_after": entry.matrix.format_counts(),
                          "max_rel_err": rel_ell}
        svc.evict("stream_ell")
        lap("ell_row")

        # a re-plan: D* is 0 for every format on the card, so the policy
        # is given one above the matrix's D_mat; the CSR key re-registers
        csr = clone_csr(base)
        d_mat = api.MatrixStats.of(csr).d_mat
        policy = ReplanPolicy(d_star=2.0 * d_mat + 1.0, fmt="sell")
        svc.register("stream_replan", csr, streaming=True,
                     batch=SERVICE_BATCH, stream_policy=policy,
                     plan=api.Planner(tier="kernel").plan(csr, fmt="csr"),
                     measure_baseline=False)
        t0 = time.perf_counter()
        svc.apply_delta("stream_replan", random_delta(rng, csr,
                                                      **STREAM_DELTA_KW))
        t_replan = time.perf_counter() - t0
        entry = svc.entries["stream_replan"]
        st = svc.stats()["stream_replan"]["streaming"]
        if st["replans"] != 1 or st["last_decision"] != "replan" \
                or entry.plan.fmt != "hybrid":
            raise AssertionError(f"serve_stream replan: {st} "
                                 f"{entry.plan.fmt}")
        y, launched = counted(svc.spmv, "stream_replan", x)
        check_served("stream replanned", launched,
                     service_block_launches(entry, "spmv"))
        rel_replan = check_product("serve_stream replan", y, entry.source, x)
        check_guards(svc, "stream_replan")
        out["replan"] = {"d_mat": st["d_mat"], "d_star": policy.d_star,
                         "decision": st["last_decision"],
                         "t_apply_and_replan_s": t_replan,
                         "blocks_after": entry.matrix.format_counts(),
                         "max_rel_err": rel_replan}
        svc.evict("stream_replan")
        del entry, csr, y
        torch.cuda.empty_cache()
        lap("replan")

        # the SELL key's traffic through the off-line phase
        t0 = time.perf_counter()
        db, rstats = replay_file(trace, base, formats=("sell",),
                                 max_epochs=STREAM_REPLAY_EPOCHS, iters=5,
                                 machine=torch.cuda.get_device_name(0),
                                 spmv_impls=ops.KERNEL_SPMV_IMPLS)
        if len(db.records) != STREAM_REPLAY_EPOCHS \
                or rstats.dropped_epochs != rstats.n_epochs \
                - STREAM_REPLAY_EPOCHS:
            raise AssertionError(f"serve_stream replay: {rstats}")
        out["replay"] = {
            "seconds": time.perf_counter() - t0, "epochs": rstats.n_epochs,
            "replayed": len(db.records), "deltas": rstats.n_deltas,
            "queries": rstats.n_queries, "k_hat": rstats.k_hat,
            "batch": rstats.batch, "d_star": db.d_star,
            "records": offline_rows(db)}
        lap("replay")
    out["seconds"] = seconds
    emit("serve_stream", **out)
    return out


# ---------------------------------------------------------------------------
# phase: serve_sharded (the sharded tier on one card)
# ---------------------------------------------------------------------------
SHARDS = 4


def sharded_launches(spm, op):
    """Launches a product of a sharded matrix makes, per kernel: each
    shard's kernel (a SELL shard once a bucket, a hybrid one per block)."""
    want = {}
    for pm in spm.planned:
        if pm.plan.is_hybrid:
            got = expected_block_launches(pm.matrix, op)
        else:
            k = (SPMV_KERNEL_OF if op == "spmv" else SPMM_KERNEL_OF)[pm.fmt]
            got = {k: len(pm.matrix.buckets) if pm.fmt == "sell" else 1}
        for k, v in got.items():
            want[k] = want.get(k, 0) + v
    return want


def sharded_one(api, planner, csr, label, axis, inputs):
    """``planner.plan_sharded(csr, n_shards=SHARDS, axis=axis)``: minted,
    through its JSON, bound (``dispatch`` on one card); its SpMV and SpMM
    (B = ``SERVICE_BATCH``) launch each shard's kernel, meet the oracle
    and are timed; every shard's guard on the tuned rung."""
    t0 = time.perf_counter()
    plan = planner.plan_sharded(csr, n_shards=SHARDS, axis=axis,
                                batch=SERVICE_BATCH)
    t_plan = time.perf_counter() - t0
    if api.ShardedPlan.from_json(plan.to_json()).to_dict() != plan.to_dict():
        raise AssertionError(f"serve_sharded {label}: JSON round trip")
    t0 = time.perf_counter()
    spm = plan.bind(csr, db=planner.db)
    torch.cuda.synchronize()
    t_bind = time.perf_counter() - t0
    if spm.mode != "dispatch" or not spm.fingerprint_matched:
        raise AssertionError(f"serve_sharded {label}: {spm}")
    row = {"axis": axis, "formats": list(plan.shard_formats()),
           "boundaries": spm.boundaries.tolist(), "t_plan": t_plan,
           "t_bind": t_bind}
    for op, (v, oracle) in inputs.items():
        fn = spm.spmv if op == "spmv" else spm.spmm
        y, launched = counted(fn, v)
        if launched != sharded_launches(spm, op):
            raise AssertionError(f"serve_sharded {label} {axis} {op}: "
                                 f"launched {launched}, the shards call for "
                                 f"{sharded_launches(spm, op)}")
        row[f"{op}_max_rel_err"] = close_to(f"sharded {label} {op}", y,
                                            oracle)
        row[f"{op}_launched"] = launched
        del y
        t, t_host, t_dev = served_times(fn, v, HYBRID_ITERS)
        row.update({f"t_{op}": t, f"t_{op}_host": t_host,
                    f"t_{op}_device": t_dev})
    for i, shard in enumerate(spm.guard_report()):
        for op, g in shard.items():
            if g["served_by"]["csr"] or g["failures"]:
                raise AssertionError(f"serve_sharded {label} shard {i} "
                                     f"{op}: guard {g}")
    del spm
    return row, plan


def phase_serve_sharded(base, dbs):
    """The sharded tier on the card: ``plan_sharded(n_shards=SHARDS)`` on
    the row and the column axis, on the cost model and on the B = 32
    TuningDB, served at B = 1 and 32 beside the unsharded plan of the same
    matrix; then the service: a sharded plan registered and served by a
    flush of 32 submits, every rung and shard tuned, replayed from a plan
    store by a replica that may not tune; and an explicit ``shard_map``
    refused on one card."""
    import tempfile
    from repro_torch import api
    from repro_torch.sharding import build_sharded

    label = matrix_label(*STREAM_MATRIX)
    x = device_normal(base.n_cols, 71)
    X = device_normal((base.n_cols, SERVICE_BATCH), 72)
    inputs = {"spmv": (x, oracle_f64(base, x)),
              "spmm": (X, oracle_f64(base, X))}
    rules = {"cost_model": api.Planner(tier="kernel"),
             "tuningdb_b32": api.Planner(db=dbs[SERVICE_BATCH],
                                         tier="kernel")}
    out = {"matrix": label, "n": base.n_rows, "nnz": base.nnz,
           "n_shards": SHARDS, "batch": SERVICE_BATCH, "plans": []}
    plans = {}
    for name, planner in rules.items():
        P = planner.plan(base, batch=SERVICE_BATCH).bind(base,
                                                         db=planner.db)
        whole = {"rule": name, "axis": None, "formats": [P.plan.fmt]}
        for op, (v, oracle) in inputs.items():
            fn = P.spmv if op == "spmv" else P.spmm
            whole[f"{op}_max_rel_err"] = close_to(f"unsharded {name}",
                                                  fn(v), oracle)
            t, t_host, t_dev = served_times(fn, v, HYBRID_ITERS)
            whole.update({f"t_{op}": t, f"t_{op}_host": t_host,
                          f"t_{op}_device": t_dev})
        out["plans"].append(whole)
        del P
        for axis in ("row", "col"):
            row, plans[(name, axis)] = sharded_one(api, planner, base, label,
                                                   axis, inputs)
            out["plans"].append({"rule": name, **row})
        torch.cuda.empty_cache()

    # the service: a sharded plan registered, served by submits
    plan = plans[("cost_model", "row")]
    svc = api.SpMVService(tuner=api.KernelTuner(), max_batch=SERVICE_BATCH)
    t0 = time.perf_counter()
    entry = svc.register(label, base, plan=plan)
    t_register = time.perf_counter() - t0
    if not entry.from_plan or entry.matrix.mode != "dispatch":
        raise AssertionError(f"serve_sharded service: {entry.matrix}")
    futs, launched = counted(lambda: [svc.submit(label, X[:, j])
                                      for j in range(SERVICE_BATCH)])
    check_served("sharded flush", launched,
                 sharded_launches(entry.matrix, "spmm"))
    rel_flush = close_to("sharded flush", torch.stack(
        [f.result() for f in futs], dim=1), inputs["spmm"][1])
    check_guards(svc, label)
    for shard in entry.matrix.guard_report():
        for g in shard.values():
            if g["served_by"]["csr"] or g["failures"]:
                raise AssertionError(f"serve_sharded service shard: {g}")
    st = svc.stats()[label]
    svc.evict(label)
    del entry, futs
    with tempfile.TemporaryDirectory() as root:
        store = api.PlanStore(root)
        key = store.key_for(base, n_shards=SHARDS)
        store.put(key, plan)
        replica = api.SpMVService(tuner=api.KernelTuner(timer=_no_tuning),
                                  max_batch=SERVICE_BATCH)
        loaded = store.get(key, fingerprint=base)
        if not isinstance(loaded, api.ShardedPlan):
            raise AssertionError(f"serve_sharded store: {loaded!r}")
        t0 = time.perf_counter()
        entry = replica.register(label, base, plan=loaded,
                                 measure_baseline=False)
        t_replay = time.perf_counter() - t0
        if not entry.from_plan:
            raise AssertionError("serve_sharded: replica not replayed")
        y, launched = counted(replica.spmv, label, x)
        check_served("sharded replayed", launched,
                     sharded_launches(entry.matrix, "spmv"))
        rel_replay = close_to("sharded replayed", y, inputs["spmv"][1])
        check_guards(replica, label)
        replica.evict(label)
        store_stats = store.stats()
    del entry, y
    try:
        build_sharded(base, plan=plan, mode="shard_map")
    except api.PlanError as e:
        refused = str(e)
    else:
        raise AssertionError("serve_sharded: shard_map served on one card")
    out["service"] = {"t_register_s": t_register,
                      "flush_max_rel_err": rel_flush,
                      "formats": st["formats"], "t_build_s": st["t_build_s"],
                      "guard": {op: g["served_by"]
                                for op, g in st["guard"].items()},
                      "replayed_t_register_s": t_replay,
                      "replayed_max_rel_err": rel_replay,
                      "plan_store": store_stats}
    out["shard_map"] = refused
    emit("serve_sharded", **out)
    return out


# ---------------------------------------------------------------------------
# phase: serve_shard_map (the sharded tier's SPMD executor, ranks on a card)
# ---------------------------------------------------------------------------
#: ranks of the serve_shard_map world: two, both on the one card, over gloo
SHARD_MAP_RANKS = 2
#: products a timing averages over (each a collective of both ranks)
SHARD_MAP_ITERS = 5
#: the mesh train: arch (full width), layers kept, batch, sequence, steps
MESH_TRAIN = ("qwen3-1.7b", 2, 2, 256, 3)
#: the world's wall limit, seconds
SHARD_MAP_WALL_S = 240


def import_checkpoint_deps():
    """Start importing, on a thread, what ``torch.utils.checkpoint`` imports
    at its first call (``torch._dynamo``; a fresh process's first train
    step took 13.7 s against 0.09 s after it on the card's host), so the
    import runs while the process waits or works on other things."""
    import importlib
    return ThreadPoolExecutor(1).submit(importlib.import_module,
                                        "torch._dynamo")


def shard_map_times(fn, v):
    """``(ms by CUDA events, ms by the host clock)`` of one product,
    averaged over ``SHARD_MAP_ITERS`` back-to-back calls (each a collective
    of every rank, so every rank runs this)."""
    fn(v)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(SHARD_MAP_ITERS):
        fn(v)
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / SHARD_MAP_ITERS,
            (time.perf_counter() - t0) * 1e3 / SHARD_MAP_ITERS)


def mesh_train_setup():
    """(config, data, train config) of the mesh train: ``MESH_TRAIN``'s
    arch at full width cut to its layers, no checkpoint written."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM, data_config_for
    from repro_torch.train import TrainConfig
    arch, layers, batch, seq, steps = MESH_TRAIN
    cfg = get_config(arch).replace(n_layers=layers)
    return (cfg, SyntheticLM(data_config_for(cfg, seq, batch, seed=0)),
            TrainConfig(steps=steps, ckpt_every=10 ** 9, log_every=10 ** 9,
                        seed=0))


def shard_map_rank(rank):
    """One rank of the serve_shard_map world (``launch.mesh.spawn``; the
    rank computes on ``cuda:{rank % device_count()}``): xenon2@x4 in
    ``SHARD_MAP_RANKS`` row and column shards under ``mode="shard_map"``,
    SpMV and SpMM at B = ``SERVICE_BATCH`` held against the float64
    oracle, this rank's K2/K5 launches counted and each product timed;
    then the mesh train on a ``SHARD_MAP_RANKS`` x 1 mesh."""
    import tempfile
    from repro_torch import api, kernels
    from repro_torch.core import suite
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import collectives as C
    from repro_torch.train import Trainer

    marks = {"start": time.perf_counter()}
    imported = import_checkpoint_deps()
    base = suite.synthesize(
        {s.name: s for s in suite.TABLE1}[STREAM_MATRIX[0]],
        scale=STREAM_MATRIX[1])
    marks["synthesized"] = time.perf_counter()
    x = device_normal(base.n_cols, 71)
    X = device_normal((base.n_cols, SERVICE_BATCH), 72)
    inputs = {"spmv": (x, oracle_f64(base, x)),
              "spmm": (X, oracle_f64(base, X))}
    imported.result()      # done before anything below is timed
    marks["oracles"] = time.perf_counter()
    planner = api.Planner(tier="kernel")
    out = {"rank": rank, "device": str(torch.device(
        "cuda", torch.cuda.current_device())), "axes": {}}
    for axis in ("row", "col"):
        plan = planner.plan_sharded(base, n_shards=SHARD_MAP_RANKS,
                                    axis=axis, batch=SERVICE_BATCH)
        t0 = time.perf_counter()
        spm = api.build_sharded(base, plan=plan, mode="auto")
        torch.cuda.synchronize()
        row = {"mode": spm.mode, "t_bind_s": time.perf_counter() - t0,
               "nbytes": spm.nbytes(), "rows_pad": spm.spmd.rows_pad,
               "nnz_pad": spm.spmd.nnz_pad}
        if spm.mode != "shard_map":
            raise AssertionError(f"serve_shard_map {axis}: {spm}")
        for op, (v, oracle) in inputs.items():
            fn = spm.spmv if op == "spmv" else spm.spmm
            kernels.reset_launch_counts()
            staged = C.stage.bytes
            y = fn(v)
            torch.cuda.synchronize()
            staged = C.stage.bytes - staged
            launched = {k: n for k, n in kernels.launch_counts().items()
                        if n}
            want = "csr_spmv" if op == "spmv" else "csr_spmm"
            if set(launched) != {want}:
                raise AssertionError(f"serve_shard_map rank {rank} {axis} "
                                     f"{op}: launched {launched}")
            ms, ms_host = shard_map_times(fn, v)
            row[op] = {"max_rel_err": close_to(
                f"shard_map rank {rank} {axis} {op}", y, oracle),
                "launched": launched, "staged_bytes": staged,
                "ms": ms, "ms_host": ms_host}
            del y
        out["axes"][axis] = row
        del spm
        marks[axis] = time.perf_counter()
    del base, x, X, inputs
    torch.cuda.empty_cache()

    mesh = make_mesh((SHARD_MAP_RANKS, 1), ("data", "model"))
    cfg, data, tc = mesh_train_setup()
    with tempfile.TemporaryDirectory() as root:
        tc.ckpt_dir = root
        tr = Trainer(cfg, data, tc, device=torch.device(
            "cuda", torch.cuda.current_device()), mesh=mesh)
        staged = C.stage.bytes
        t0 = time.perf_counter()
        state = tr.init_state()
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        tr.run(state)
        del state
        out["train"] = {"losses": [m["loss"] for m in tr.metrics],
                        "t_init_s": t_init,
                        "grad_norms": [m["grad_norm"] for m in tr.metrics],
                        "ms_steps": [m["sec_per_step"] * 1e3
                                     for m in tr.metrics],
                        "seconds": time.perf_counter() - t0,
                        "staged_bytes": C.stage.bytes - staged,
                        "peak_bytes": torch.cuda.max_memory_allocated()}
    marks["train"] = time.perf_counter()
    names = list(marks)
    out["seconds"] = {b: marks[b] - marks[a] for a, b in zip(names, names[1:])}
    return out


def phase_serve_shard_map():
    """The sharded tier's ``shard_map`` executor and the LM substrate's
    mesh: a world of ``SHARD_MAP_RANKS`` ranks on the one card over
    ``gloo`` (``shard_map_rank``), then the same train on one rank here;
    the mesh's losses against this rank's."""
    from repro_torch.launch.mesh import spawn
    from repro_torch.train import Trainer

    imported = import_checkpoint_deps()
    t0 = time.perf_counter()
    ranks = spawn(shard_map_rank, SHARD_MAP_RANKS, wall_s=SHARD_MAP_WALL_S)
    t_world = time.perf_counter() - t0
    imported.result()
    cfg, data, tc = mesh_train_setup()
    t0 = time.perf_counter()
    tr = Trainer(cfg, data, tc, device=torch.device("cuda"))
    state = tr.init_state()
    torch.cuda.synchronize()
    t_one_init = time.perf_counter() - t0
    tr.run(state)
    one = [m["loss"] for m in tr.metrics]
    one_ms = [m["sec_per_step"] * 1e3 for m in tr.metrics]
    t_one = time.perf_counter() - t0
    del tr, state
    torch.cuda.empty_cache()
    for r in ranks:
        got = r["train"]["losses"]
        if len(got) != len(one) or any(
                abs(a - b) > TRAIN_LOSS_RTOL * abs(b)
                for a, b in zip(got, one)):
            raise AssertionError(f"serve_shard_map: rank {r['rank']}'s "
                                 f"mesh losses {got}, one rank's {one}")
    arch, layers, batch, seq, steps = MESH_TRAIN
    out = {"ranks": SHARD_MAP_RANKS, "cards": torch.cuda.device_count(),
           "backend": "gloo", "matrix": matrix_label(*STREAM_MATRIX),
           "batch": SERVICE_BATCH, "iters": SHARD_MAP_ITERS,
           "t_world_s": t_world, "rank0_seconds": ranks[0]["seconds"],
           "axes": {axis: {
               "mode": ranks[0]["axes"][axis]["mode"],
               "nbytes": ranks[0]["axes"][axis]["nbytes"],
               "rows_pad": ranks[0]["axes"][axis]["rows_pad"],
               "nnz_pad": ranks[0]["axes"][axis]["nnz_pad"],
               **{op: {"max_rel_err": max(r["axes"][axis][op]["max_rel_err"]
                                          for r in ranks),
                       "launched": [r["axes"][axis][op]["launched"]
                                    for r in ranks],
                       "staged_bytes": [r["axes"][axis][op]["staged_bytes"]
                                        for r in ranks],
                       "ms": ranks[0]["axes"][axis][op]["ms"],
                       "ms_host": ranks[0]["axes"][axis][op]["ms_host"]}
                  for op in ("spmv", "spmm")}}
               for axis in ("row", "col")},
           "train": {"arch": arch, "layers": layers, "batch": batch,
                     "seq": seq, "mesh": f"{SHARD_MAP_RANKS}x1",
                     "losses_one_rank": one, "seconds_one_rank": t_one,
                     "t_init_one_rank_s": t_one_init,
                     "ms_steps_one_rank": one_ms,
                     "t_init_mesh_s": ranks[0]["train"]["t_init_s"],
                     "losses_mesh": ranks[0]["train"]["losses"],
                     "ms_steps_mesh": ranks[0]["train"]["ms_steps"],
                     "seconds_mesh": ranks[0]["train"]["seconds"],
                     "staged_bytes": [r["train"]["staged_bytes"]
                                      for r in ranks],
                     "peak_bytes": [r["train"]["peak_bytes"]
                                    for r in ranks]}}
    emit("serve_shard_map", **out)
    return {k: sum(r["axes"][a][op]["launched"].get(k, 0) for r in ranks
                   for a in ("row", "col") for op in ("spmv", "spmm"))
            for k in ("csr_spmv", "csr_spmm")}


# ---------------------------------------------------------------------------
# phase: decode_attention (K11 against its plain version)
# ---------------------------------------------------------------------------
def family_prompt_lengths(arch):
    """The prompt lengths the serve_families phase serves ``arch`` at,
    drawn from ``FAMILY_SEED`` (the first draw of its generator)."""
    _, _, slots, _, prompts, *_ = next(f for f in FAMILIES if f[0] == arch)
    rng = np.random.default_rng(FAMILY_SEED)
    return [int(n) for n in rng.choice(prompts, size=slots)], rng


#: (label, B, S, KV, G, Dh, window, q dtype, logit softcap, cache): the
#: ``served`` cases are the shapes the serve_families phase launches K11 at
#: (``SERVED_K11``: qwen3-1.7b, 8 slots of 8192; dbrx-132b, 8 of 4096 and 6
#: query heads a KV head; zamba2-1.2b's shared block, 8 of 2048, 32 KV heads
#: of 64), with random codes and q: the scores are of about one unit, so
#: every valid slot weighs in and a slot masked wrongly moves the output;
#: the softcap cases cap those scores at 1.0, so that the cap bends most of
#: them.  ``cache``: ``prefix``
#: (sequence b holds positions 0 .. lens[b] - 1, queried at the last),
#: ``ring`` (a full ring: every slot written, at positions S + lens[b] - S
#: .. S + lens[b] - 1, key_pos from models/attention.py's formula),
#: ``masked_row`` (prefix, but sequence 1 holds no valid slot: its output is
#: the mean of V)
K11_CASES = (
    ("served", 8, 8192, 8, 2, 128, None, torch.bfloat16, 0.0, "prefix"),
    ("served_f32", 8, 8192, 8, 2, 128, None, torch.float32, 0.0, "prefix"),
    ("served_dbrx", 8, 4096, 8, 6, 128, None, torch.bfloat16, 0.0, "prefix"),
    ("served_zamba2", 8, 2048, 32, 1, 64, None, torch.bfloat16, 0.0,
     "prefix"),
    ("window", 8, 8192, 8, 2, 128, 4096, torch.bfloat16, 0.0, "prefix"),
    ("g1", 8, 8192, 8, 1, 128, None, torch.bfloat16, 0.0, "prefix"),
    ("g6", 4, 4096, 4, 6, 128, None, torch.bfloat16, 0.0, "prefix"),
    ("ragged", 8, 8000, 8, 2, 128, None, torch.bfloat16, 0.0, "prefix"),
    ("ragged_f32_window", 3, 1000, 2, 3, 64, 256, torch.float32, 0.0,
     "prefix"),
    ("softcap", 8, 8192, 8, 2, 128, None, torch.bfloat16, 1.0, "prefix"),
    ("softcap_f32_window", 3, 1000, 2, 3, 64, 256, torch.float32, 1.0,
     "prefix"),
    ("ring_window", 8, 4096, 8, 2, 128, 1024, torch.bfloat16, 0.0, "ring"),
    ("masked_row", 8, 8192, 8, 2, 128, None, torch.bfloat16, 0.0,
     "masked_row"),
)
#: the family whose sequence lengths (mid-decode) each served case takes
SERVED_K11 = {"served": "qwen3-1.7b", "served_f32": "qwen3-1.7b",
              "served_dbrx": "dbrx-132b", "served_zamba2": "zamba2-1.2b"}


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


def k11_case_inputs(i):
    """``(args, kw)`` of ``K11_CASES[i]`` on the card: the served cases at
    their family's sequence lengths in the serve_families phase, mid-decode,
    the others at lengths drawn from a seed, and the cache of the case's
    kind."""
    label, B, S, KV, G, Dh, window, q_dtype, cap, cache = K11_CASES[i]
    if label in SERVED_K11:
        arch = SERVED_K11[label]
        max_new = next(f for f in FAMILIES if f[0] == arch)[5]
        lens = [n + max_new // 2 for n in family_prompt_lengths(arch)[0]]
    else:
        lens = np.random.default_rng(100 + i).integers(
            S // 2, S, size=B).tolist()
    args = k11_inputs(B, S, KV, G, Dh, q_dtype, lens, 200 + i)
    if cache == "ring":
        pos = args[6] + S
        idx = torch.arange(S, dtype=torch.int32, device=pos.device)
        args[5] = (pos[:, None] - ((pos[:, None] - idx[None, :]) % S)
                   ).contiguous()
        args[6] = pos
    elif cache == "masked_row":
        args[5][1] = -1
    return args, {"window": window, "softcap": cap}


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


def k11_valid_share(args, window):
    """The share of the cache's slots a query may read."""
    key_pos, q_pos = args[5], args[6]
    valid = (key_pos >= 0) & (key_pos <= q_pos[:, None])
    if window is not None:
        valid &= key_pos > (q_pos[:, None] - window)
    return float(valid.float().mean())


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
    """K11 against its plain version on the card at the served shapes (with
    the serve_families phase's sequence lengths, mid-decode) and at the
    others of ``K11_CASES``; each timed beside its bound and the plain
    version."""
    from repro_torch.kernels import decode_attention as K11

    results = []
    for i, (label, B, S, KV, G, Dh, window, q_dtype, cap, cache) in \
            enumerate(K11_CASES):
        args, kw = k11_case_inputs(i)
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
            "dtype": str(q_dtype).replace("torch.", ""), "cache": cache,
            "q_pos": args[6].tolist(),
            "valid_share": k11_valid_share(args, window),
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
# phase: serve_families (each family's LM server at full width, int8 KV)
# ---------------------------------------------------------------------------
def clone_caches(caches):
    """A copy of a cache tree (every block kind's fields)."""
    from repro_torch.sharding.rules import tree_map
    return tree_map(torch.clone, caches)


def profile_calls(fn, calls: int, cpu_ops: bool = True):
    """``torch.profiler`` over ``calls`` calls of ``fn(i)`` (a host clock
    around them, ended by a synchronize): the card's busy time and the
    kernels launched per call, the share of the wall time the card was
    idle, and the kernels that take most of the busy time.  ``cpu_ops=
    False`` traces the CUDA activity alone (the runtime's launch calls and
    the card's kernels, not every operator on the host): a training step's
    tens of thousands of operators take the trace's reader seconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    return {"steps": calls, "device_ms_per_step": total / 1e3 / calls,
            "wall_ms_per_step": wall * 1e3 / calls,
            "idle_share": 1.0 - total / 1e6 / wall,
            "launches_per_step": launches / calls,
            "top_kernels": [{"name": k[:80], "ms_per_step": us / 1e3 / calls,
                             "share": us / total, "calls_per_step":
                             n / calls} for k, us, n in busy[:10]]}


def profile_decode(params, cfg, snapshot, steps: int = 2):
    """:func:`profile_calls` over ``steps`` decode steps from a copy of
    ``snapshot``."""
    from repro_torch.models import model as M

    caches, toks, lengths = snapshot
    caches = clone_caches(caches)
    toks = torch.from_numpy(toks).long().cuda()
    pos = torch.from_numpy(lengths).cuda()
    with torch.no_grad():
        return profile_calls(
            lambda i: M.decode_step(params, toks, caches, pos + i, cfg),
            steps)


class MoeSpy:
    """Counts the dispatch branch each MoE call takes and keeps the expert
    choices of each call, by wrapping ``models/moe.py``'s ``moe_ell``,
    ``moe_csr`` and ``route`` (the package is not changed)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real = moe, {n: getattr(moe, n) for n in
                                    ("moe_ell", "moe_csr", "route")}
        self.branches = {"ell": 0, "csr": 0}
        self.routes = []

        def branch(name):
            def call(*a, **kw):
                self.branches[name] += 1
                return self.real["moe_" + name](*a, **kw)
            return call

        def route(*a, **kw):
            out = self.real["route"](*a, **kw)
            self.routes.append(out[0])
            return out
        moe.moe_ell, moe.moe_csr, moe.route = branch("ell"), branch("csr"), \
            route

    def take(self):
        """Branch counts and expert choices since the last take."""
        out = (dict(self.branches), self.routes)
        self.branches = {"ell": 0, "csr": 0}
        self.routes = []
        return out

    def close(self):
        for name, fn in self.real.items():
            setattr(self.moe, name, fn)


def family_weight_bytes(cfg, experts_hit=None):
    """Bytes of the parameters one decode step reads, each leaf in its
    storage dtype: all but the embedding table (its B rows are counted
    apart) and, of a MoE layer's experts, those that got a token
    (``experts_hit[layer]``)."""
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import tree_leaves

    def nbytes(tree):
        return sum(int(np.prod(s.shape)) *
                   torch.finfo(M.storage_dtype(s, cfg)).bits // 8
                   for s in tree_leaves(tree))
    spec = M.model_spec(cfg)
    total = nbytes({k: v for k, v in spec.items()
                    if k not in ("embed", "layers")})
    for i, layer in enumerate(spec["layers"]):
        for name, block in layer.items():
            if name == "moe" and experts_hit is not None:
                experts = {k: v for k, v in block.items() if k != "router"}
                total += nbytes(block["router"]) + nbytes(experts) * \
                    experts_hit[i] // cfg.n_experts
            else:
                total += nbytes(block)
    return total


def family_step_bytes(cfg, caches, lengths, experts_hit=None):
    """Bytes one decode step must move: the weights it reads
    (:func:`family_weight_bytes`), the B token embeddings, every recurrent
    state field read and written once (float32; the conv windows in the
    cache's dtype), and per attention layer the valid slots' int8 codes and
    bfloat16 scales of K and V, the new token's included."""
    B = len(lengths)
    state = kv = 0
    for layer in caches["layers"]:
        for sub, fields in layer.items():
            if sub == "attn":
                slots = fields["k"].shape[1]
                per_slot = cfg.n_kv_heads * (2 * cfg.head_dim + 2 * 2)
                kv += per_slot * sum(min(n + 1, slots) for n in lengths)
            else:
                state += 2 * sum(t.numel() * t.element_size()
                                 for t in fields.values())
    return (family_weight_bytes(cfg, experts_hit) + B * cfg.d_model * 2 +
            state + kv)


def routes_disagree(a, b):
    """Rows (sequences of a decode step) whose expert choices differ in any
    MoE layer between two runs of one step."""
    rows = set()
    for x, y in zip(a, b):
        rows |= set(torch.nonzero((x != y).any(-1)).flatten().tolist())
    return sorted(rows)


def k11_oracle_f64(args, window=None, softcap=0.0):
    """K11's masked (capped) softmax over the same dequantized operands in
    float64 on the card; also the largest |score| of a valid slot."""
    q, k_q, k_s, v_q, v_s, key_pos, q_pos = args
    k = k_q.double() * k_s.double()[..., None]
    v = v_q.double() * v_s.double()[..., None]
    s = torch.einsum("bkgd,bskd->bkgs", q.double(), k) / \
        float(np.sqrt(q.shape[-1]))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    valid = (key_pos >= 0) & (key_pos <= q_pos[:, None])
    if window is not None:
        valid &= key_pos > (q_pos[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    top = float(s.masked_fill(~valid[:, None, None, :], 0.0).abs().max())
    return torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1), v), top


def k11_against_oracle(got, plain, args, window=None, softcap=0.0):
    """A served K11 call held against a float64 oracle of its operands,
    sequence by sequence: a sequence's output passes within one bfloat16
    ulp (:func:`k11_close`'s rule), or no further from the oracle than
    twice the plain version's output for that sequence is.  Scores of
    hundreds of units (seeded weights, no qk-norm) make float32 scores
    alone move a near-tied softmax by more than an ulp, in the plain
    version as in the kernel; a slot whose weight is not negligible,
    masked or read wrongly, moves the output far past that.  The
    decode_attention phase holds K11 at the same shapes, on scores of about
    one unit, at the one-ulp rule alone."""
    want, top = k11_oracle_f64(args, window, softcap)
    rows = [k11_close(got[b], want[b], got.dtype) for b in range(len(got))]
    plain_err = [float((plain[b].double() - want[b]).abs().max())
                 for b in range(len(got))]
    one_ulp = [ok for _, ok in rows]
    ok = [u or e <= 2 * p for (e, u), p in zip(rows, plain_err)]
    return {"err": [e for e, _ in rows], "plain_err": plain_err,
            "one_ulp": one_ulp, "ok": ok, "max_abs_score": top}


def hold_family_step(params, cfg, snapshot, served, spy, arch, step_dtype):
    """One decode step from ``snapshot`` with K11 against the same step with
    its plain version in its place.  In the served dtype the step's argmax
    must be ``served`` (the tokens the engine served from that snapshot),
    and every K11 call of the step is held against a float64 oracle of its
    operands (:func:`k11_against_oracle`).  The logits of the step in
    ``step_dtype`` (the weights cast to it) must be within
    ``LM_STEP_REL_TOL`` of the plain step's, over the sequences whose expert
    choices are the same in both steps: a near tie moved by one ulp of
    attention sends a token to another expert, a different function, so
    one sequence may be routed otherwise (its own K11 outputs held as every
    sequence's are, and reported)."""
    from repro_torch.kernels import decode_attention as K11
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.sharding.rules import tree_map

    caches, toks, lengths = snapshot
    dev = torch.device("cuda")
    toks = torch.from_numpy(toks).long().to(dev)
    pos = torch.from_numpy(lengths).to(dev)
    calls = []

    def checked(*a, **kw):
        got = K11.decode_attention_int8(*a, **kw)
        calls.append(k11_against_oracle(
            got, K11.decode_attention_int8_plain(*a, **kw), a, **kw))
        return got

    def step(fn, p, c):
        A.decode_attention_int8 = fn
        try:
            with torch.no_grad():
                logits, _ = M.decode_step(p, toks, clone_caches(caches), pos,
                                          c)
        finally:
            A.decode_attention_int8 = K11.decode_attention_int8
        return logits.float(), (spy.take()[1] if spy else [])

    kernel = step(checked, params, cfg)
    lk = kernel[0]
    B = lk.shape[0]
    if lk.shape != (B, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(lk).all()):
        raise AssertionError(f"serve_families {arch}: bad logits "
                             f"{tuple(lk.shape)}")
    if lk.argmax(-1)[:, 0].tolist() != served:
        raise AssertionError(f"serve_families {arch}: the step from the "
                             f"snapshot does not give the served tokens")
    bad = [c for c in calls if not all(c["ok"])]
    if bad:
        raise AssertionError(f"serve_families {arch}: a K11 call of the step "
                             f"is further from the float64 oracle than its "
                             f"plain version allows: {bad[0]}")
    if step_dtype == cfg.compute_dtype:
        held = {"kernel": kernel,
                "plain": step(K11.decode_attention_int8_plain, params, cfg)}
    else:
        p = tree_map(lambda t: t.to(step_dtype) if t.is_floating_point()
                     else t, params)
        c = cfg.replace(dtype={torch.float32: "float32",
                               torch.bfloat16: "bfloat16"}[step_dtype])
        held = {name: step(fn, p, c) for name, fn in (
            ("kernel", K11.decode_attention_int8),
            ("plain", K11.decode_attention_int8_plain))}
        del p
    other = routes_disagree(held["kernel"][1], held["plain"][1])
    if len(other) > 1:
        raise AssertionError(f"serve_families {arch}: sequences {other} are "
                             f"routed otherwise in the plain step (at most "
                             f"one may be)")
    keep = [b for b in range(B) if b not in other]
    kk, pk = held["kernel"][0][keep], held["plain"][0][keep]
    rel = float((kk - pk).abs().max() / pk.abs().max())
    if rel > LM_STEP_REL_TOL:
        raise AssertionError(
            f"serve_families {arch}: the {step_dtype} decode step with K11 is "
            f"{rel} (of max |logits|) off the plain step")
    return {"dtype": str(step_dtype).replace("torch.", ""),
            "max_rel_err": rel, "tolerance": LM_STEP_REL_TOL,
            "argmax_agree": float((kk.argmax(-1) == pk.argmax(-1)
                                   ).float().mean()),
            "sequences_routed_otherwise": other,
            "routed_otherwise_k11": [
                {"sequence": b, "err": [c["err"][b] for c in calls],
                 "plain_err": [c["plain_err"][b] for c in calls],
                 "one_ulp": [c["one_ulp"][b] for c in calls]}
                for b in other],
            "k11_calls": len(calls),
            "k11_calls_within_one_ulp": sum(all(c["one_ulp"]) for c in calls),
            "k11_calls_on_plain_rule": sum(not all(c["one_ulp"])
                                           for c in calls),
            "k11_outputs_on_plain_rule": sum(not u for c in calls
                                             for u in c["one_ulp"]),
            "k11_outputs": sum(len(c["one_ulp"]) for c in calls),
            "k11_calls_err_to_oracle": max(max(c["err"]) for c in calls),
            "plain_calls_err_to_oracle": max(max(c["plain_err"])
                                             for c in calls),
            "max_abs_score": max(c["max_abs_score"] for c in calls)}


def serve_family(arch, layers, slots, max_len, prompts, max_new, dispatch,
                 step_dtype):
    """One family through ``ServeEngine`` on the card (bf16, int8 KV cache,
    weights from a seeded generator there, float32 reductions in cuBLAS):
    prefill of every request, then decode steps until each has ``max_new``
    tokens; K11 launches counted over both, one decode step from a snapshot
    held against the same step with K11's plain version where the model
    has attention (:func:`hold_family_step`), and two steps profiled."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ATTN_KINDS
    from repro_torch.models import model as M
    from repro_torch.models.blocks import MOE_KINDS
    from repro_torch.serve import ServeEngine

    # on by default: cuBLAS may reduce bfloat16 products in bfloat16; off
    # here, so the served numbers are those of float32 reductions
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(arch).replace(kv_quant=True)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    if dispatch is not None:
        cfg = cfg.replace(moe_dispatch=dispatch)
    dev = torch.device("cuda")
    kinds = M.layer_kinds(cfg)
    attn_layers = sum(k in ATTN_KINDS + ("mamba_attn",) for k in kinds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(
        FAMILY_SEED), device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(params, cfg, max_batch=slots, max_len=max_len,
                      device=dev)
    lens, rng = family_prompt_lengths(arch)
    for n in lens:
        eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=max_new)
    spy = MoeSpy() if cfg.n_experts else None
    try:
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._admit()          # one prefill per request, caches copied in
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        prefill_branches = spy.take()[0] if spy else None
        snapshot = (clone_caches(eng.caches), eng.last_tokens.copy(),
                    eng.lengths.copy())
        step_ms, step_tokens, step_bytes = [], [], []
        decode_branches = {"ell": 0, "csr": 0}
        while any(r is not None for r in eng.active):
            lengths = eng.lengths.tolist()
            t0 = time.perf_counter()
            n = eng.step()    # reads the tokens back: the card is done
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_tokens.append(n)
            hit = None
            if spy:
                branches, routes = spy.take()
                for k, v in branches.items():
                    decode_branches[k] += v
                moe_layers = [i for i, k in enumerate(kinds)
                              if k in MOE_KINDS]
                hit = {i: int(torch.unique(r).numel())
                       for i, r in zip(moe_layers, routes)}
            step_bytes.append(family_step_bytes(cfg, eng.caches, lengths,
                                                hit))
        path = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = len(step_ms)
        if path["decode_attention_int8"] != attn_layers * steps:
            raise AssertionError(
                f"serve_families {arch}: {path['decode_attention_int8']} K11 "
                f"launches for {steps} decode steps of {attn_layers} "
                f"attention layers")
        done = [r for _, r in sorted(eng.finished.items())]
        if len(done) != slots or any(
                len(r.generated) != max_new or not r.done or
                not all(0 <= t < cfg.vocab_size for t in r.generated)
                for r in done):
            raise AssertionError(f"serve_families {arch}: a request did not "
                                 f"finish with {max_new} tokens in the "
                                 f"vocabulary")

        step_check = (hold_family_step(
            params, cfg, snapshot, [r.generated[1] for r in done], spy, arch,
            step_dtype) if attn_layers else None)
        trace = profile_decode(params, cfg, snapshot)
    finally:
        if spy:
            spy.close()
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced

    decode_s = sum(step_ms) / 1e3
    generated = sum(len(r.generated) for r in done)
    median = statistics.median(step_ms)
    out = {
        "arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
        "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
        "layer_kinds": sorted(set(kinds)), "dtype": cfg.dtype,
        "kv_quant": True, "n_params": M.n_params(cfg),
        "n_active_params": M.n_active_params(cfg), "slots": slots,
        "max_len": max_len, "prompt_lengths": lens, "max_new_tokens": max_new,
        "moe_dispatch": cfg.moe_dispatch if cfg.n_experts else None,
        "bf16_reduced_precision_reduction": False,
        "t_init_s": t_init,
        "prefill_ms_per_request": t_prefill * 1e3 / slots,
        "prefill_tokens_per_s": sum(lens) / t_prefill,
        "decode_steps": steps, "decode_ms_median": median,
        "decode_ms_per_step": decode_s * 1e3 / steps,
        "decode_ms_steps": step_ms,
        "decode_tokens_per_s": sum(step_tokens) / decode_s,
        "tokens_per_s": generated / (t_prefill + decode_s),
        "generated_tokens": generated, "peak_memory_gb": peak / 1e9,
        "weight_bytes": family_weight_bytes(cfg),
        "step_bound_ms": sum(step_bytes) / steps / PEAK_BYTES_PER_S * 1e3,
        "step_bytes_mean": sum(step_bytes) / steps,
        "attention_layers": attn_layers,
        "k11_launches": path["decode_attention_int8"],
        "k11_launches_per_step": path["decode_attention_int8"] / steps,
        "step_vs_plain": step_check, "trace": trace,
        # the card's idle share of a decode step: 1 - busy time / step time
        "idle_share": 1.0 - trace["device_ms_per_step"] / median}
    if spy:
        out["dispatch"] = {"prefill": prefill_branches,
                           "decode": decode_branches}
    del eng, params, snapshot
    torch.cuda.empty_cache()
    return out, path


def phase_serve_families():
    """``serve_family`` for each of ``FAMILIES``, one ``emit`` line each;
    returns the K11 launches of each family's run and its decode steps."""
    paths, steps = {}, {}
    for family in FAMILIES:
        out, paths[family[0]] = serve_family(*family)
        emit("serve_families", **out)
        steps[family[0]] = {"decode_steps": out["decode_steps"],
                            "k11_per_step": out["k11_launches_per_step"]}
    return paths, steps


# ---------------------------------------------------------------------------
# phase: train
# ---------------------------------------------------------------------------
def leaf_rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 where both are all zero)."""
    scale = float(want.abs().max())
    err = float((got.float().cpu() - want.float()).abs().max())
    return err / scale if scale > 0 else err


def leaf_paths(tree, path: str = "") -> list:
    """Each leaf's path (``layers/3/mamba/D``), in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{path}/{i}")]
    return [path]


def train_held_step(arch, kw, rel, loose):
    """One training step of ``arch``'s smoke model on the card against the
    same step on the host, from one set of float32 masters and one batch:
    the loss and every gradient leaf, and the parameters after AdamW given
    the host's gradients, each leaf within its tolerance (``rel``, or
    ``loose`` by the end of the leaf's path).  Then the card's whole step:
    Adam's first step is lr * sign(g), so a parameter may move the other
    way (by more than 1.5 lr) only where the host's gradient is within the
    tolerance of zero."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.sharding.rules import tree_leaves, tree_map

    dev = torch.device("cuda")
    cfg = smoke_config(get_config(arch)).replace(**kw)
    params = M.init(cfg, torch.Generator().manual_seed(FAMILY_SEED),
                    device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(FAMILY_SEED)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
             for k in ("tokens", "labels")}
    p_card = tree_map(lambda t: t.to(dev), params)
    loss_c, g_c = value_and_grad(params, batch, cfg)
    loss_g, g_g = value_and_grad(
        p_card, {k: v.to(dev) for k, v in batch.items()}, cfg)
    tols = [next((t for k, t in loose.items() if path.endswith("/" + k)),
                 rel) for path in leaf_paths(params)]
    grad_err = max(leaf_rel_err(a, b) / tol
                   for a, b, tol in zip(g_g, g_c, tols))
    loss_err = abs(float(loss_g) - float(loss_c)) / abs(float(loss_c))
    opt = adamw.AdamWConfig(warmup_steps=1, total_steps=10)

    def tree_of(leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), params)
    want, _, _ = adamw.update(opt, tree_of(g_c), adamw.init(params), params)
    got, _, _ = adamw.update(opt, tree_of([g.to(dev) for g in g_c]),
                             adamw.init(p_card), p_card)
    param_err = max(leaf_rel_err(a, b) / tol for a, b, tol in
                    zip(tree_leaves(got), tree_leaves(want), tols))
    # the card's own step: a parameter may move the other way only where
    # the host's gradient is within the leaf's tolerance of zero (a sign
    # the two gradients need not share)
    own, _, _ = adamw.update(opt, tree_of(g_g), adamw.init(p_card), p_card)
    flipped = near_zero = stray = 0
    for a, b, g, tol in zip(tree_leaves(own), tree_leaves(want), g_c, tols):
        off = (a.cpu() - b).abs() > 1.5 * opt.lr
        near = g.abs() <= tol * g.abs().max()
        flipped += int(off.sum())
        near_zero += int(near.sum())
        stray += int((off & ~near).sum())
    out = {"arch": arch, **kw, "tol": rel, "tol_leaves": loose,
           "loss": float(loss_g), "loss_rel_err": loss_err,
           "grad_max_err_over_tol": grad_err,
           "param_max_err_over_tol": param_err,
           "own_step_params_flipped": flipped,
           "own_step_grads_near_zero": near_zero,
           "own_step_flips_off_near_zero": stray,
           "n_params": sum(p.numel() for p in tree_leaves(params))}
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= 1 and param_err <= 1
            and stray == 0):
        raise AssertionError(f"train step on the card is not the host's: "
                             f"{out}")
    return out


def train_full(arch, batch, seq, steps, falls):
    """``arch`` whole at full width through the port's ``Trainer`` on the
    card: float32 masters from a seeded generator there, bf16 compute,
    ``remat="full"``, ``SyntheticLM`` seed 0, no checkpoint (the state of
    a full-width model is tens of GB).  The step time is the trainer's
    (host clock around a step that reads its loss); one more step is
    profiled."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticLM, data_config_for
    from repro_torch.launch.analytic import analytic_costs
    from repro_torch.launch.dryrun import model_flops_for
    from repro_torch.models import model as M
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.loop import batch_to_device

    cfg = get_config(arch)
    dev = torch.device("cuda")
    data = SyntheticLM(data_config_for(cfg, seq, batch, seed=0))
    tc = TrainConfig(steps=steps, ckpt_every=10 ** 9, log_every=10 ** 9,
                     seed=0)          # ckpt_every past the run: none written
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, data, tc, device=dev)
    state = tr.init_state()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    state = tr.run(state)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in tr.metrics]
    norms = [m["grad_norm"] for m in tr.metrics]
    step_s = [m["sec_per_step"] for m in tr.metrics]
    median = statistics.median(step_s[1:])
    extra = batch_to_device(data.batch_at(steps), dev)
    trace = profile_calls(lambda i: tr._step_fn(
        state.params, state.opt_state, extra)[2]["loss"].item(), 1,
        cpu_ops=False)
    if not trace["launches_per_step"] > 0:
        raise AssertionError(f"{arch}: the profiled step shows no launch")
    shape = ShapeConfig("train", seq, batch, "train")
    costs = analytic_costs(cfg, shape, 1, 1, 1)
    model_flops = model_flops_for(cfg, shape)
    out = {"arch": arch, "batch": batch, "seq": seq, "steps": steps,
           "dtype": cfg.dtype, "remat": cfg.remat, "masters": "float32",
           "n_params": M.n_params(cfg), "t_init_s": t_init,
           "ms_per_step_median": median * 1e3,
           "ms_steps": [t * 1e3 for t in step_s],
           "tokens_per_s": batch * seq / median,
           "model_flops": model_flops,
           "mfu": model_flops / median / PEAK_BF16_FLOPS,
           "mfu_peak": "989 TF/s dense bf16 (H100 SXM data sheet)",
           "analytic_flops": costs.flops, "analytic_bytes": costs.bytes,
           "step_bound_ms": max(costs.flops / PEAK_BF16_FLOPS,
                                costs.bytes / PEAK_BYTES_PER_S) * 1e3,
           "peak_memory_gb": peak / 1e9, "losses": losses,
           "grad_norms": norms, "profiled_step": trace}
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"{arch}: a loss or grad norm is not finite: "
                             f"{losses} {norms}")
    if falls and not losses[-1] < losses[0]:
        raise AssertionError(f"{arch}: the loss did not fall: {losses}")
    del tr, state, extra
    torch.cuda.empty_cache()
    return out


def train_restart_drill():
    """qwen3's smoke model cut to 2 layers trained on the card for 6 steps
    with a checkpoint every 2 and a failure injected at step 3: it resumes
    from step 2's checkpoint, ends at 6, and its parameters equal an
    uninterrupted run's within the reference test's rtol=1e-6.  Also
    reports how far two uninterrupted runs on the card are apart."""
    import shutil
    import tempfile
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import SyntheticLM, data_config_for
    from repro_torch.sharding.rules import tree_leaves
    from repro_torch.train import TrainConfig, Trainer, run_with_restarts

    cfg = smoke_config(get_config("qwen3-1.7b")).replace(n_layers=2)
    data = SyntheticLM(data_config_for(cfg, seq_len=32, global_batch=4))
    dev = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        def trainer(name, hook=None):
            return Trainer(cfg, data, TrainConfig(
                steps=6, ckpt_every=2, log_every=10 ** 9,
                ckpt_dir=os.path.join(root, name)), failure_hook=hook,
                device=dev)
        runs = []
        for name in ("a", "b"):
            tr = trainer(name)
            runs.append(tr.run(tr.init_state()).params)
        armed = [True]

        def boom(step):
            if step == 3 and armed[0]:
                armed[0] = False
                raise RuntimeError("injected failure at step 3")
        tr = trainer("drill", boom)
        state = run_with_restarts(tr, max_restarts=2)
        seen = [m["step"] for m in tr.metrics]
        diffs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                 for a, b in zip(tree_leaves(state.params),
                                 tree_leaves(runs[0]))]
        repeat = max(float((a - b).abs().max()) for a, b in
                     zip(tree_leaves(runs[1]), tree_leaves(runs[0])))
        for a, b in zip(tree_leaves(state.params), tree_leaves(runs[0])):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    finally:
        shutil.rmtree(root)
    if seen != [1, 2, 3, 3, 4, 5, 6] or state.step != 6:
        raise AssertionError(f"restart drill resumed wrongly: {seen}")
    return {"steps_seen": seen, "final_step": state.step,
            "max_rel_diff_vs_uninterrupted": max(diffs),
            "two_uninterrupted_runs_max_abs_diff": repeat,
            "ckpt_dir_removed": not os.path.exists(root)}


def phase_train():
    """The LM substrate trained on the card, one ``emit`` line a row: the
    held smoke steps, qwen3-1.7b and zamba2-1.2b whole at full width, and
    the restart drill."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    if tf32:
        raise AssertionError("TF32 matmuls are on: the held steps compare "
                             "float32 products")
    def part(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        emit("train", part=name, seconds=time.perf_counter() - t0, **out)
    for held in TRAIN_HELD:
        part("held_step", train_held_step, *held)
    for full in TRAIN_FULL:
        part("full", train_full, *full)
    part("restart_drill", train_restart_drill)


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

    # every nvcc starts at once; K11's source takes the longest to compile
    # (~48 s on the card's host, each sparse one <= 20 s), so the kernels
    # phase starts once the ten sparse kernels are built and K11 builds on
    t0 = time.perf_counter()
    k11 = "decode_attention_int8"
    k11_built = ThreadPoolExecutor(1).submit(
        lambda: (build.build_all((k11,), force=True),
                 time.perf_counter() - t0))
    sparse = tuple(n for n in build.KERNELS if n != k11)
    build.build_all(sparse, force=True)
    for name in sparse:
        build.load(name)
    t_sparse = time.perf_counter() - t0

    phases = {}               # seconds per phase, in the summary line

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        return out

    cases = timed("kernels", phase_kernels, REPS)
    t_wait = time.perf_counter()
    _, t_k11 = k11_built.result()
    build.load(k11)
    emit("build", seconds=t_k11, seconds_sparse=t_sparse,
         seconds_waited_after_kernels=time.perf_counter() - t_wait,
         libraries={n: str(build.library_path(n).name) for n in build.KERNELS})
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
    del big
    # the hybrid path, counted on its own: each block through its kernel
    kernels.reset_launch_counts()
    timed("serve_hybrid", phase_serve_hybrid, dbs, HYBRID_ITERS)
    hybrid_path = kernels.launch_counts()
    # the SpMV service, counted on its own: the tuned rung's kernels
    kernels.reset_launch_counts()
    timed("serve_service", phase_serve_service, dbs)
    service_path = kernels.launch_counts()
    # streaming keys and the sharded tier, each counted on its own
    stream_base = suite.synthesize(
        {s.name: s for s in suite.TABLE1}[STREAM_MATRIX[0]],
        scale=STREAM_MATRIX[1])
    kernels.reset_launch_counts()
    timed("serve_stream", phase_serve_stream, stream_base)
    stream_path = kernels.launch_counts()
    kernels.reset_launch_counts()
    timed("serve_sharded", phase_serve_sharded, stream_base, dbs)
    sharded_path = kernels.launch_counts()
    # the shard_map executor: each rank counts its own launches
    shard_map_path = timed("serve_shard_map", phase_serve_shard_map)
    if not all(shard_map_path.values()):
        raise AssertionError(f"serve_shard_map launched {shard_map_path}")
    for path, name in ((stream_path, "serve_stream"),
                       (sharded_path, "serve_sharded")):
        idle = [k for k in ("csr_spmv", "csr_spmm", "ell_spmv", "ell_spmm")
                if not path[k]]
        if idle:
            raise AssertionError(f"{name} never launched {idle}")
    del dbs, db, mats, stream_base
    torch.cuda.empty_cache()
    # the LM servers, each family counted on its own inside the phase
    lm_paths, lm_steps = timed("serve_families", phase_serve_families)
    # the LM substrate trained: no kernel of this repo is on its path
    kernels.reset_launch_counts()
    timed("train", phase_train)
    train_path = kernels.launch_counts()
    launches = {k: (spmm_path if k.endswith("_spmm") else spmv_path)[k]
                for k in SPARSE_KERNELS}
    launches["decode_attention_int8"] = \
        lm_paths[LM_ARCH]["decode_attention_int8"]
    emit("launches", main_path=launches, spmv_path=spmv_path,
         spmm_path=spmm_path, hybrid_path=hybrid_path,
         service_path=service_path, stream_path=stream_path,
         sharded_path=sharded_path, shard_map_path=shard_map_path,
         lm_paths=lm_paths, lm_steps=lm_steps,
         train_path=train_path)
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
