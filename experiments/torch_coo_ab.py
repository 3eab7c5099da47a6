#!/usr/bin/env python3
"""Before and after: kernels of the PyTorch/CUDA port in this checkout against
those of another checkout (for example the parent commit, unpacked with
``git archive``), on one CUDA card, in turns: other, this, this, other.

Each turn is a process of its own whose ``repro_torch`` comes from that
checkout's ``src/`` (its kernels built from that checkout's sources), so the
two versions share nothing but the card.  Every kernel is timed through its
public wrapper, 20 times (device time of one call, CUDA events behind a head
start, ``core.autotune.time_device``), beside the library call
(``torch.sparse_csr_tensor @ x|X``, float32), and every case is held against
the kernel's plain version.  ``--kernels`` picks the set:

* ``coo`` (default): K3 ``coo_spmv`` and K6 ``coo_spmm`` on xenon2 at
  ``scale=4.0`` (629 856 rows, 15 466 752 entries: past the 50 MB L2), its
  row-sorted (``coo_row``) and column-sorted (``coo_col``) COO, SpMV and
  SpMM at B = 1, 8 and 128, float32 and bfloat16, and every
  entries-per-block tile of the tuner's grid on ``coo_row``, float32, SpMV
  and B = 128.
* ``csr_ccs``: K2 ``csr_spmv`` on xenon2@x4 and torso1 (``scale=1.0``:
  116 158 rows, 8 516 500 entries, 857 rows of 4959), float32 and bfloat16,
  and float32 at each candidate of the checkout's own tuner grid; K8
  ``ccs_spmm`` at B = 1, 8 and 128 on xenon2@x4 and viscoplastic2 at
  ``scale=16.0`` (524 304 rows, 6.1 M hash-scattered entries), float32 and
  bfloat16, and at B = 128, float32, at each columns-per-block tile of the
  tuner's grid; K11 ``decode_attention_int8`` at the LM server's shape
  (B 8, S 8192, KV 8, G 2, Dh 128, bfloat16 q).
* ``ccs_ell``: K7 ``ccs_spmv`` on xenon2@x4, viscoplastic2@x16 and torso1,
  float32 and bfloat16, and float32 at each columns-per-block candidate of
  the checkout's own tuner grid (with the global atomics the launch issues,
  ``ccs_spmv_flushes``, where the checkout counts them); K4 ``ell_spmm`` on
  xenon2@x4's ELL-Row, ELL-Col (viewed transposed) and SELL (every bucket
  in one call, as the batched path launches them) at B = 1, 8, 32 and 128,
  float32 and bfloat16.
* ``ell_csr``: K1 ``ell_spmv`` on ELL-Row, ELL-Col (viewed transposed) and
  SELL (every bucket in one call) of xenon2@x4, torso2 and torso3
  (``scale=1.0``: 115 067 rows of ~9 entries, few pads; 259 156 rows of
  ~17, past the L2), float32 and bfloat16, read as the checkout's main path
  reads them — up to each row's live extent where the wrapper takes one and
  ``extent_pays`` says so (computed once, outside the timed call), else the
  whole band — and, in a checkout with extents, each way forced
  (``/extent``, ``/band``); K5 ``csr_spmm`` on xenon2@x4,
  viscoplastic2@x16 and torso1 at B = 1, 8, 32 and 128, float32 and
  bfloat16, with the entries its windows miss (``csr_spmm_window_misses``)
  where the checkout counts them, launched as the main path launches it
  (a checkout with the window kernel: by the bound matrix's structure,
  ``ops.csr_window_of``) and, in such a checkout, also in each kernel
  (``window``, ``row-groups``) and, at B = 32 and 128, in the window kernel
  at 16, 32, 64 and 128 rows a block.
* ``bcsr_k11``: K10 ``bcsr_spmm`` on xenon2@x4, viscoplastic2@x16 and
  torso1 (8 x 8 blocks, as the main path transforms them) at B = 1, 8, 32
  and 128, float32 and bfloat16, launched as the checkout's main path
  launches it and, in a checkout with the tensor-core kernel, in each
  kernel forced (``mma``, ``rows`` — the first port's lane groups); K11
  ``decode_attention_int8`` at every case of ``chip_smoke.K11_CASES`` (this
  checkout's list, inputs built as ``chip_smoke.py`` builds them).
* ``decode_step``: the LM server's decode step, as ``chip_smoke.py``
  serves qwen3-1.7b (the ``serve_families`` phase's first model, or the
  ``serve_lm`` phase of a checkout that has it; the checkout's
  ``repro_torch``: qwen3-1.7b at full width and depth, 8 requests into 8
  slots of 8192, 32 new tokens each): the host-clock ms of each decode step
  and the card's busy ms a step from its ``torch.profiler`` trace.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_coo_ab.py --other DIR
        [--kernels coo|csr_ccs|ccs_ell|ell_csr|bcsr_k11|decode_step]
        [--out FILE]

It prints one line per case (median ms of each turn and the spread of this
checkout's 40 times; a case only one checkout has, such as a tile of a grid
that changed, shows its own turns), the card's name and power limit, and
writes every time to ``--out`` (default ``build/<kernels>_ab.json``,
git-ignored).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPS = 20
BATCHES = (None, 1, 8, 128)        # None: SpMV
#: a kernel against its plain version, relative to sum |data * x| of the
#: output element (as ``chip_smoke.KERNEL_REL_TOL``)
KERNEL_REL_TOL = 1e-4


def rel_err(got, want, mag) -> float:
    """Largest error relative to the plain version on |data|, |x|."""
    return float(((got - want).abs() / (mag + 1e-30)).max())


def worker(kernels: str) -> None:
    """One turn: the ``repro_torch`` on ``sys.path`` times the kernels of
    the set ``kernels`` and prints one JSON line."""
    cases, names = {"coo": coo_cases, "csr_ccs": csr_ccs_cases,
                    "ccs_ell": ccs_ell_cases,
                    "ell_csr": ell_csr_cases,
                    "bcsr_k11": bcsr_k11_cases,
                    "decode_step": decode_step_cases}[kernels]()
    import hashlib

    import torch

    import repro_torch
    from repro_torch.kernels import build
    src = hashlib.sha256(b"".join(
        (build.CSRC / f"{k}.cu").read_bytes() for k in names)).hexdigest()[:12]
    print(json.dumps({"repro_torch": repro_torch.__file__, "sources": src,
                      "device": torch.cuda.get_device_name(0),
                      "cases": cases}), flush=True)


def times_of(fn):
    """``REPS`` device times of one call, in ms, after warm-up."""
    import torch

    from repro_torch.core.autotune import time_device
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return [time_device(fn) * 1e3 for _ in range(REPS)]


def coo_cases():
    """K3 and K6 on xenon2@x4 (``--kernels coo``)."""
    import numpy as np
    import torch

    from repro_torch.core import suite
    from repro_torch.core import transform as T
    from repro_torch.core.kernel_tune import GPU_NNZ_TILES
    from repro_torch.kernels import build
    from repro_torch.kernels import coo_spmv as K3

    build.build_all(("coo_spmv", "coo_spmm"), force=True)
    spec = next(s for s in suite.TABLE1 if s.name == "xenon2")
    csr = suite.synthesize(spec, scale=4.0, device="cpu")
    dev = torch.device("cuda")
    layouts = {"coo_row": T.host_csr_to_coo_row(csr).to(dev),
               "coo_col": T.host_csr_to_coo_col(csr).to(dev)}
    m = csr.to(dev)
    lib = torch.sparse_csr_tensor(m.indptr, m.cols[:m.nnz], m.data[:m.nnz],
                                  size=csr.shape)
    n = csr.n_rows
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for batch in BATCHES:
            rng = np.random.default_rng(7 + (batch or 0))
            shape = (csr.n_cols,) if batch is None else (csr.n_cols, batch)
            x = torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(dev).to(dtype)
            kern, plain = ((K3.coo_spmv, K3.coo_spmv_plain) if batch is None
                           else (K3.coo_spmm, K3.coo_spmm_plain))
            lib_ms = (statistics.median(times_of(lambda: lib @ x))
                      if dtype == torch.float32 else None)
            for layout, coo in layouts.items():
                d = coo.data.to(dtype)
                tiles = ((None,) + GPU_NNZ_TILES
                         if layout == "coo_row" and dtype == torch.float32
                         and batch in (None, 128) else (None,))
                for bn in tiles:
                    def call(bn=bn):
                        return kern(d, coo.rows, coo.cols, x, n,
                                    block_nnz=bn)
                    got, want = call(), plain(d, coo.rows, coo.cols, x, n)
                    mag = plain(d.abs(), coo.rows, coo.cols, x.abs(), n)
                    rel = rel_err(got, want, mag)
                    if rel > KERNEL_REL_TOL:
                        raise AssertionError(f"{layout} B={batch} {dtype} "
                                             f"block_nnz={bn}: rel err {rel}")
                    del got, want, mag
                    cases.append({
                        "key": f"{kern.__name__}/{layout}/{dtype}/B={batch}"
                               f"/bn={bn}".replace("torch.", ""),
                        "max_rel_err": rel, "ms": times_of(call),
                        "library_ms": lib_ms})
    return cases, ("coo_spmv", "coo_spmm")


def csr_ccs_cases():
    """K2 on xenon2@x4 and torso1, K8 on xenon2@x4 and viscoplastic2@x16,
    K11 at the served shape (``--kernels csr_ccs``)."""
    import inspect

    import numpy as np
    import torch

    from repro_torch.core import suite
    from repro_torch.core import transform as T
    from repro_torch.core.kernel_tune import candidate_geometries
    from repro_torch.kernels import build
    from repro_torch.kernels import ccs_spmv as K7
    from repro_torch.kernels import csr_spmv as K2
    from repro_torch.kernels import decode_attention as K11

    build.build_all(("csr_spmv", "ccs_spmm", "decode_attention_int8"),
                    force=True)
    specs = {s.name: s for s in suite.TABLE1}
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []

    def case(key, call, plain, plain_abs, lib_ms):
        got, want, mag = call(), plain(), plain_abs()
        rel = rel_err(got, want, mag)
        if rel > KERNEL_REL_TOL:
            raise AssertionError(f"{key}: rel err {rel}")
        del got, want, mag
        cases.append({"key": key, "max_rel_err": rel, "ms": times_of(call),
                      "library_ms": lib_ms})

    # K2: the knob this checkout's wrapper reads
    knobs = [k for k in ("block_rows", "block_nnz")
             if k in inspect.signature(K2.csr_spmv).parameters]
    for name, scale in (("xenon2", 4.0), ("torso1", 1.0)):
        csr = suite.synthesize(specs[name], scale=scale, device="cpu")
        m = csr.to(dev)
        label = name if scale == 1.0 else f"{name}@x{scale:g}"
        lib = torch.sparse_csr_tensor(m.indptr, m.cols[:m.nnz],
                                      m.data[:m.nnz], size=csr.shape)
        grid = candidate_geometries("csr", "spmv", n_rows=m.n_rows,
                                    nnz_pad=m.nnz_pad)
        for dtype in (f32, bf16):
            x = torch.from_numpy(np.random.default_rng(7).normal(
                size=m.n_cols).astype(np.float32)).to(dev).to(dtype)
            d = m.data.to(dtype)
            lib_ms = (statistics.median(times_of(lambda: lib @ x))
                      if dtype == f32 else None)
            for g in [None] + (grid if dtype == f32 else []):
                kw = {} if g is None else {k: getattr(g, k) for k in knobs
                                           if getattr(g, k) is not None}
                case(f"csr_spmv/{label}/{dtype}/{kw or 'default'}"
                     .replace("torch.", ""),
                     lambda kw=kw: K2.csr_spmv(d, m.cols, m.indptr, x, **kw),
                     lambda: K2.csr_spmv_plain(d, m.cols, m.indptr, x),
                     lambda: K2.csr_spmv_plain(d.abs(), m.cols, m.indptr,
                                               x.abs()), lib_ms)
        del m, lib, csr
    # K8
    for name, scale in (("xenon2", 4.0), ("viscoplastic2", 16.0)):
        csr = suite.synthesize(specs[name], scale=scale, device="cpu")
        ccs = T.host_csr_to_ccs(csr).to(dev)
        m = csr.to(dev)
        label = f"{name}@x{scale:g}"
        lib = torch.sparse_csr_tensor(m.indptr, m.cols[:m.nnz],
                                      m.data[:m.nnz], size=csr.shape)
        n = ccs.n_rows
        for dtype in (f32, bf16):
            d = ccs.data.to(dtype)
            for batch in (1, 8, 128):
                X = torch.from_numpy(np.random.default_rng(8).normal(
                    size=(ccs.n_cols, batch)).astype(np.float32)).to(
                    dev).to(dtype)
                lib_ms = (statistics.median(times_of(lambda: lib @ X))
                          if dtype == f32 else None)
                want = K7.ccs_spmm_plain(d, ccs.rows, ccs.indptr, X, n)
                mag = K7.ccs_spmm_plain(d.abs(), ccs.rows, ccs.indptr,
                                        X.abs(), n)
                tiles = [None]
                if dtype == f32 and batch == 128:
                    tiles += [g.block_rows for g in candidate_geometries(
                        "ccs", "spmm", n_rows=ccs.n_cols,
                        nnz_pad=ccs.nnz_pad, batch=batch)
                        if g.block_k == 128]
                for br in tiles:
                    case(f"ccs_spmm/{label}/{dtype}/B={batch}/rows={br}"
                         .replace("torch.", ""),
                         lambda br=br: K7.ccs_spmm(d, ccs.rows, ccs.indptr, X,
                                                   n, block_rows=br),
                         lambda: want, lambda: mag, lib_ms)
                del X, want, mag
        del ccs, m, lib, csr
        torch.cuda.empty_cache()
    # K11 at the LM server's shape, mid-decode
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, KV, G, Dh = 8, 8192, 8, 2, 128
    codes = lambda: torch.randint(-127, 128, (B, S, KV, Dh), generator=g,
                                  device=dev, dtype=torch.int8)
    scales = lambda: (torch.rand((B, S, KV), generator=g, device=dev)
                      * 0.02).to(bf16)
    q = torch.randn((B, KV, G, Dh), generator=g, device=dev).to(bf16)
    lens = torch.tensor([6160, 4112, 4112, 2064, 2064, 1040, 1040, 1040],
                        dtype=torch.int32, device=dev)
    idx = torch.arange(S, dtype=torch.int32, device=dev)
    key_pos = torch.where(idx[None, :] < lens[:, None], idx[None, :],
                          torch.full_like(idx[None, :], -1)).contiguous()
    args = [q, codes(), scales(), codes(), scales(), key_pos, lens - 1]
    want = K11.decode_attention_int8_plain(*args).float()
    got = K11.decode_attention_int8(*args).float()
    err = float((got - want).abs().max())
    if err > 1e-2:
        raise AssertionError(f"decode_attention_int8: max abs err {err}")
    cases.append({"key": "decode_attention_int8/served/bfloat16",
                  "max_abs_err": err,
                  "ms": times_of(lambda: K11.decode_attention_int8(*args)),
                  "library_ms": None})
    return cases, ("csr_spmv", "ccs_spmm", "decode_attention_int8")


def ccs_ell_cases():
    """K7 on xenon2@x4, viscoplastic2@x16 and torso1, K4 on xenon2@x4's
    ELL-Row, ELL-Col and SELL (``--kernels ccs_ell``)."""
    import numpy as np
    import torch

    from repro_torch.core import suite
    from repro_torch.core import transform as T
    from repro_torch.core.kernel_tune import candidate_geometries
    from repro_torch.kernels import build
    from repro_torch.kernels import ccs_spmv as K7
    from repro_torch.kernels import ell_spmv as K1

    build.build_all(("ccs_spmv", "ell_spmm"), force=True)
    specs = {s.name: s for s in suite.TABLE1}
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []

    def case(key, call, plain, plain_abs, lib_ms, **info):
        """``call`` gives the kernel's outputs as a list (a SELL product is
        one launch a bucket), ``plain`` and ``plain_abs`` theirs joined."""
        got, want, mag = torch.cat(call()), plain(), plain_abs()
        rel = rel_err(got, want, mag)
        if rel > KERNEL_REL_TOL:
            raise AssertionError(f"{key}: rel err {rel}")
        del got, want, mag
        cases.append({"key": key, "max_rel_err": rel, "ms": times_of(call),
                      "library_ms": lib_ms, **info})

    def library_ms(m, x):
        lib = torch.sparse_csr_tensor(m.indptr, m.cols[:m.nnz],
                                      m.data[:m.nnz], size=m.shape)
        return statistics.median(times_of(lambda: lib @ x))

    # K7
    for name, scale in (("xenon2", 4.0), ("viscoplastic2", 16.0),
                        ("torso1", 1.0)):
        csr = suite.synthesize(specs[name], scale=scale, device="cpu")
        ccs = T.host_csr_to_ccs(csr).to(dev)
        m = csr.to(dev)
        label = name if scale == 1.0 else f"{name}@x{scale:g}"
        n = ccs.n_rows
        grid = candidate_geometries("ccs", "spmv", n_rows=ccs.n_cols,
                                    nnz_pad=ccs.nnz_pad)
        for dtype in (f32, bf16):
            x = torch.from_numpy(np.random.default_rng(7).normal(
                size=ccs.n_cols).astype(np.float32)).to(dev).to(dtype)
            d = ccs.data.to(dtype)
            lib_ms = library_ms(m, x) if dtype == f32 else None
            want = K7.ccs_spmv_plain(d, ccs.rows, ccs.indptr, x, n)
            mag = K7.ccs_spmv_plain(d.abs(), ccs.rows, ccs.indptr, x.abs(),
                                    n)
            for br in [None] + ([g.block_rows for g in grid]
                                if dtype == f32 else []):
                info = {}
                if hasattr(K7, "ccs_spmv_flushes") and dtype == f32:
                    info["flushes"] = K7.ccs_spmv_flushes(
                        ccs.rows, ccs.indptr, n, br)
                case(f"ccs_spmv/{label}/{dtype}/rows={br}"
                     .replace("torch.", ""),
                     lambda br=br: [K7.ccs_spmv(d, ccs.rows, ccs.indptr, x,
                                                n, block_rows=br)],
                     lambda: want, lambda: mag, lib_ms, **info)
            del want, mag
        del ccs, m, csr
        torch.cuda.empty_cache()
    # K4
    csr = suite.synthesize(specs["xenon2"], scale=4.0, device="cpu")
    m = csr.to(dev)
    row = T.host_csr_to_ell(csr, order="row").to(dev)
    col = T.host_csr_to_ell(csr, order="col").to(dev)
    sell = T.host_csr_to_sell(csr).to(dev)
    for dtype in (f32, bf16):
        panels = {"ell_row": [(row.data.to(dtype), row.cols)],
                  "ell_col": [(col.data.to(dtype).t(), col.cols.t())],
                  "sell": [(b.data.to(dtype), b.cols) for b in sell.buckets]}
        for batch in (1, 8, 32, 128):
            X = torch.from_numpy(np.random.default_rng(8).normal(
                size=(csr.n_cols, batch)).astype(np.float32)).to(
                dev).to(dtype)
            lib_ms = library_ms(m, X) if dtype == f32 else None
            for layout, ps in panels.items():
                def call(ps=ps):
                    return [K1.ell_spmm(d, c, X) for d, c in ps]

                def plain(ps=ps, f=K1.ell_spmm_plain):
                    return torch.cat([f(d, c, X) for d, c in ps])

                def plain_abs(ps=ps, f=K1.ell_spmm_plain):
                    return torch.cat([f(d.abs(), c, X.abs()) for d, c in ps])
                case(f"ell_spmm/xenon2@x4/{layout}/{dtype}/B={batch}"
                     .replace("torch.", ""), call, plain, plain_abs, lib_ms)
            del X
        del panels
    return cases, ("ccs_spmv", "ell_spmm")


def ell_csr_cases():
    """K1 on xenon2@x4, torso2 and torso3; K5 on xenon2@x4,
    viscoplastic2@x16 and torso1 (``--kernels ell_csr``)."""
    import inspect

    import numpy as np
    import torch

    from repro_torch.core import suite
    from repro_torch.core import transform as T
    from repro_torch.kernels import build
    from repro_torch.kernels import csr_spmv as K2
    from repro_torch.kernels import ell_spmv as K1

    build.build_all(("ell_spmv", "csr_spmm"), force=True)
    specs = {s.name: s for s in suite.TABLE1}
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    extents = "extent" in inspect.signature(K1.ell_spmv).parameters
    windows = hasattr(K2, "csr_spmm_structure")
    cases = []

    def case(key, call, plain, plain_abs, lib_ms, **info):
        """``call`` gives the kernel's outputs as a list (a SELL product is
        one launch a bucket), ``plain`` and ``plain_abs`` theirs joined."""
        got, want, mag = torch.cat(call()), plain(), plain_abs()
        rel = rel_err(got, want, mag)
        if rel > KERNEL_REL_TOL:
            raise AssertionError(f"{key}: rel err {rel}")
        del got, want, mag
        cases.append({"key": key, "max_rel_err": rel, "ms": times_of(call),
                      "library_ms": lib_ms, **info})

    def library_ms(m, x):
        lib = torch.sparse_csr_tensor(m.indptr, m.cols[:m.nnz],
                                      m.data[:m.nnz], size=m.shape)
        return statistics.median(times_of(lambda: lib @ x))

    # K1
    for name, scale in (("xenon2", 4.0), ("torso2", 1.0), ("torso3", 1.0)):
        csr = suite.synthesize(specs[name], scale=scale, device="cpu")
        m = csr.to(dev)
        label = name if scale == 1.0 else f"{name}@x{scale:g}"
        row = T.host_csr_to_ell(csr, order="row").to(dev)
        col = T.host_csr_to_ell(csr, order="col").to(dev)
        sell = T.host_csr_to_sell(csr).to(dev)
        for dtype in (f32, bf16):
            x = torch.from_numpy(np.random.default_rng(7).normal(
                size=csr.n_cols).astype(np.float32)).to(dev).to(dtype)
            lib_ms = library_ms(m, x) if dtype == f32 else None
            panels = {"ell_row": [(row.data.to(dtype), row.cols)],
                      "ell_col": [(col.data.to(dtype).t(), col.cols.t())],
                      "sell": [(b.data.to(dtype), b.cols)
                               for b in sell.buckets]}
            for layout, ps in panels.items():
                ps = [(d, c, K1.ell_extent(d, c) if extents else None)
                      for d, c in ps]
                # the main path's reading (this checkout: up to the extents
                # where they pay), then each reading forced
                reads = [("", [e if extents and K1.extent_pays(e, d.shape[1])
                               else None for d, _, e in ps])]
                if extents:
                    reads += [("/extent", [e for _, _, e in ps]),
                              ("/band", [None for _ in ps])]
                for tag, es in reads:
                    def call(ps=ps, es=es):
                        return [K1.ell_spmv(d, c, x, **({} if e is None
                                                        else {"extent": e}))
                                for (d, c, _), e in zip(ps, es)]

                    def plain(ps=ps):
                        return torch.cat([K1.ell_spmv_plain(d, c, x)
                                          for d, c, _ in ps])

                    def plain_abs(ps=ps):
                        return torch.cat([K1.ell_spmv_plain(d.abs(), c,
                                                            x.abs())
                                          for d, c, _ in ps])
                    info = {"slots": sum(d.numel() for d, _, _ in ps),
                            "extent_read": sum(e is not None for e in es)}
                    if extents:
                        info["live_slots"] = sum(int(e.sum())
                                                 for _, _, e in ps)
                    case(f"ell_spmv/{label}/{layout}/{dtype}{tag}".replace(
                        "torch.", ""), call, plain, plain_abs, lib_ms, **info)
            del panels
        del m, row, col, sell, csr
        torch.cuda.empty_cache()
    # K5
    if windows:
        from repro_torch.kernels import ops
    for name, scale in (("xenon2", 4.0), ("viscoplastic2", 16.0),
                        ("torso1", 1.0)):
        csr = suite.synthesize(specs[name], scale=scale, device="cpu")
        m = csr.to(dev)
        label = name if scale == 1.0 else f"{name}@x{scale:g}"
        if windows:
            ops.prepare(m)
        for dtype in (f32, bf16):
            d = m.data.to(dtype)
            for batch in (1, 8, 32, 128):
                X = torch.from_numpy(np.random.default_rng(8).normal(
                    size=(m.n_cols, batch)).astype(np.float32)).to(
                    dev).to(dtype)
                lib_ms = library_ms(m, X) if dtype == f32 else None
                want = K2.csr_spmm_plain(d, m.cols, m.indptr, X)
                mag = K2.csr_spmm_plain(d.abs(), m.cols, m.indptr, X.abs())
                # default: as the main path launches it (a checkout with
                # the window kernel: by the bound matrix's structure)
                variants = [("default", {"window": ops.csr_window_of(
                    m, batch)} if windows else {})]
                if windows:
                    variants += [("window", {"window": True}),
                                 ("row-groups", {"window": False})]
                if windows and batch >= 32:
                    variants += [(f"rows={r}", {"block_rows": r,
                                                "window": True})
                                 for r in (16, 32, 64, 128)]
                for vname, kw in variants:
                    info = {}
                    if windows:
                        info["windows"] = K2.csr_spmm_window_misses(
                            m.cols, m.indptr, m.n_cols, batch,
                            x_dtype=dtype, **kw)

                    def call(kw=kw):
                        return [K2.csr_spmm(d, m.cols, m.indptr, X, **kw)]
                    case(f"csr_spmm/{label}/{dtype}/B={batch}/{vname}"
                         .replace("torch.", ""), call, lambda: want,
                         lambda: mag, lib_ms, **info)
                del X, want, mag
        del m, csr
        torch.cuda.empty_cache()
    return cases, ("ell_spmv", "csr_spmm")


def bcsr_k11_cases():
    """K10 on xenon2@x4, viscoplastic2@x16 and torso1; K11 at every case of
    ``chip_smoke.K11_CASES`` (``--kernels bcsr_k11``)."""
    import inspect

    import numpy as np
    import torch

    from repro_torch.core import suite
    from repro_torch.core import transform as T
    from repro_torch.kernels import bcsr_spmv as K9
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as K11
    from repro_torch.kernels import ops

    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    build.build_all(("bcsr_spmm", "decode_attention_int8"), force=True)
    specs = {s.name: s for s in suite.TABLE1}
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    mma = "mma" in inspect.signature(K9.bcsr_spmm).parameters
    cases = []

    def case(key, call, plain, plain_abs, lib_ms, **info):
        got, want, mag = call(), plain(), plain_abs()
        rel = rel_err(got, want, mag)
        if rel > KERNEL_REL_TOL:
            raise AssertionError(f"{key}: rel err {rel}")
        del got, want, mag
        cases.append({"key": key, "max_rel_err": rel, "ms": times_of(call),
                      "library_ms": lib_ms, **info})

    # K10
    for name, scale in (("xenon2", 4.0), ("viscoplastic2", 16.0),
                        ("torso1", 1.0)):
        csr = suite.synthesize(specs[name], scale=scale, device="cpu")
        m = csr.to(dev)
        bm = T.host_csr_to_bcsr(csr).to(dev)
        ops.prepare(bm)
        label = name if scale == 1.0 else f"{name}@x{scale:g}"
        lib = torch.sparse_csr_tensor(m.indptr, m.cols[:m.nnz],
                                      m.data[:m.nnz], size=csr.shape)
        nblocks = int(bm.indptr[-1])
        for dtype in (f32, bf16):
            d = bm.data.to(dtype)
            for batch in (1, 8, 32, 128):
                X = torch.from_numpy(np.random.default_rng(8).normal(
                    size=(bm.n_cols, batch)).astype(np.float32)).to(
                    dev).to(dtype)
                lib_ms = (statistics.median(times_of(lambda: lib @ X))
                          if dtype == f32 else None)
                args = (d, bm.block_cols, bm.indptr)
                want = K9.bcsr_spmm_plain(*args, X, bm.n_rows)
                mag = K9.bcsr_spmm_plain(d.abs(), bm.block_cols, bm.indptr,
                                         X.abs(), bm.n_rows)
                # as the main path launches it (ops.spmm_bcsr)
                variants = [("default", lambda: K9.bcsr_spmm(
                    *args, X, bm.n_rows))]
                if mma:
                    variants += [
                        ("mma", lambda: K9.bcsr_spmm(*args, X, bm.n_rows,
                                                     mma=True)),
                        ("rows", lambda: K9.bcsr_spmm(*args, X, bm.n_rows,
                                                      mma=False))]
                for vname, call in variants:
                    case(f"bcsr_spmm/{label}/{dtype}/B={batch}/{vname}"
                         .replace("torch.", ""), lambda call=call:
                         call(), lambda: want, lambda: mag, lib_ms,
                         nblocks=nblocks)
                del X, want, mag
        del m, bm, lib, csr
        torch.cuda.empty_cache()
    # K11 at every case of chip_smoke.py, its inputs built as it builds them
    for i, (label, B, S, KV, G, Dh, window, q_dtype, cap, *rest) in \
            enumerate(smoke.K11_CASES):
        args, kw = smoke.k11_case_inputs(i)
        want = K11.decode_attention_int8_plain(*args, **kw)
        got = K11.decode_attention_int8(*args, **kw)
        err, ok = smoke.k11_close(got, want, q_dtype)
        if not ok:
            raise AssertionError(f"decode_attention_int8/{label}: max abs "
                                 f"err {err}")
        cases.append({"key": f"decode_attention_int8/{label}",
                      "max_abs_err": err,
                      "ms": times_of(lambda: K11.decode_attention_int8(
                          *args, **kw)),
                      "library_ms": None})
        del args, got, want
    return cases, ("bcsr_spmm", "decode_attention_int8")


def decode_step_cases():
    """The LM server's decode steps, served as ``chip_smoke.py`` serves
    qwen3-1.7b (``--kernels decode_step``): the host-clock ms of every step
    and the card's busy ms a step."""
    import repro_torch       # the checkout's, before chip_smoke adds ROOT/src

    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    if hasattr(smoke, "phase_serve_lm"):      # an older checkout
        out, _ = smoke.phase_serve_lm()
    else:
        out, _ = smoke.serve_family(*smoke.FAMILIES[0])
    return ([{"key": "serve_lm/decode_ms_step", "ms": out["decode_ms_steps"],
              "library_ms": None},
             {"key": "serve_lm/device_ms_step",
              "ms": [out["trace"]["device_ms_per_step"]],
              "library_ms": None}],
            ("decode_attention_int8",))


def turn(checkout: Path, kernels: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--worker", "--kernels", kernels], env=env,
                         cwd=checkout, capture_output=True, text=True,
                         timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {checkout} failed:\n{out.stderr[-4000:]}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if not Path(got["repro_torch"]).resolve().is_relative_to(
            (checkout / "src").resolve()):
        raise RuntimeError(f"turn in {checkout} ran {got['repro_torch']}")
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path,
                    help="root of the checkout to compare with")
    ap.add_argument("--kernels",
                    choices=("coo", "csr_ccs", "ccs_ell", "ell_csr",
                             "bcsr_k11", "decode_step"),
                    default="coo",
                    help="the kernels to time (see the module's docstring)")
    ap.add_argument("--out", type=Path, help="where to write every time")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.kernels)
        return 0
    if args.other is None:
        ap.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        print("torch_coo_ab: no CUDA device available", file=sys.stderr)
        return 1
    out = args.out or ROOT / "build" / f"{args.kernels}_ab.json"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    order = [("other", args.other.resolve()), ("this", ROOT),
             ("this", ROOT), ("other", args.other.resolve())]
    turns = [(name, turn(path, args.kernels)) for name, path in order]
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "kernels": args.kernels,
                               "order": [{"checkout": name, **t}
                                         for name, t in turns]}, indent=1))
    print("case,other_ms(turn1/turn4),this_ms(turn2/turn3),"
          "this/other,this_min..max,library_ms")
    by_key = [{c["key"]: c for c in t["cases"]} for _, t in turns]
    keys = list(dict.fromkeys(k for t in by_key for k in t))
    for key in keys:
        med = [statistics.median(t[key]["ms"]) if key in t else None
               for t in by_key]
        lib = next(t[key]["library_ms"] for t in by_key if key in t)
        fmt = lambda a, b: ("-" if a is None else f"{a:.4f}/{b:.4f}")
        mine = (by_key[1][key]["ms"] + by_key[2][key]["ms"]
                if key in by_key[1] else None)
        ratio = ((med[1] + med[2]) / (med[0] + med[3])
                 if None not in med else None)
        print(f"{key},{fmt(med[0], med[3])},{fmt(med[1], med[2])},"
              f"{'-' if ratio is None else f'{ratio:.3f}'},"
              f"{'-' if mine is None else f'{min(mine):.4f}..{max(mine):.4f}'}"
              f",{lib}")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
