#!/usr/bin/env python3
"""K10 ``bcsr_spmm``'s tensor-core kernel and K11 ``decode_attention_int8``
at other launch shapes than the wrappers choose, on one CUDA card.

The launch shapes are host constants of ``launch_shapes.py``; the script
sets them in turn (no rebuild) and times each variant through the public
wrapper, 20 times (device time of one call, ``core.autotune.time_device``),
in two turns (the variants in order, then reversed), each call held against
the plain version (K10: within 1e-4 of sum |a.x|; K11: ``chip_smoke``'s
tolerance).  K10 variants (``BCSR_MMA_ROWS`` block rows a CUDA block,
``BCSR_MMA_WARPS`` warps — so slices a warp in flight —,
``BCSR_MMA_BLOCKS_PER_SM``), and, for bfloat16 x bfloat16, builds of K10's
source with one change each (``K10_SOURCES``: the products widened to
float32 and run as TF32 ``m16n8k8``, one block a step; ``m16n8k16`` with
one block a step, K padded with zeros), called through the same C entry:
on xenon2 at ``scale=4.0``, viscoplastic2 at ``scale=16.0`` and torso1,
float32 and bfloat16, 8 x 8 blocks, B = 128.  K11 variants
(``DECODE_BLOCKS_PER_SM``, the grid's target of blocks an SM, so the number
of splits), and builds of K11's source with one change each
(``K11_SOURCES``: the grid's blocks ordered split first, as the first
port's were; a ring of 5 tiles a warp, not 3), called through
the same C entry; and ``DECODE_THREADS`` at 128: at the cases ``served``,
``window``, ``g6``,
``ragged_f32_window`` and ``masked_row`` of ``chip_smoke.K11_CASES``.

With ``--timeline`` it also rebuilds K11's source with a mark at each phase
of its split kernel (thread 0 reads ``%globaltimer`` at the block's start,
after its valid slots are listed, after the search of a split with none,
when its tiles start, after them, and at its end — after the merge of its
head's splits where it is the last), launches it once at the
served case through the same C entry and prints the blocks' phases: how
long each took (mean and the slowest tenth), when blocks with and without
valid slots started and ended, and the grid's span.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_k10_k11_designs.py [--out FILE] [--k10 | --k11]
        [--timeline]

It prints one line per case (median ms of each turn, their mean), the
card's name and power limit, and writes every time to ``--out`` (default
``build/k10_k11_designs.json``, git-ignored).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

REPS = 20
KERNEL_REL_TOL = 1e-4
#: (name, BCSR_MMA_ROWS, BCSR_MMA_WARPS, BCSR_MMA_BLOCKS_PER_SM)
K10_VARIANTS = (("kept", None, None, None), ("warps4", None, 4, None),
                ("warps2", None, 2, None), ("rows4", 4, 4, None),
                ("rows16", 16, None, 2), ("sm2", None, None, 2),
                ("sm4", None, None, 4))
#: K10 source variants for bfloat16 x bfloat16: (name, [(text in
#: csrc/bcsr_spmm.cu, its replacement)]); ``kept`` is the source as it stands
K10_SOURCES = (
    ("kept", []),
    ("bf16_as_tf32", [(
        "  constexpr bool BF16 = std::is_same<TD, __nv_bfloat16>::value &&",
        "  constexpr bool BF16 = false &&")]),
    ("bf16_no_pairs", [(
        "const bool two = PAIR && ns >= 2 && q + 1 < qe;",
        "const bool two = false;")]),
)
#: (name, _common constants) of K11's launch variants
K11_VARIANTS = (("kept", {}), ("blocks_per_sm=4", {"DECODE_BLOCKS_PER_SM": 4}),
                ("blocks_per_sm=16", {"DECODE_BLOCKS_PER_SM": 16}),
                ("threads=128", {"DECODE_THREADS": 128}),
                ("threads=128/blocks_per_sm=4", {"DECODE_THREADS": 128,
                                                 "DECODE_BLOCKS_PER_SM": 4}),
                ("threads=128/blocks_per_sm=16", {
                    "DECODE_THREADS": 128, "DECODE_BLOCKS_PER_SM": 16}))
K11_CASES = ("served", "window", "g6", "ragged_f32_window", "masked_row")


def times_of(fn):
    import torch

    from repro_torch.core.autotune import time_device
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return [time_device(fn) * 1e3 for _ in range(REPS)]


def set_consts(mod, **values):
    """Set the module's constants (None: keep); returns the old values."""
    old = {k: getattr(mod, k) for k in values}
    for k, v in values.items():
        if v is not None:
            setattr(mod, k, v)
    return old


#: (anchor in csrc/decode_attention_int8.cu, mark inserted before it)
TIMELINE_MARKS = (
    ("  // 1. the split's valid slots", "  DA_MARK(0);\n"),
    ("  // a split with no valid slot writes an empty partial",
     "  DA_MARK(1);\n"),
    ("      return;\n    }\n    masked_row = true;", "      DA_MARK(5);\n"),
    ("  // 2. each warp takes tiles", "  DA_MARK(2);\n"),
    ("  // 3. the warp's tiles", "  DA_MARK(3);\n"),
    ("  float* sm_acc =", "  DA_MARK(4);\n"),
    ("\n}\n\n// q (B, KV, G, Dh) float32", "\n  DA_MARK(5);"),
)
TIMELINE_HEADER = """
#define DA_SLOTS (1 << 16)
__device__ unsigned long long da_timeline[DA_SLOTS * 8];
#define DA_MARK(k)                                                       \\
  do {                                                                   \\
    if (threadIdx.x == 0) {                                              \\
      unsigned long long t_;                                             \\
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));             \\
      const long long b_ = blockIdx.x + (long long)gridDim.x *           \\
          (blockIdx.y + (long long)gridDim.y * blockIdx.z);              \\
      if (b_ < DA_SLOTS) da_timeline[b_ * 8 + (k)] = t_;                 \\
    }                                                                    \\
  } while (0)
extern "C" int da_timeline_copy(void* dst, int blocks) {
  return (int)cudaMemcpyFromSymbol(dst, da_timeline, 64LL * blocks);
}
"""


#: K11 source variants: (name, [(text in csrc/decode_attention_int8.cu,
#: its replacement)]); ``kept`` is the source as it stands
K11_SOURCES = (
    ("kept", []),
    ("split_fastest", [
        ("  const int split = blockIdx.z;\n"
         "  const int h = blockIdx.x / g_tiles;\n"
         "  const int g0 = (blockIdx.x - h * g_tiles) * GT;\n"
         "  const int b = blockIdx.y;",
         "  const int split = blockIdx.x;\n"
         "  const int h = blockIdx.y / g_tiles;\n"
         "  const int g0 = (blockIdx.y - h * g_tiles) * GT;\n"
         "  const int b = blockIdx.z;"),
        ("  const dim3 grid((unsigned)(KV * g_tiles), (unsigned)B, "
         "(unsigned)splits);",
         "  const dim3 grid((unsigned)splits, (unsigned)(KV * g_tiles), "
         "(unsigned)B);")]),
    ("stages5", [("#define DA_STAGES 3 ", "#define DA_STAGES 5 ")]),
)


def build_source(stem: str, name: str, source: str, out_dir: Path):
    """Start ``nvcc`` on one variant of a kernel's source; returns (name,
    process, .so, .cu)."""
    import os

    from repro_torch.kernels import build
    cu = build.CSRC / f"_{stem}_{name}_{os.getpid()}.cu"
    cu.write_text(source)
    so = out_dir / f"{stem}_{name}.so"
    proc = subprocess.Popen([build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                             str(so), str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, so, cu


def k10_caller(so: Path):
    """A call of the C entry of one K10 build as the wrapper makes it for
    the tensor-core kernel: ``call(data, block_cols, indptr, x, n_rows)``."""
    import ctypes

    import torch

    from repro_torch.kernels import _common as C
    from repro_torch.kernels import build
    lib = ctypes.CDLL(str(so))
    fn = lib.bcsr_spmm_launch
    fn.argtypes = list(build.SIGNATURES["bcsr_spmm"])
    fn.restype = ctypes.c_int

    def call(data, block_cols, indptr, x, n_rows):
        b, batch = data.shape[1], x.shape[1]
        kt, threads, rows, slots, stride = C.bcsr_spmm_launch(
            batch, b, None, None, x.element_size(), data.element_size())
        y = torch.empty((n_rows, batch), dtype=torch.float32,
                        device=data.device)
        code = fn(data.data_ptr(), block_cols.data_ptr(), indptr.data_ptr(),
                  x.data_ptr(), y.data_ptr(), n_rows, x.shape[0],
                  indptr.shape[0] - 1, b, batch, kt, 0, 0, rows, threads,
                  slots, stride, int(data.dtype == torch.bfloat16),
                  int(x.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{so.name}: cudaError {code}")
        return y
    return call


def k11_caller(so: Path):
    """A call of the C entry of one K11 build as the wrapper makes it:
    ``call(args, kw) -> out``."""
    import ctypes

    import numpy as np
    import torch

    from repro_torch.kernels import _common as C
    from repro_torch.kernels import build
    lib = ctypes.CDLL(str(so))
    fn = lib.decode_attention_int8_launch
    fn.argtypes = list(build.SIGNATURES["decode_attention_int8"])
    fn.restype = ctypes.c_int

    def call(args, kw):
        q, k_q, k_s, v_q, v_s, key_pos, q_pos = args
        B, S, KV, Dh = k_q.shape
        G = q.shape[2]
        lanes, threads, g_tile, per_split, splits = \
            C.decode_attention_launch(B, KV, G, S, Dh)
        part_m = torch.empty((B, KV, G, splits), device=q.device)
        part_l = torch.empty_like(part_m)
        part_acc = torch.empty((B, KV, G, splits, Dh), device=q.device)
        out = torch.empty_like(q)
        lse = torch.empty((B, KV, G), device=q.device)
        window = kw.get("window")
        code = fn(q.data_ptr(), k_q.data_ptr(), k_s.data_ptr(),
                  v_q.data_ptr(), v_s.data_ptr(), key_pos.data_ptr(),
                  q_pos.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
                  part_acc.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  counters.data_ptr(), B, S, KV, G, Dh,
                  lanes, threads, g_tile, per_split, splits,
                  0 if window is None else int(window),
                  int(window is not None),
                  float(np.float32(1.0) / np.sqrt(np.float32(Dh))),
                  float(kw.get("softcap", 0.0)),
                  int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{so.name}: cudaError {code}")
        return out
    counters = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    call.lib = lib
    return call


def k11_timeline(smoke) -> dict:
    """The served case through a build of K11 with a mark at each phase."""
    import ctypes
    import tempfile

    import numpy as np
    import torch

    from repro_torch.kernels import _common as C
    from repro_torch.kernels import build

    src = (build.CSRC / "decode_attention_int8.cu").read_text()
    src = src.replace('#include "common.cuh"\n',
                      '#include "common.cuh"\n' + TIMELINE_HEADER, 1)
    for anchor, mark in TIMELINE_MARKS:
        if anchor not in src:
            raise RuntimeError(f"timeline anchor not found: {anchor!r}")
        src = src.replace(anchor, mark + anchor, 1)
    out = Path(tempfile.mkdtemp(dir=build.build_dir()))
    name, proc, so, cu = build_source("k11", "timeline", src, out)
    log, _ = proc.communicate(timeout=600)
    cu.unlink()
    if proc.returncode:
        raise RuntimeError(f"timeline build failed:\n{log}")
    call = k11_caller(so)
    lib = call.lib
    lib.da_timeline_copy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    i = next(k for k, c in enumerate(smoke.K11_CASES) if c[0] == "served")
    args, kw = smoke.k11_case_inputs(i)
    q, k_q = args[0], args[1]
    B, S, KV, Dh = k_q.shape
    G = q.shape[2]
    _, _, g_tile, _, splits = C.decode_attention_launch(B, KV, G, S, Dh)
    blocks = splits * KV * -(-G // g_tile) * B
    for _ in range(3):
        call(args, kw)
        torch.cuda.synchronize()
    marks = np.zeros((blocks, 8), np.uint64)
    if lib.da_timeline_copy(marks.ctypes.data, blocks):
        raise RuntimeError("timeline copy failed")
    t0 = marks[:, 0].min()
    rel = (marks.astype(np.int64) - int(t0)) / 1e3          # us
    live = marks[:, 3] > 0                                   # had tiles
    phase = {"list": rel[:, 1] - rel[:, 0], "prologue": rel[:, 3] - rel[:, 2],
             "tiles": rel[:, 4] - rel[:, 3], "merge": rel[:, 5] - rel[:, 4],
             "empty": rel[:, 5] - rel[:, 1]}

    def stats(v):
        v = np.sort(v)
        return {"mean": float(v.mean()) if v.size else None,
                "p90": float(v[int(0.9 * (v.size - 1))]) if v.size else None}
    return {"blocks": blocks, "with_tiles": int(live.sum()),
            "span_us": float(rel[:, 5].max()),
            "start_with_tiles": stats(rel[live, 0]),
            "end_with_tiles": stats(rel[live, 5]),
            "start_empty": stats(rel[~live, 0]),
            "end_empty": stats(rel[~live, 5]),
            **{f"{k}_us": stats(v[live] if k != "empty" else v[~live])
               for k, v in phase.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "k10_k11_designs.json")
    ap.add_argument("--timeline", action="store_true",
                    help="also print K11's per-phase timeline")
    ap.add_argument("--k11", action="store_true",
                    help="time K11's variants only")
    ap.add_argument("--k10", action="store_true",
                    help="time K10's variants only")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_k10_k11_designs: no CUDA device available",
              file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.core import suite
    from repro_torch.core import transform as T
    from repro_torch import launch_shapes as LS
    from repro_torch.kernels import _common as C
    from repro_torch.kernels import bcsr_spmv as K9
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as K11

    build.build_all(("bcsr_spmm", "decode_attention_int8"), force=True)
    if args.timeline:
        print(json.dumps({"k11_timeline": k11_timeline(smoke)}), flush=True)
    dev = torch.device("cuda")
    specs = {s.name: s for s in suite.TABLE1}
    results = {}
    # the K11 source variants, built together
    import tempfile
    out_dir = Path(tempfile.mkdtemp(dir=build.build_dir()))
    started = []
    for stem, kernel, sources in (
            ("k11", "decode_attention_int8", () if args.k10 else K11_SOURCES),
            ("k10", "bcsr_spmm", () if args.k11 else K10_SOURCES)):
        src = (build.CSRC / f"{kernel}.cu").read_text()
        for vname, edits in sources:
            text = src
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{vname}: {old!r} not in the source")
                text = text.replace(old, new)
            started.append((stem, *build_source(stem, vname, text, out_dir)))
    callers, k10_callers = {}, {}
    for stem, vname, proc, so, cu in started:
        log, _ = proc.communicate(timeout=600)
        cu.unlink()
        if proc.returncode:
            raise RuntimeError(f"{stem} {vname} build failed:\n{log}")
        if stem == "k11":
            callers[vname] = k11_caller(so)
        else:
            k10_callers[vname] = k10_caller(so)

    def record(key, fn, check):
        check()
        results.setdefault(key, []).append(times_of(fn))

    for turn in (0, 1):
        # K10
        for name, scale in () if args.k11 else (
                ("xenon2", 4.0), ("viscoplastic2", 16.0), ("torso1", 1.0)):
            csr = suite.synthesize(specs[name], scale=scale, device="cpu")
            bm = T.host_csr_to_bcsr(csr).to(dev)
            label = name if scale == 1.0 else f"{name}@x{scale:g}"
            for dtype in (torch.float32, torch.bfloat16):
                d = bm.data.to(dtype)
                X = torch.from_numpy(np.random.default_rng(8).normal(
                    size=(bm.n_cols, 128)).astype(np.float32)).to(dev).to(
                    dtype)
                a = (d, bm.block_cols, bm.indptr)
                want = K9.bcsr_spmm_plain(*a, X, bm.n_rows)
                mag = K9.bcsr_spmm_plain(d.abs(), bm.block_cols, bm.indptr,
                                         X.abs(), bm.n_rows)
                order = list(K10_VARIANTS)
                if turn:
                    order.reverse()
                key = f"bcsr_spmm/{label}/{dtype}/B=128/".replace(
                    "torch.", "")

                def check_of(call, vname):
                    def check():
                        rel = float(((call() - want).abs()
                                     / (mag + 1e-30)).max())
                        if rel > KERNEL_REL_TOL:
                            raise AssertionError(f"{vname}: rel {rel}")
                    return check
                for vname, rows, warps, per_sm in order:
                    old = set_consts(LS, BCSR_MMA_ROWS=rows,
                                     BCSR_MMA_WARPS=warps,
                                     BCSR_MMA_BLOCKS_PER_SM=per_sm)

                    def call():
                        return K9.bcsr_spmm(*a, X, bm.n_rows, mma=True)
                    record(key + vname, call, check_of(call, vname))
                    set_consts(LS, **old)
                # the bf16 x bf16 source variants (float32 runs the same
                # code in each)
                sources = list(k10_callers.items()) if dtype == \
                    torch.bfloat16 else []
                if turn:
                    sources.reverse()
                for vname, build_call in sources:
                    def call(build_call=build_call):
                        return build_call(*a, X, bm.n_rows)
                    record(key + f"source={vname}", call,
                           check_of(call, vname))
                del X, want, mag, d
            del bm, csr
            torch.cuda.empty_cache()
        # K11 source variants, each its own build
        for i, case in enumerate(smoke.K11_CASES):
            if case[0] not in K11_CASES or args.k10:
                continue
            a, kw = smoke.k11_case_inputs(i)
            want = K11.decode_attention_int8_plain(*a, **kw)
            order = list(callers.items())
            if turn:
                order.reverse()
            for vname, call in order:
                def run(call=call):
                    return call(a, kw)

                def check():
                    err, ok = smoke.k11_close(run(), want, case[7])
                    if not ok:
                        raise AssertionError(f"{vname}/{case[0]}: err {err}")
                record(f"decode_attention_int8/{case[0]}/source={vname}", run,
                       check)
            del a, want
        # K11 splits
        for i, case in enumerate(smoke.K11_CASES):
            if case[0] not in K11_CASES or args.k10:
                continue
            a, kw = smoke.k11_case_inputs(i)
            want = K11.decode_attention_int8_plain(*a, **kw)
            order = list(K11_VARIANTS)
            if turn:
                order.reverse()
            for vname, consts in order:
                old = set_consts(LS, **consts)

                def call():
                    return K11.decode_attention_int8(*a, **kw)

                def check():
                    err, ok = smoke.k11_close(call(), want, case[7])
                    if not ok:
                        raise AssertionError(f"{case[0]}: err {err}")
                splits = C.decode_attention_launch(
                    case[1], case[3], case[4], case[2], case[5])[4]
                record(f"decode_attention_int8/{case[0]}/{vname}/splits="
                       f"{splits}", call, check)
                set_consts(LS, **old)
            del a, want
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"nvidia_smi": smi, "ms": results},
                                   indent=1))
    print("case,turn1_ms,turn2_ms,mean_ms")
    for key, turns in results.items():
        med = [statistics.median(t) for t in turns]
        print(f"{key},{med[0]:.4f},{med[1]:.4f},{sum(med) / 2:.4f}")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
