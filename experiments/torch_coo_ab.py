#!/usr/bin/env python3
"""Before and after: the COO kernels of the PyTorch/CUDA port (K3
``coo_spmv``, K6 ``coo_spmm``) of this checkout against those of another
checkout (for example the parent commit, unpacked with ``git archive``), on
one CUDA card, in turns: other, this, this, other.

Each turn is a process of its own whose ``repro_torch`` comes from that
checkout's ``src/`` (its kernels built from that checkout's sources), so the
two versions share nothing but the card.  A turn synthesizes xenon2 at
``scale=4.0`` (629 856 rows, 15 466 752 entries: past the 50 MB L2), builds
its row-sorted (``coo_row``) and column-sorted (``coo_col``) COO, and times
each kernel through its public wrapper at the default launch — SpMV and SpMM
at B = 1, 8 and 128, float32 and bfloat16 — 20 times (device time of one
call, CUDA events behind a head start, ``core.autotune.time_device``),
beside the library call (``torch.sparse_csr_tensor @ x|X``, float32).  It
also times every entries-per-block tile of the tuner's grid on ``coo_row``,
float32, SpMV and B = 128, and holds every case against the plain version.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_coo_ab.py --other DIR [--out FILE]

It prints one line per case (median ms of each turn and the spread of this
checkout's 40 times), the card's name and power limit, and writes every
time to ``--out`` (default ``build/coo_ab.json``, git-ignored).
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


def worker() -> None:
    """One turn: the ``repro_torch`` on ``sys.path`` times its COO kernels
    and prints one JSON line."""
    import hashlib

    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core import suite
    from repro_torch.core import transform as T
    from repro_torch.core.autotune import time_device
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

    def times(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        return [time_device(fn) * 1e3 for _ in range(REPS)]

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for batch in BATCHES:
            rng = np.random.default_rng(7 + (batch or 0))
            shape = (csr.n_cols,) if batch is None else (csr.n_cols, batch)
            x = torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).to(dev).to(dtype)
            kern, plain = ((K3.coo_spmv, K3.coo_spmv_plain) if batch is None
                           else (K3.coo_spmm, K3.coo_spmm_plain))
            lib_ms = (statistics.median(times(lambda: lib @ x))
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
                    rel = float(((got - want).abs() / (mag + 1e-30)).max())
                    if rel > KERNEL_REL_TOL:
                        raise AssertionError(f"{layout} B={batch} {dtype} "
                                             f"block_nnz={bn}: rel err {rel}")
                    del got, want, mag
                    cases.append({
                        "kernel": kern.__name__, "layout": layout,
                        "dtype": str(dtype).replace("torch.", ""),
                        "batch": batch, "block_nnz": bn,
                        "max_rel_err": rel, "ms": times(call),
                        "library_ms": lib_ms})
    src = hashlib.sha256(b"".join(
        (build.CSRC / f"{k}.cu").read_bytes()
        for k in ("coo_spmv", "coo_spmm"))).hexdigest()[:12]
    print(json.dumps({"repro_torch": repro_torch.__file__, "sources": src,
                      "device": torch.cuda.get_device_name(0),
                      "cases": cases}), flush=True)


def turn(checkout: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--worker"], env=env, cwd=checkout, check=True,
                         capture_output=True, text=True, timeout=900)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path,
                    help="root of the checkout to compare with")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "coo_ab.json")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker()
        return 0
    if args.other is None:
        ap.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        print("torch_coo_ab: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    order = [("other", args.other.resolve()), ("this", ROOT),
             ("this", ROOT), ("other", args.other.resolve())]
    turns = [(name, turn(path)) for name, path in order]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"nvidia_smi": smi, "order": [
        {"checkout": name, **t} for name, t in turns]}, indent=1))
    print("case,other_ms(turn1/turn4),this_ms(turn2/turn3),"
          "this/other,this_min..max,library_ms")
    for i, case in enumerate(turns[0][1]["cases"]):
        med = [statistics.median(t["cases"][i]["ms"]) for _, t in turns]
        mine = turns[1][1]["cases"][i]["ms"] + turns[2][1]["cases"][i]["ms"]
        key = (f"{case['kernel']}/{case['layout']}/{case['dtype']}/"
               f"B={case['batch']}/bn={case['block_nnz']}")
        print(f"{key},{med[0]:.4f}/{med[3]:.4f},{med[1]:.4f}/{med[2]:.4f},"
              f"{(med[1] + med[2]) / (med[0] + med[3]):.3f},"
              f"{min(mine):.4f}..{max(mine):.4f},{case['library_ms']}")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
