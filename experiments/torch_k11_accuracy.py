#!/usr/bin/env python3
"""K11 ``decode_attention_int8`` against its plain version and a float64
oracle, in this checkout and in another (for example the parent, unpacked
with ``git archive``), on one CUDA card.

The cases are those of ``tests/test_torch_cuda.py::
test_cuda_decode_attention_int8_every_head_and_group``: B 2, S 300, KV 2,
inputs from ``numpy.random.default_rng(99)`` as its ``k11_inputs`` draws
them, q scaled by 4, at every head width and group it takes, without and
with a logit softcap of 2, float32 and bfloat16 q.  Each checkout runs in a
process of its own, its ``repro_torch`` from its ``src/``; the plain version
runs on the CPU, as in the test.  The oracle is the same attention in
float64 from the dequantized cache.  For each case and checkout the script
prints the largest error of the kernel and of the plain version against the
oracle, and each output element that breaks the test's rule for bfloat16 q
(one bfloat16 ulp of the larger of the two values, plus 1e-6): the
kernel's value, the plain version's, the oracle's, the error and the limit.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_k11_accuracy.py --other DIR [--out FILE]

It writes every reading to ``--out`` (default ``build/k11_accuracy.json``,
git-ignored).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HEADS = (16, 64, 80, 128, 256, 512)
GROUPS = (1, 2, 3, 5, 6)
SOFTCAPS = (0.0, 2.0)


def k11_inputs(rng, B, S, KV, G, Dh, q_dtype):
    """The test's inputs: int8 codes and bfloat16 scales, each sequence
    filled to a random length in [S/2, S)."""
    import numpy as np
    import torch

    from repro_torch.models.attention import _quantize_kv
    k_q, k_s = _quantize_kv(torch.from_numpy(
        rng.normal(size=(B, S, KV, Dh)).astype(np.float32)))
    v_q, v_s = _quantize_kv(torch.from_numpy(
        rng.normal(size=(B, S, KV, Dh)).astype(np.float32)))
    q = torch.from_numpy(rng.normal(size=(B, KV, G, Dh)).astype(
        np.float32)).to(getattr(torch, q_dtype))
    lens = rng.integers(S // 2, S, size=B)
    key_pos = torch.from_numpy(np.where(
        np.arange(S)[None, :] < lens[:, None], np.arange(S)[None, :],
        -1).astype(np.int32))
    q_pos = torch.from_numpy((lens - 1).astype(np.int32))
    return [q, k_q, k_s, v_q, v_s, key_pos, q_pos]


def oracle(args, softcap):
    """The masked (capped) softmax attention in float64."""
    import numpy as np
    q, k_q, k_s, v_q, v_s, key_pos, q_pos = [a.cpu() for a in args]
    k = k_q.double().numpy() * k_s.double().numpy()[..., None]
    v = v_q.double().numpy() * v_s.double().numpy()[..., None]
    qd = q.double().numpy()
    s = np.einsum("bkgd,bskd->bkgs", qd, k) / np.sqrt(qd.shape[-1])
    if softcap > 0:
        s = softcap * np.tanh(s / softcap)
    kp, qp = key_pos.numpy(), q_pos.numpy()
    valid = (kp >= 0) & (kp <= qp[:, None])
    s = np.where(valid[:, None, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bkgs,bskd->bkgd", p, v)


def worker() -> None:
    """One checkout: every case, one JSON line."""
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.kernels import decode_attention as K11

    dev = torch.device("cuda")
    cases = []
    for softcap in SOFTCAPS:
        for G in GROUPS:
            for Dh in HEADS:
                for q_dtype in ("float32", "bfloat16"):
                    args = k11_inputs(np.random.default_rng(99), 2, 300, 2,
                                      G, Dh, q_dtype)
                    args[0] = args[0] * 4
                    got = K11.decode_attention_int8(
                        *[a.to(dev) for a in args], softcap=softcap)
                    want = K11.decode_attention_int8_plain(*args,
                                                           softcap=softcap)
                    torch.cuda.synchronize()
                    got = got.float().cpu().numpy().astype(np.float64)
                    want = want.float().numpy().astype(np.float64)
                    ref = oracle(args, softcap)
                    ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                        np.maximum(np.abs(got), np.abs(want)),
                        np.finfo(np.float32).tiny))) - 7)
                    limit = ulp + 1e-6
                    err = np.abs(got - want)
                    bad = np.argwhere(err > limit) if q_dtype == "bfloat16" \
                        else np.zeros((0, 4), np.int64)
                    cases.append({
                        "Dh": Dh, "G": G, "softcap": softcap,
                        "q_dtype": q_dtype,
                        "kernel_vs_oracle": float(np.abs(got - ref).max()),
                        "plain_vs_oracle": float(np.abs(want - ref).max()),
                        "kernel_vs_plain": float(err.max()),
                        "breaks_bf16_rule": [
                            {"at": [int(i) for i in ix],
                             "kernel": float(got[tuple(ix)]),
                             "plain": float(want[tuple(ix)]),
                             "oracle": float(ref[tuple(ix)]),
                             "error": float(err[tuple(ix)]),
                             "limit": float(limit[tuple(ix)])}
                            for ix in bad]})
    print(json.dumps({"repro_torch": repro_torch.__file__,
                      "cases": cases}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path,
                    help="root of the checkout to compare with")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "k11_accuracy.json")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker()
        return 0
    if args.other is None:
        ap.error("--other is required")
    import torch
    if not torch.cuda.is_available():
        print("torch_k11_accuracy: no CUDA device available",
              file=sys.stderr)
        return 1
    runs = {}
    for name, path in (("other", args.other.resolve()), ("this", ROOT)):
        env = dict(os.environ, PYTHONPATH=str(path / "src"))
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--worker"], env=env, cwd=path,
                             capture_output=True, text=True, timeout=900)
        if out.returncode:
            raise RuntimeError(f"{path} failed:\n{out.stderr[-4000:]}")
        runs[name] = json.loads(out.stdout.strip().splitlines()[-1])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"nvidia_smi": smi, **runs}, indent=1))
    print("checkout,Dh,G,softcap,q,kernel_vs_oracle,plain_vs_oracle,"
          "kernel_vs_plain,elements_breaking_the_bf16_rule")
    for name, run in runs.items():
        for c in run["cases"]:
            print(f"{name},{c['Dh']},{c['G']},{c['softcap']},{c['q_dtype']},"
                  f"{c['kernel_vs_oracle']:.3e},{c['plain_vs_oracle']:.3e},"
                  f"{c['kernel_vs_plain']:.3e},{len(c['breaks_bf16_rule'])}")
            for b in c["breaks_bf16_rule"]:
                print(f"  {name} at {b['at']}: kernel {b['kernel']!r} plain "
                      f"{b['plain']!r} oracle {b['oracle']!r} error "
                      f"{b['error']!r} limit {b['limit']!r}")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
