#!/usr/bin/env python3
"""Time the collectives of a ``gloo`` world whose tensors live on a card.

    python3 experiments/torch_gloo_staging.py [--ranks 2] [--mb 400 ...]

Starts a world of ``--ranks`` local ranks over ``gloo`` (all on the
machine's cards, ``cuda:{rank % device_count()}``, as ``chip_smoke.py``'s
``serve_shard_map`` world is) and times, for each size, each way of moving
a float32 CUDA tensor through ``gloo`` — which takes CPU tensors only for
all-gather, reduce-scatter and send/recv:

  * the copy to the host (pageable, and into pinned memory) and back;
  * ``all_gather`` into host tensors, and the same gather as one
    ``all_reduce`` of a zero-filled buffer of the gathered size;
  * ``all_reduce`` and ``reduce_scatter`` of a host copy;
  * ``repro_torch.sharding.collectives``' ``all_gather`` and
    ``all_reduce_`` as the port calls them, card to card.

Each time is the median of ``--reps`` calls (host clock around a call
that ends on the host or in a synchronize), rank 0's; one JSON line a
size, with the bytes each rank sends and the card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def timed(fn, reps):
    out = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return statistics.median(out[1:]) * 1e3


def rank_main(rank, sizes_mb, reps):
    from repro_torch.sharding import collectives as C
    n_ranks = dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = []
    for mb in sizes_mb:
        n = mb * (1 << 20) // 4
        t = torch.ones(n, device=dev)
        pinned = torch.empty(n, pin_memory=True)
        host = torch.empty(n)
        outs = [torch.empty(n) for _ in range(n_ranks)]
        slots = torch.zeros(n_ranks * n)
        chunks = torch.ones(n_ranks * n)
        part = torch.empty(n)
        ms = {
            "d2h_pageable": timed(lambda: host.copy_(t), reps),
            "d2h_pinned": timed(lambda: pinned.copy_(t), reps),
            "h2d_pinned": timed(lambda: t.copy_(pinned), reps),
            "all_gather_host": timed(
                lambda: dist.all_gather(outs, host), reps),
            "all_reduce_gather_host": timed(
                lambda: dist.all_reduce(slots), reps),
            "all_reduce_host": timed(lambda: dist.all_reduce(host), reps),
            "reduce_scatter_host": timed(
                lambda: dist.reduce_scatter(part, list(
                    chunks.chunk(n_ranks))), reps),
            "port_all_gather": timed(lambda: C.all_gather(t), reps),
            "port_all_reduce": timed(lambda: C.all_reduce_(t), reps),
        }
        rows.append({"mb": mb, "ranks": n_ranks, "ms": ms})
        del t, pinned, host, outs, slots, chunks, part
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--mb", type=int, nargs="+", default=[40, 400])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gloo_staging: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch.mesh import spawn
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    rows = spawn(rank_main, args.ranks, (args.mb, args.reps), wall_s=600)
    for row in rows[0]:
        print(json.dumps({**row, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
