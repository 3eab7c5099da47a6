"""GAP's ``kron`` graph (Beamer, Asanovic, Patterson, The GAP Benchmark
Suite, arXiv:1508.03619): the Graph500 Kronecker (R-MAT) generator with
A = 0.57, B = C = 0.19, ``edge_factor`` edges a vertex, vertex ids
permuted, made undirected, self-loops and duplicate edges dropped, as
GAP's generator and builder do.

Stored as PageRank's transition matrix: entry (i, j) of an edge is
``1 / deg(j)``, so ``A @ r`` is GAP's sum of incoming contributions.  The
graph is drawn from the configuration's ``graph_seed`` (GAP's generator
also runs from a fixed seed): it is the deployment's data, the same in
every run.  Generated, sorted and deduplicated on the card."""
from __future__ import annotations

import torch

from ..matrix import from_coordinates, generator


def build(cfg, seed, device):
    scale, ef = int(cfg["scale"]), int(cfg["edge_factor"])
    a, b, c = float(cfg["A"]), float(cfg["B"]), float(cfg["C"])
    n, m = 1 << scale, int(cfg["edge_factor"]) << scale
    g = generator(int(cfg["graph_seed"]), device, scale, ef)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for _ in range(scale):
        u = torch.rand(m, generator=g, device=device)
        src.mul_(2).add_((u >= a + b).long())
        dst.mul_(2).add_((((u > a) & (u < a + b)) | (u > a + b + c)).long())
        del u
    perm = torch.randperm(n, generator=g, device=device)
    src, dst = perm[src], perm[dst]
    del perm
    s, d = torch.cat([src, dst]), torch.cat([dst, src])
    del src, dst
    keep = s != d
    key = torch.unique(s[keep] * n + d[keep])     # sorted by (row, column)
    del s, d, keep
    rows, cols = key // n, key % n
    del key
    deg = torch.bincount(rows, minlength=n)
    vals = 1.0 / deg[cols].to(torch.float64)
    return from_coordinates(rows, cols, vals, n, n)
