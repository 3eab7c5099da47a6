"""Kernel launches inside the benchmark's ``flush`` ranges over the
flushes (the hybrid's blocks, the reassembly, the guard's probe), a
count that repeats exactly."""


def read(view):
    n = view.counts.get("flushes", 0)
    k = len(view.kernels("flush"))
    return k / n if n and k else None
