"""The flushes' share of the bandwidth bound, in percent: a panel's
CRS-form bytes (the matrix once, ``max_batch`` vectors in and out;
``spmvbench/roofline.py``) over 3.35 TB/s, summed over the flushes of
the traced window, over the device time of every kernel launched inside
the benchmark's ``flush`` ranges (the flushing ``submit`` through its
synchronize)."""
from spmvbench.roofline import share_pct


def read(view):
    n = view.counts.get("flushes", 0)
    dev = view.device_s("flush")
    if not n or dev <= 0:
        return None
    return share_pct(view.info["panel_bytes"] * n, dev)
