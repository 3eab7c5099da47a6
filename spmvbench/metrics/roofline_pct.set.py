"""The products' share of the bandwidth bound, in percent: each product's
CRS-form bytes (``spmvbench/roofline.py``, the same whatever format
serves it) over 3.35 TB/s, summed over the products of the traced window,
over the device time of every kernel launched inside the benchmark's
``spmv`` ranges."""
from spmvbench.roofline import share_pct


def read(view):
    n = view.counts.get("products", 0)
    dev = view.device_s("spmv")
    if not n or dev <= 0:
        return None
    return share_pct(view.info["product_bytes"] * n, dev)
