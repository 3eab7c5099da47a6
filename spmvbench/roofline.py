"""The yardstick of every roofline share: the bytes a product needs, counted
from the CRS form of the matrix whatever format or kernel serves it, over
the card's published bandwidth.

A product ``Y = A @ X`` with ``rhs`` right-hand sides reads each value and
column index once (4 + 4 bytes an entry), the row pointer once, ``X``
once and writes ``Y`` once (4 bytes an element).  A format that pads,
sorts or splits the matrix moves more bytes than this for the same work;
that is its cost, not a larger yardstick."""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s
PEAK_BYTES_PER_S = 3.35e12


def crs_bytes(n_rows: int, n_cols: int, nnz: int, rhs: int = 1) -> int:
    """Bytes of ``A @ X`` in CRS form for an ``n_rows x n_cols`` matrix of
    ``nnz`` entries and ``rhs`` right-hand sides."""
    return (nnz * (4 + 4) + (n_rows + 1) * 4
            + rhs * (n_cols + n_rows) * 4)


def form_bytes(m, rhs: int = 1) -> int:
    """:func:`crs_bytes` of any matrix that states its ``shape`` and true
    ``nnz`` (the benchmark's CSR, or any container of the port), so every
    form of one matrix counts the same."""
    n_rows, n_cols = m.shape
    return crs_bytes(int(n_rows), int(n_cols), int(m.nnz), rhs)


def share_pct(bytes_moved: float, device_s: float):
    """The share of the bandwidth bound, in percent: the least time the
    bytes need over the device time taken; ``None`` without a time."""
    if device_s <= 0:
        return None
    return 100.0 * bytes_moved / PEAK_BYTES_PER_S / device_s
