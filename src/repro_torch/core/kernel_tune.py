"""Kernel launch-geometry records: the data half of launch-geometry tuning.

  * :class:`TileGeometry` — the knobs every kernel wrapper in
    ``kernels/ops.py`` accepts per call (``tuning=``).  The fields are
    exactly the JAX package's, because plan and TuningDB JSON interchange
    both ways and that package's loader rejects unknown fields.  The CUDA
    wrappers read ``block_rows`` (rows per CUDA block) and ``block_nnz``
    (entries per CUDA block); the others ride along for the schema.
  * :class:`GeometryRecord` / :func:`nearest_geometry` — recorded winners
    and the D_mat-keyed nearest-neighbour lookup the planner uses.

The search itself (candidate grids and the timing ``KernelTuner``) is not
ported yet; ``Planner(tuner=...)`` is duck-typed on ``.tune(...)`` and
``.records``.
"""
from __future__ import annotations

import zlib
from dataclasses import asdict, dataclass, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from .formats import _np

__all__ = ["TileGeometry", "GeometryRecord", "nearest_geometry"]


# ---------------------------------------------------------------------------
# the geometry record-of-knobs
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TileGeometry:
    """Per-call launch geometry; ``None`` fields fall back to the wrapper's
    built-in default.  Hashable.

    ``block_rows`` is the *segmented-axis* tile: rows per block for ELL/CSR.

    ``buckets`` is the SELL per-bucket table: ``((width, TileGeometry),
    ...)`` pairs keyed by bucket *width*, so one persisted geometry carries
    a different launch for every bucket of the container.  Bucket widths
    absent from the table fall back to the top-level knobs."""
    block_rows: Optional[int] = None   # ELL/CSR rows per block
    block_w: Optional[int] = None      # ELL band tile (schema only)
    block_k: Optional[int] = None      # SpMM right-hand-side tile (schema only)
    block_nnz: Optional[int] = None    # COO entries per block
    slabs_per_block: Optional[int] = None  # CSR static coverage bound (schema only)
    buckets: Optional[Tuple[Tuple[int, "TileGeometry"], ...]] = None  # SELL

    _KNOBS = ("block_rows", "block_w", "block_k", "block_nnz",
              "slabs_per_block")

    def to_dict(self) -> Dict[str, Any]:
        d = {k: getattr(self, k) for k in self._KNOBS
             if getattr(self, k) is not None}
        if self.buckets is not None:
            d["buckets"] = [[w, g.to_dict()] for w, g in self.buckets]
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TileGeometry":
        d = dict(d)
        buckets = d.pop("buckets", None)
        g = TileGeometry(**d)
        if buckets is not None:
            g = replace(g, buckets=tuple(
                (int(w), TileGeometry.from_dict(gd)) for w, gd in buckets))
        return g

    def broadcast(self) -> "TileGeometry":
        """The top-level knobs alone (per-bucket table stripped) — what a
        bucket whose width is missing from the table launches with."""
        return replace(self, buckets=None)

    def without_slab_bound(self) -> "TileGeometry":
        """Strip the matrix-specific coverage bound (through the per-bucket
        table too) — done whenever a geometry learned on one matrix is
        applied to another."""
        buckets = self.buckets
        if buckets is not None:
            buckets = tuple((w, g.without_slab_bound()) for w, g in buckets)
        return replace(self, slabs_per_block=None, buckets=buckets)


@dataclass
class GeometryRecord:
    """One tuning outcome: the winning geometry for (format, op, batch) on
    a matrix profile, plus the measured win over the default launch.

    ``sig`` fingerprints the index structure (CRC of the pointer array).
    ``bucket_w`` marks a SELL per-bucket component record; ``None`` is a
    whole-matrix record, and only those feed the nearest-neighbour lookup."""
    fmt: str
    op: str
    batch: int
    n: int
    nnz: int
    d_mat: float
    geometry: TileGeometry
    t_best: float
    t_default: float
    sig: int = 0
    bucket_w: Optional[int] = None

    @property
    def speedup(self) -> float:
        return self.t_default / self.t_best if self.t_best > 0 else 1.0

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["geometry"] = self.geometry.to_dict()
        if self.bucket_w is None:
            d.pop("bucket_w")
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "GeometryRecord":
        d = dict(d)
        d["geometry"] = TileGeometry.from_dict(d["geometry"])
        return GeometryRecord(**d)


def _align8(n: int) -> int:
    return max(8, 8 * ((int(n) + 7) // 8))


# ---------------------------------------------------------------------------
# nearest-neighbour lookup over recorded geometries
# ---------------------------------------------------------------------------
def nearest_geometry(records: Sequence[GeometryRecord], fmt: str,
                     op: str = "spmv", d_mat: float = 0.0,
                     batch: Optional[int] = None) -> Optional[TileGeometry]:
    """D_mat-keyed (log-space) nearest neighbour among recorded winners.

    The returned geometry is stripped of its slab-coverage bound — that
    bound is only valid for the matrix it was measured on.  SELL
    per-bucket component records (``bucket_w`` set) are skipped: the
    whole-matrix aggregate already carries the composed bucket table."""
    recs = [r for r in records if r.fmt == fmt and r.op == op
            and getattr(r, "bucket_w", None) is None]
    if batch is not None:
        exact = [r for r in recs if r.batch == batch]
        recs = exact or recs
    if not recs:
        return None
    q = np.log(max(d_mat, 1e-9))
    best = min(recs, key=lambda r: abs(np.log(max(r.d_mat, 1e-9)) - q))
    return best.geometry.without_slab_bound()


def _structure_sig(obj: Any) -> int:
    """CRC fingerprint of the index-pointer structure (0 when the object has
    none).  Computed over the int32 pointer bytes on the host, so it equals
    the JAX package's fingerprint of the same matrix."""
    ip = getattr(obj, "indptr", None)
    if ip is None:
        return 0
    return zlib.crc32(np.ascontiguousarray(_np(ip)).tobytes()) or 1
