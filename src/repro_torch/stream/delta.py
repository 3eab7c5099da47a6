"""Incremental transforms: apply a :class:`DeltaBatch` without re-transforming.

The paper's amortization rule ``k·B·(t_crs−t_f) > t_trans`` prices the
transform as a one-time cost — a mutating matrix pays it on every change
unless the transformed container can absorb the change *incrementally*.
This module is that absorber:

* **CSR** — whole-row appends are O(Δnnz) tail writes into the existing
  ``nnz_pad`` slack (:func:`repro_torch.core.transform.csr_append_rows`);
  value overwrites are O(Δ) in-place stores; nnz inserts/deletes degrade to
  one O(nnz) scatter (:func:`~repro_torch.core.transform.csr_splice`) —
  still far below a format re-transform.
* **SELL** (:class:`~repro_torch.core.formats.BucketedELL`) — value updates
  rewrite only the affected rows; appended or relocated rows rebuild only
  their target bucket; the widest bucket widens when a row outgrows every
  bucket.  All :meth:`BucketedELL.validate` invariants (permutation,
  contiguous tiling, strictly decreasing widths, nnz accounting) are
  preserved.
* **Every other format** falls back to a full re-transform from the
  updated CSR, with the cost recorded (``mode="rebuild"``) so the drift
  layer can price it honestly.

On the card every edit runs there, in torch ops on the container's own
tensors: a delta never copies the matrix between host and card.  What
crosses is the size of the delta — the :class:`DeltaBatch` itself, the
edited rows' lengths (which the drift sketch needs) and where those rows
sit.  A SELL apply makes a fixed number of launches a bucket it touches,
whatever the number of rows changed.  After every apply the new container
gets what the kernels read beside it (``kernels.ops.prepare``: K1's live
extents, K5's choice of kernel), inside ``t_apply_s``.

Safety: the updated CSR is validated after every apply, the
incrementally updated container too (``validate`` runs on the tensors'
own device: one read back of a few flags), and a failed container
(including one poisoned by the ``delta.corrupt`` chaos fault) degrades to
a clean full re-transform — a bad delta apply costs time, never
correctness.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..core.formats import (CSR, ELL, BucketedELL, MatrixValidationError,
                            _np, validate_container)
from ..core.transform import (csr_append_rows, csr_row_bounds,
                              csr_set_values, csr_splice, pad_to_multiple)
from ..serve import faults as _faults

#: version stamp carried by the JSON form (lint + capture traces key on it)
DELTA_SCHEMA_VERSION = 1

#: formats apply_delta can update incrementally; everything else rebuilds
INCREMENTAL_FORMATS = ("csr", "sell")


def _empty_i() -> np.ndarray:
    return np.zeros(0, dtype=np.int64)


def _empty_f() -> np.ndarray:
    return np.zeros(0, dtype=np.float32)


@dataclass(frozen=True)
class DeltaBatch:
    """One batch of structural/value changes to a sparse matrix (host
    numpy arrays; the JSON form is the JAX package's).

    Three change kinds, applied in this order:

    * ``update_*`` — point writes ``A[r, c] = v``: overwrite when the
      entry exists, insert when absent.  Rows must already exist.
    * ``delete_*`` — remove stored entries ``(r, c)``; absent entries are
      ignored (idempotent deletes).
    * ``append_*`` — whole new rows at the tail, as per-row (cols, vals)
      array pairs (the matrix grows by ``len(append_cols)`` rows).

    The column count is fixed: deltas never change ``n_cols``.
    """

    n_cols: int
    append_cols: Tuple[np.ndarray, ...] = ()
    append_vals: Tuple[np.ndarray, ...] = ()
    update_rows: np.ndarray = field(default_factory=_empty_i)
    update_cols: np.ndarray = field(default_factory=_empty_i)
    update_vals: np.ndarray = field(default_factory=_empty_f)
    delete_rows: np.ndarray = field(default_factory=_empty_i)
    delete_cols: np.ndarray = field(default_factory=_empty_i)

    # -- shape ----------------------------------------------------------------
    @property
    def n_appends(self) -> int:
        return len(self.append_cols)

    @property
    def nnz_delta(self) -> int:
        """Upper bound on touched nonzeros (appends + updates + deletes)."""
        app = int(sum(len(c) for c in self.append_cols))
        return app + int(self.update_rows.shape[0]) \
            + int(self.delete_rows.shape[0])

    @property
    def empty(self) -> bool:
        return self.nnz_delta == 0

    def _append_flat(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(lens, flat_cols, flat_vals)`` over the appended rows,
        memoized — the batch is frozen, so the flattening is paid once no
        matter how many times the delta is validated or applied."""
        cached = getattr(self, "_flat_cache", None)
        if cached is None:
            k = len(self.append_cols)
            lens = np.fromiter((len(np.asarray(c)) for c in self.append_cols),
                               count=k, dtype=np.int64)
            if k and int(lens.sum()):
                flat_c = np.concatenate(
                    [np.asarray(c, dtype=np.int64) for c in self.append_cols])
                flat_v = np.concatenate(
                    [np.asarray(v, dtype=np.float32)
                     for v in self.append_vals])
            else:
                flat_c, flat_v = _empty_i(), _empty_f()
            cached = (lens, flat_c, flat_v)
            object.__setattr__(self, "_flat_cache", cached)
        return cached

    # -- validation -----------------------------------------------------------
    def validate(self, n_rows: Optional[int] = None) -> "DeltaBatch":
        """Raise :class:`ValueError` on the first malformed field."""
        if self.n_cols <= 0:
            raise ValueError(f"n_cols must be positive; got {self.n_cols}")
        if len(self.append_cols) != len(self.append_vals):
            raise ValueError(
                f"{len(self.append_cols)} appended col rows vs "
                f"{len(self.append_vals)} value rows")
        if self.append_cols and not getattr(self, "_appends_ok", False):
            k = len(self.append_cols)
            v_lens = np.fromiter((len(np.asarray(v))
                                  for v in self.append_vals),
                                 count=k, dtype=np.int64)
            c_lens, allc, _ = self._append_flat()
            bad = np.nonzero(c_lens != v_lens)[0]
            if bad.size:
                i = int(bad[0])
                raise ValueError(f"appended row {i}: {c_lens[i]} cols vs "
                                 f"{v_lens[i]} vals")
            if allc.size:
                if int(allc.min()) < 0 or int(allc.max()) >= self.n_cols:
                    off = int(np.nonzero((allc < 0)
                                         | (allc >= self.n_cols))[0][0])
                    i = int(np.searchsorted(np.cumsum(c_lens), off,
                                            side="right"))
                    raise ValueError(f"appended row {i}: column out of "
                                     f"[0, {self.n_cols})")
            object.__setattr__(self, "_appends_ok", True)
        for name, rows, cols in (("update", self.update_rows,
                                  self.update_cols),
                                 ("delete", self.delete_rows,
                                  self.delete_cols)):
            rows, cols = np.asarray(rows), np.asarray(cols)
            if rows.shape != cols.shape:
                raise ValueError(f"{name}: rows {rows.shape} vs cols "
                                 f"{cols.shape}")
            if rows.size:
                if int(rows.min()) < 0:
                    raise ValueError(f"{name}: negative row index")
                if n_rows is not None and int(rows.max()) >= n_rows:
                    raise ValueError(f"{name}: row {int(rows.max())} out of "
                                     f"[0, {n_rows}) (appended rows cannot "
                                     f"be edited in the same batch)")
                if int(cols.min()) < 0 or int(cols.max()) >= self.n_cols:
                    raise ValueError(f"{name}: column out of "
                                     f"[0, {self.n_cols})")
        if self.update_rows.shape[0] != np.asarray(self.update_vals).shape[0]:
            raise ValueError(
                f"update: {self.update_rows.shape[0]} positions vs "
                f"{np.asarray(self.update_vals).shape[0]} values")
        return self

    # -- (de)serialization ----------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": "delta_batch",
            "schema_version": DELTA_SCHEMA_VERSION,
            "n_cols": int(self.n_cols),
            "appends": [[np.asarray(c).tolist(), np.asarray(v).tolist()]
                        for c, v in zip(self.append_cols, self.append_vals)],
            "updates": {"rows": np.asarray(self.update_rows).tolist(),
                        "cols": np.asarray(self.update_cols).tolist(),
                        "vals": np.asarray(self.update_vals).tolist()},
            "deletes": {"rows": np.asarray(self.delete_rows).tolist(),
                        "cols": np.asarray(self.delete_cols).tolist()},
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeltaBatch":
        if d.get("kind") != "delta_batch":
            raise ValueError(f"not a delta_batch payload: "
                             f"kind={d.get('kind')!r}")
        if int(d.get("schema_version", -1)) > DELTA_SCHEMA_VERSION:
            raise ValueError(f"delta schema_version "
                             f"{d.get('schema_version')} is newer than "
                             f"supported {DELTA_SCHEMA_VERSION}")
        ups = d.get("updates") or {}
        dels = d.get("deletes") or {}
        return cls(
            n_cols=int(d["n_cols"]),
            append_cols=tuple(np.asarray(p[0], dtype=np.int64)
                              for p in d.get("appends", ())),
            append_vals=tuple(np.asarray(p[1], dtype=np.float32)
                              for p in d.get("appends", ())),
            update_rows=np.asarray(ups.get("rows", ()), dtype=np.int64),
            update_cols=np.asarray(ups.get("cols", ()), dtype=np.int64),
            update_vals=np.asarray(ups.get("vals", ()), dtype=np.float32),
            delete_rows=np.asarray(dels.get("rows", ()), dtype=np.int64),
            delete_cols=np.asarray(dels.get("cols", ()), dtype=np.int64),
        ).validate()


@dataclass
class DeltaApplyResult:
    """What one :func:`apply_delta` did, priced for the drift layer."""

    csr: CSR                       #: the updated source CSR (validated)
    container: Any                 #: the updated ``fmt`` container
    fmt: str
    mode: str                      #: inplace | append | splice | rebuild
    fallback: bool                 #: True when the incremental path bailed
    fallback_reason: str
    t_apply_s: float
    buckets_rebuilt: int           #: SELL buckets touched structurally
    appended_lens: np.ndarray      #: per appended row nnz
    changed_rows: np.ndarray       #: pre-existing rows whose length changed
    old_lens: np.ndarray
    new_lens: np.ndarray


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# CSR apply
# ---------------------------------------------------------------------------
_MODE_RANK = {"noop": 0, "inplace": 1, "append": 2, "splice": 3,
              "rebuild": 4}


def _apply_csr(m: CSR, delta: DeltaBatch, *, in_place: bool = True):
    """Route the delta through the cheapest CSR edit primitives.

    Returns ``(csr, mode, changed_rows, old_lens, new_lens,
    appended_lens)``; ``changed_rows`` are the pre-existing rows touched
    by updates/deletes (unique, sorted)."""
    if m.n_cols != delta.n_cols:
        raise ValueError(f"delta n_cols={delta.n_cols} vs matrix "
                         f"n_cols={m.n_cols}")
    delta.validate(m.n_rows)
    changed = np.unique(np.concatenate(
        [np.asarray(delta.update_rows, dtype=np.int64),
         np.asarray(delta.delete_rows, dtype=np.int64)])) \
        if (delta.update_rows.shape[0] or delta.delete_rows.shape[0]) \
        else _empty_i()
    old_lens = csr_row_bounds(m, changed)[1]

    cur, modes = m, []
    miss = np.zeros(0, dtype=bool)
    if delta.update_rows.shape[0]:
        cur, hit = csr_set_values(cur, delta.update_rows, delta.update_cols,
                                  delta.update_vals, in_place=in_place)
        if hit.any():
            modes.append("inplace")
        miss = ~hit
    if miss.any() or delta.delete_rows.shape[0]:
        cur = csr_splice(cur,
                         np.asarray(delta.update_rows)[miss],
                         np.asarray(delta.update_cols)[miss],
                         np.asarray(delta.update_vals)[miss],
                         delta.delete_rows, delta.delete_cols)
        modes.append("splice")
    appended_lens, flat_c, flat_v = delta._append_flat()
    if delta.n_appends:
        cur = csr_append_rows(cur, flat_c, flat_v, lens=appended_lens,
                              in_place=in_place)
        modes.append("append")
    mode = max(modes, key=_MODE_RANK.__getitem__) if modes else "noop"
    new_lens = csr_row_bounds(cur, changed)[1]
    return cur, mode, changed, old_lens, new_lens, appended_lens


# ---------------------------------------------------------------------------
# SELL apply
# ---------------------------------------------------------------------------
def _fill_rows(d: torch.Tensor, c: torch.Tensor, at: torch.Tensor,
               rows: np.ndarray, lens: np.ndarray, src: CSR) -> None:
    """Rows ``at`` of the panel ``(d, c)`` become source rows ``rows``
    (``lens`` stored entries each, the rest ``(0, col 0)`` pads): a fixed
    number of launches however many rows."""
    dev = d.device
    d[at] = 0
    c[at] = 0
    total = int(lens.sum())
    if not total:
        return
    lens_t = torch.as_tensor(lens, device=dev)
    q = torch.repeat_interleave(torch.arange(len(lens), device=dev), lens_t,
                                output_size=total)
    k = torch.arange(total, device=dev) \
        - torch.as_tensor(np.cumsum(lens) - lens, device=dev)[q]
    start = src.indptr.long()[torch.as_tensor(rows, device=dev)]
    s = start[q] + k
    d[at[q], k] = src.data[s]
    c[at[q], k] = src.cols[s]


def sell_apply(sell: BucketedELL, new_csr: CSR, n_old: int,
               changed_rows: np.ndarray, old_lens: np.ndarray,
               new_lens: np.ndarray, appended_lens: np.ndarray, *,
               copy: bool = False, width_quantum: int = 8):
    """Incrementally carry a SELL container to the post-delta matrix.

    ``new_csr`` is the already-updated source, on the container's device;
    only the affected rows / buckets are rebuilt, in torch ops there, with
    a fixed number of launches a bucket touched.  Returns ``(container,
    buckets_rebuilt)``; raises :class:`MatrixValidationError` when the
    container cannot absorb the change (caller rebuilds from scratch).
    ``copy`` leaves ``sell``'s tensors untouched (every bucket cloned)."""
    if not sell.buckets:
        raise MatrixValidationError("SELL container has no buckets")
    nb = len(sell.buckets)
    offsets = list(sell.row_offsets)
    dev = sell.perm.device
    perm = sell.perm
    counts = [int(b.n_rows) for b in sell.buckets]
    b_rows: List[torch.Tensor] = [perm[offsets[j]: offsets[j] + counts[j]]
                                  for j in range(nb)]
    b_data: List[Optional[torch.Tensor]] = [None] * nb
    b_cols: List[Optional[torch.Tensor]] = [None] * nb
    b_nnz: List[int] = [int(b.nnz) for b in sell.buckets]
    widths: List[int] = [int(b.width) for b in sell.buckets]
    rebuilt = 0

    def arrays(j: int):
        if b_data[j] is None:
            d, c = sell.buckets[j].data, sell.buckets[j].cols
            if copy:
                d, c = d.clone(), c.clone()
            b_data[j], b_cols[j] = d, c
        return b_data[j], b_cols[j]

    # where each changed row sits under the *original* structure: one
    # inverse of perm on the device, read back for the changed rows only
    changed = np.asarray(changed_rows, dtype=np.int64)
    old_lens = np.asarray(old_lens, dtype=np.int64)
    new_lens = np.asarray(new_lens, dtype=np.int64)
    removals: Dict[int, np.ndarray] = {}
    moved = np.zeros(changed.shape[0], dtype=bool)
    if changed.size:
        inv = torch.empty(n_old, dtype=torch.int64, device=dev)
        inv[perm.long()] = torch.arange(n_old, device=dev)
        p = inv[torch.as_tensor(changed, device=dev)].cpu().numpy()
        bounds = np.asarray(offsets + [n_old], dtype=np.int64)
        bucket = np.searchsorted(bounds, p, side="right") - 1
        local = p - bounds[bucket]
        fits = new_lens <= np.asarray(widths)[bucket]
        for j in np.unique(bucket):
            mine = bucket == j
            here = mine & fits
            if here.any():
                # value/shrink rewrite in place: only these rows change
                d, c = arrays(j)
                _fill_rows(d, c, torch.as_tensor(local[here], device=dev),
                           changed[here], new_lens[here], new_csr)
                b_nnz[j] += int(new_lens[here].sum() - old_lens[here].sum())
            gone = mine & ~fits
            if gone.any():
                removals[int(j)] = local[gone]
                b_nnz[j] -= int(old_lens[gone].sum())
        moved = ~fits
    # rows that outgrew their bucket, in row order, then the appended rows
    app = np.asarray(appended_lens, dtype=np.int64)
    ins_r = np.concatenate([changed[moved], n_old + np.arange(
        app.shape[0], dtype=np.int64)])
    ins_ln = np.concatenate([new_lens[moved], app])

    for j, locals_ in removals.items():
        # the rows that stay, in order: the i-th kept row is row i plus the
        # removed rows at or before it (two launches, no read back)
        d, c = arrays(j)
        gone = np.sort(locals_)
        n_keep = counts[j] - gone.shape[0]
        rank = torch.arange(n_keep, device=dev)
        adj = torch.as_tensor(gone - np.arange(gone.shape[0]), device=dev)
        keep = rank + torch.searchsorted(adj, rank, right=True)
        b_data[j], b_cols[j] = d.index_select(0, keep), c.index_select(0,
                                                                       keep)
        b_rows[j] = b_rows[j].index_select(0, keep)
        counts[j] = n_keep
        rebuilt += 1

    if ins_r.size:
        longest = int(ins_ln.max())
        if longest > widths[0]:
            # widen the widest bucket (stays strictly the widest)
            new_w = pad_to_multiple(max(longest, 1), width_quantum)
            d, c = arrays(0)
            nd = d.new_zeros((d.shape[0], new_w))
            nc = c.new_zeros((c.shape[0], new_w))
            nd[:, : d.shape[1]] = d
            nc[:, : c.shape[1]] = c
            b_data[0], b_cols[0] = nd, nc
            widths[0] = new_w
            rebuilt += 1
        # narrowest bucket that still fits each row (widths decrease)
        fit = (np.asarray(widths)[None, :]
               >= np.maximum(ins_ln, 1)[:, None]).sum(axis=1)
        target = np.maximum(fit - 1, 0)
        for j in dict.fromkeys(target.tolist()):
            mine = target == j
            d, c = arrays(j)
            k = int(mine.sum())
            add_d = d.new_zeros((k, widths[j]))
            add_c = c.new_zeros((k, widths[j]))
            _fill_rows(add_d, add_c, torch.arange(k, device=dev),
                       ins_r[mine], ins_ln[mine], new_csr)
            b_data[j] = torch.cat([d, add_d])
            b_cols[j] = torch.cat([c, add_c])
            b_rows[j] = torch.cat([b_rows[j], torch.as_tensor(
                ins_r[mine], device=dev).to(perm.dtype)])
            counts[j] += k
            b_nnz[j] += int(ins_ln[mine].sum())
            rebuilt += 1

    keep_idx = [j for j in range(nb) if counts[j]]
    if not keep_idx:
        raise MatrixValidationError("delta emptied every SELL bucket")
    n_new = new_csr.n_rows
    new_perm = torch.cat([b_rows[j] for j in keep_idx]).to(torch.int32)
    new_offsets, buckets, off = [], [], 0
    for j in keep_idx:
        if b_data[j] is None and not copy:
            buckets.append(sell.buckets[j])   # untouched: the same panel
        else:
            d, c = arrays(j)
            buckets.append(ELL(data=d, cols=c,
                               shape=(d.shape[0], new_csr.n_cols),
                               nnz=b_nnz[j], order="row"))
        new_offsets.append(off)
        off += counts[j]
    if off != n_new:
        raise MatrixValidationError(
            f"incremental SELL covers {off} rows, expected {n_new}")
    return BucketedELL(perm=new_perm, buckets=tuple(buckets),
                       row_offsets=tuple(new_offsets),
                       shape=new_csr.shape, nnz=new_csr.nnz), rebuilt


# ---------------------------------------------------------------------------
# the orchestrator
# ---------------------------------------------------------------------------
def _copy_csr(m: CSR) -> CSR:
    return CSR(data=m.data.clone(), cols=m.cols.clone(),
               indptr=m.indptr.clone(), shape=m.shape, nnz=m.nnz)


def _poison(container: Any) -> None:
    """The ``delta.corrupt`` fault's effect: break a structural invariant
    so the container check must catch it (tensors, in place — containers
    are frozen dataclasses, their tensors are not)."""
    if isinstance(container, CSR):
        container.indptr[-1] += 1
    elif isinstance(container, BucketedELL):
        container.perm[0] = container.n_rows
    else:  # generic: any container with an integer index array
        for name in ("cols", "rows", "block_cols"):
            arr = getattr(container, name, None)
            if arr is not None and arr.numel():
                arr[(0,) * arr.ndim] = -10**6
                break


def apply_delta(csr: CSR, delta: DeltaBatch, *, container: Any = None,
                fmt: str = "csr", transform_params: Optional[dict] = None,
                registry: Optional[_faults.FaultRegistry] = None,
                key: str = "", validate: bool = True) -> DeltaApplyResult:
    """Apply one delta to a source CSR and (optionally) its transformed
    container, on their device.

    ``fmt``/``container`` name the bound serving format: ``csr`` and
    ``sell`` are updated incrementally, anything else is rebuilt from the
    updated CSR through ``core.plan.apply_transform`` (the host recipe,
    then moved to the CSR's device; ``mode="rebuild"``, cost recorded).
    When the ``delta.corrupt`` fault is armed the apply runs copy-on-write
    so a poisoned candidate can be thrown away and rebuilt cleanly.  The
    new container is prepared for the kernels (``kernels.ops.prepare``)
    and the card synchronized before ``t_apply_s`` is read."""
    from ..kernels.ops import prepare
    reg = registry if registry is not None else _faults.get()
    armed = bool(reg.armed("delta.corrupt"))
    dev = csr.device
    t0 = time.perf_counter()
    new_csr, mode, changed, old_lens, new_lens, app_lens = _apply_csr(
        csr, delta, in_place=not armed)
    if validate:
        validate_container(new_csr)

    fallback, reason, rebuilt = False, "", 0
    params = dict(transform_params or {})
    cand: Any
    if fmt == "csr":
        cand = _copy_csr(new_csr) if armed else new_csr
    elif fmt == "sell" and isinstance(container, BucketedELL):
        try:
            cand, rebuilt = sell_apply(
                container, new_csr, csr.n_rows, changed, old_lens, new_lens,
                app_lens, copy=armed,
                width_quantum=int(params.get("width_quantum", 8)))
        except (MatrixValidationError, ValueError, IndexError) as e:
            cand, fallback, reason = None, True, f"sell:{type(e).__name__}"
    else:
        cand, fallback, reason = None, True, "format"

    if cand is not None and reg.should_fire("delta.corrupt"):
        _poison(cand)
    if cand is not None and validate:
        try:
            validate_container(cand)
        except MatrixValidationError:
            cand, fallback, reason = None, True, "corrupt"

    if cand is None:
        # degrade: full re-transform from the clean, already-updated CSR
        from ..core.plan import apply_transform
        cand = apply_transform(fmt, new_csr, **params)
        mode = "rebuild"
        if validate:
            validate_container(cand)
        cand = cand.to(dev)
    prepare(cand)
    _sync(dev)
    dt = time.perf_counter() - t0

    tel = _obs.get()
    if tel.enabled:
        tel.counter("stream.applies", fmt=fmt, mode=mode).inc()
        if fallback:
            tel.counter("stream.fallbacks", fmt=fmt, reason=reason).inc()
        tel.histogram("stream.apply_s", fmt=fmt).observe(dt)
        tel.event("stream.delta", key=key, fmt=fmt, mode=mode,
                  rows=int(changed.shape[0]), appends=delta.n_appends,
                  nnz_delta=delta.nnz_delta, fallback=fallback,
                  reason=reason, t_apply_s=dt)
    return DeltaApplyResult(csr=new_csr, container=cand, fmt=fmt, mode=mode,
                            fallback=fallback, fallback_reason=reason,
                            t_apply_s=dt, buckets_rebuilt=rebuilt,
                            appended_lens=app_lens, changed_rows=changed,
                            old_lens=old_lens, new_lens=new_lens)


def random_delta(rng: np.random.Generator, csr: CSR, *,
                 n_appends: int = 0, n_updates: int = 0, n_deletes: int = 0,
                 row_len: int = 8) -> DeltaBatch:
    """A randomized delta for tests/benchmarks: appends draw fresh rows of
    ~``row_len`` nonzeros; updates/deletes target uniformly random
    coordinates (updates mix overwrites and inserts organically).  The
    same draws as the JAX package's from the same generator and matrix
    (it reads ``indptr`` and ``cols`` through a host copy)."""
    n_rows, n_cols = csr.shape
    app_c, app_v = [], []
    for _ in range(n_appends):
        ln = max(1, min(n_cols, int(rng.integers(1, 2 * row_len + 1))))
        app_c.append(np.sort(rng.choice(n_cols, size=ln,
                                        replace=False)).astype(np.int64))
        app_v.append(rng.standard_normal(ln).astype(np.float32))
    upd_r = rng.integers(0, max(n_rows, 1),
                         size=n_updates).astype(np.int64)
    upd_c = rng.integers(0, n_cols, size=n_updates).astype(np.int64)
    upd_v = rng.standard_normal(n_updates).astype(np.float32)
    # steer half the deletes at stored entries so they actually bite
    del_r, del_c = [], []
    if n_deletes:
        ip = _np(csr.indptr)
        cols = _np(csr.cols)
    for i in range(n_deletes):
        if i % 2 == 0 and csr.nnz:
            k = int(rng.integers(0, csr.nnz))
            r = int(np.searchsorted(ip, k, side="right")) - 1
            del_r.append(r)
            del_c.append(int(cols[k]))
        else:
            del_r.append(int(rng.integers(0, max(n_rows, 1))))
            del_c.append(int(rng.integers(0, n_cols)))
    return DeltaBatch(
        n_cols=n_cols, append_cols=tuple(app_c), append_vals=tuple(app_v),
        update_rows=upd_r, update_cols=upd_c, update_vals=upd_v,
        delete_rows=np.asarray(del_r, dtype=np.int64),
        delete_cols=np.asarray(del_c, dtype=np.int64))


__all__ = ["DELTA_SCHEMA_VERSION", "INCREMENTAL_FORMATS", "DeltaBatch",
           "DeltaApplyResult", "apply_delta", "sell_apply", "random_delta"]
