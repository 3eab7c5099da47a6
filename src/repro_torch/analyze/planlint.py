"""Static lint for ExecutionPlan / ShardedPlan JSON artifacts (RPL0xx).

``ExecutionPlan.from_dict`` checks the schema version and field *presence*
— by design it stays permissive about values, because a plan that parses
is still just a suggestion until ``bind`` meets a concrete matrix.  But a
fleet replaying :class:`~repro_torch.core.plan_store.PlanStore` artifacts
wants infeasible geometry rejected *before* any launch: a geometry no
launch can take, or an under-provisioned slab bound, is knowable from the
JSON alone.

This module lints the raw payload dict — **no torch import, no bind, no
repro_torch.core import** — so the same checks run in the framework-free
CLI (``python -m repro_torch.analyze lint-plan``), inside ``PlanStore``
loads (errors quarantine with reason ``"lint"``), at
``SpMVService.register(strict_lint=)``, and as the ``Planner``'s
self-check on every plan it mints.  The plan schema is the JAX package's,
so RPL001, RPL003 and RPL005–RPL010 are that package's rules unchanged.

Two rules describe the launch, and the launch here is a CUDA launch on a
Hopper card whose shape ``repro_torch.launch_shapes`` chooses from the
knobs:

  RPL002  an ERROR is exactly a geometry the launch helpers reject: an
          unknown knob, a value that is not a positive integer, or a
          right-hand-side tile that needs more than ``MAX_GRID_Y`` blocks
          along ``grid.y`` at the plan's batch (``check_grid_y``).  A value
          the helpers clamp is a WARN: ``block_k`` above ``MAX_BLOCK_K``,
          ``block_rows`` whose row groups exceed ``MAX_THREADS`` threads at
          the fewest lanes the format's launch gives a row.  There is no
          8-alignment rule: a CUDA block takes any whole number of rows,
          and the tuner's grid holds tiles of 1, 2 and 4 rows.
  RPL004  the knob-driven shared memory of one CUDA block (COO SpMV's
          staged pass, K5's X window share, K10's slice ring, K7's y
          windows) against ``SMEM_BLOCK_MAX``, the dynamic shared memory a
          block may take on an H100; threads per block are reported beside
          it.  A budget below the card's (``smem_budget=``) models a
          smaller part.

Both rules call the launch helpers themselves (``repro_torch.launch_shapes``,
which ``kernels/_common.py`` re-exports and which imports nothing), so this
module stays importable without torch and lints the launch a wrapper makes.

Rule catalog:

  RPL001  schema shape: required/unknown fields, types, schema_version
  RPL002  TileGeometry: unknown knobs, positivity, launch limits (above)
  RPL003  slab-coverage bound vs the static lower bound implied by the
          recorded fingerprint (CSR/BCSR; CCS has no column count to
          bound against)
  RPL004  per-(format, op) knob-driven shared memory vs budget (above)
  RPL005  SELL bucket table vs the transform recipe (width quantum,
          duplicate widths, bucket count vs slice_rows)
  RPL006  hybrid block structure: contiguous cover from row 0, last end
          == fingerprint n, no nested hybrid, per-block fingerprints
  RPL007  sharded partition: shard spans contiguous, row-axis spans sum
          to nrows, per-shard fingerprints present, nnz conservation,
          mesh shape
  RPL008  transform recipe: name matches fmt, param types
  RPL009  fingerprint self-consistency (mu ~ nnz/n, d_mat ~ sigma/mu)
  RPL010  streaming artifacts: DeltaBatch JSON bounds and stream_plan
          envelopes (nested plan lint, policy ranges, sketch consistency)
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Tuple

from ..launch_shapes import (CCS_SPMV_WINDOW_MAX, CSR_SPMM_BLOCKS_PER_SM,
                             MAX_BLOCK_K, MAX_GRID_Y, MAX_THREADS,
                             SMEM_BLOCK_MAX, bcsr_spmm_launch, bcsr_spmm_mma,
                             bcsr_spmv_launch, ccs_spmm_launch,
                             ccs_spmv_launch, check_grid_y, coo_launch,
                             coo_spmm_groups, csr_slices, csr_spmm_launch,
                             csr_spmm_window, rhs_tile, rows_per_block)
from .findings import ERROR, WARN, Finding

#: default ceiling for RPL004: the card's shared memory per block
DEFAULT_SMEM_BUDGET = SMEM_BLOCK_MAX


def default_smem_budget() -> int:
    """The RPL004 budget: an H100's dynamic shared memory per block.  The
    port targets that one card, so nothing is queried (and no framework is
    imported); ``lint_plan(smem_budget=...)`` always wins over it."""
    return DEFAULT_SMEM_BUDGET

#: mirrors core.plan.SCHEMA_VERSION / SHARDED_SCHEMA_VERSION (the
#: registry audit's job is to notice if these ever drift)
SCHEMA_VERSION = 1
SHARDED_SCHEMA_VERSION = 1
#: mirrors stream.delta.DELTA_SCHEMA_VERSION /
#: stream.drift.STREAM_PLAN_SCHEMA_VERSION (same drift discipline)
DELTA_SCHEMA_VERSION = 1
STREAM_PLAN_SCHEMA_VERSION = 1

KNOWN_FORMATS = ("csr", "ccs", "coo_row", "coo_col", "ell_row", "ell_col",
                 "sell", "bcsr", "hybrid")
KNOWN_OPS = ("spmv", "spmm")
KNOWN_TIERS = ("reference", "kernel")

GEOM_KNOBS = ("block_rows", "block_w", "block_k", "block_nnz",
              "slabs_per_block")
#: knobs each format's CUDA wrappers read (``kernels/ops.py``);
#: ``slabs_per_block`` is recorded for the schema (ROADMAP ground rule (e)).
#: ``block_w`` is read by no CUDA launch
_FMT_KNOBS = {
    "ell_row": {"block_rows", "block_k"},
    "ell_col": {"block_rows", "block_k"},
    "sell": {"block_rows", "block_k"},
    "coo_row": {"block_nnz", "block_k"},
    "coo_col": {"block_nnz", "block_k"},
    "csr": {"block_rows", "block_nnz", "block_k", "slabs_per_block"},
    "ccs": {"block_rows", "block_k", "slabs_per_block"},
    "bcsr": {"block_rows", "block_k", "slabs_per_block"},
}
#: the JAX package's defaults, which its slab-coverage bound (RPL003) is
#: recorded at
_DEFAULT_BR = {"bcsr": 32}          # others: 256
_DEFAULT_BN = {"bcsr": 512}         # others: 2048

_EXEC_KEYS = {"schema_version", "fmt", "rule", "tier", "batch",
              "expected_iterations", "transform", "geometry", "machine",
              "d_mat", "d_star", "expected_gain", "fingerprint", "blocks"}
_EXEC_REQUIRED = ("schema_version", "fmt", "rule", "tier", "batch",
                  "expected_iterations", "transform", "geometry")
_SHARDED_KEYS = {"kind", "schema_version", "axis", "strategy", "params",
                 "mesh_shape", "mesh_axis", "batch", "shards",
                 "fingerprint"}
_FP_KEYS = ("n", "nnz", "mu", "sigma", "d_mat", "sig")


def _ceil(a: int, b: int) -> int:
    return -(-int(a) // max(int(b), 1))


def _is_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


class _Lint:
    def __init__(self, smem_budget: int):
        self.smem_budget = int(smem_budget)
        self.findings: List[Finding] = []

    def add(self, rule: str, severity: str, where: str, msg: str) -> None:
        self.findings.append(Finding(rule=rule, severity=severity,
                                     message=msg, where=where))

    def err(self, rule: str, where: str, msg: str) -> None:
        self.add(rule, ERROR, where, msg)

    def warn(self, rule: str, where: str, msg: str) -> None:
        self.add(rule, WARN, where, msg)

    # -- fingerprint (RPL009) ------------------------------------------------
    def fingerprint(self, fp: Any, where: str) -> Optional[Dict[str, Any]]:
        """Validate a fingerprint dict; returns it when structurally
        usable (n/nnz ints) so callers can cross-check against it."""
        w = f"{where}fingerprint"
        if not isinstance(fp, dict):
            self.err("RPL001", w, f"fingerprint must be an object; got "
                                  f"{type(fp).__name__}")
            return None
        for k in fp:
            if k not in _FP_KEYS:
                self.warn("RPL001", w, f"unknown fingerprint field {k!r}")
        for k in ("n", "nnz", "sig"):
            if not _is_int(fp.get(k)):
                self.err("RPL009", w, f"fingerprint.{k} must be an "
                                      f"integer; got {fp.get(k)!r}")
                return None
        n, nnz = fp["n"], fp["nnz"]
        if n < 0 or nnz < 0:
            self.err("RPL009", w, f"fingerprint has negative dimensions "
                                  f"(n={n}, nnz={nnz})")
            return None
        if nnz > 0 and n == 0:
            self.err("RPL009", w, f"nnz={nnz} with n=0 rows")
            return None
        for k in ("mu", "sigma", "d_mat"):
            v = fp.get(k)
            if v is not None and not _is_num(v):
                self.err("RPL009", w, f"fingerprint.{k} must be a number "
                                      f"or null; got {v!r}")
        mu = fp.get("mu")
        if _is_num(mu) and n > 0:
            expect = nnz / n
            if abs(mu - expect) > 1e-6 * max(1.0, expect):
                self.warn("RPL009", w, f"mu={mu:g} but nnz/n={expect:g}")
        sigma, d_mat = fp.get("sigma"), fp.get("d_mat")
        if _is_num(mu) and _is_num(sigma) and _is_num(d_mat) and mu > 0:
            expect = sigma / mu
            if abs(d_mat - expect) > 1e-6 * max(1.0, expect):
                self.warn("RPL009", w,
                          f"d_mat={d_mat:g} but sigma/mu={expect:g}")
        return fp

    # -- geometry (RPL002) ---------------------------------------------------
    def _knobs(self, gd: Dict[str, Any], fmt: str, where: str,
               allow_buckets: bool, op: str = "spmv", batch: int = 1,
               params: Optional[Dict[str, Any]] = None) -> None:
        relevant = _FMT_KNOBS.get(fmt, set(GEOM_KNOBS))
        for k, v in gd.items():
            if k == "buckets":
                if not allow_buckets:
                    self.warn("RPL002", where, "per-bucket table on a "
                                               "non-SELL geometry")
                self._buckets(v, where, op, batch)
                continue
            if k not in GEOM_KNOBS:
                self.err("RPL002", where, f"unknown geometry field {k!r}")
                continue
            if not _is_int(v) or v < 1:
                self.err("RPL002", where,
                         f"{k}={v!r} must be a positive integer")
                continue
            if k not in relevant:
                self.warn("RPL002", where,
                          f"{k} is not read by the {fmt!r} CUDA kernels")
        self._launch_limits(gd, fmt, op, where, batch, params or {})

    def _launch_limits(self, gd: Dict[str, Any], fmt: str, op: str,
                       where: str, batch: int,
                       params: Dict[str, Any]) -> None:
        """What the launch helpers do with the knobs: ``check_grid_y``
        rejects (ERROR), ``rhs_tile`` and ``clamp_threads`` clamp (WARN)."""
        bk, br = gd.get("block_k"), gd.get("block_rows")
        # a block_k that is not a positive integer is reported above
        if op == "spmm" and (bk is None or (_is_int(bk) and bk >= 1)):
            if bk is not None and bk > MAX_BLOCK_K:
                self.warn("RPL002", where,
                          f"block_k={bk} is clamped to the widest column "
                          f"tile, {MAX_BLOCK_K}")
            kt = rhs_tile(batch, bk)[0]
            try:
                check_grid_y(batch, kt)
            except ValueError:
                self.err("RPL002", where,
                         f"batch={batch} in tiles of {kt} columns needs "
                         f"more than {MAX_GRID_Y} blocks along grid.y")
        if not (_is_int(br) and br >= 1):
            return
        lanes = _min_lanes(fmt, op, gd, batch, params)
        if lanes is not None and br * lanes > MAX_THREADS:
            self.warn("RPL002", where,
                      f"block_rows={br} at {lanes} thread(s) a row exceeds "
                      f"{MAX_THREADS} threads a block and is clamped")

    def _buckets(self, buckets: Any, where: str, op: str = "spmv",
                 batch: int = 1) -> List[int]:
        w = f"{where}.buckets"
        if not isinstance(buckets, list):
            self.err("RPL002", w, f"buckets must be a list; got "
                                  f"{type(buckets).__name__}")
            return []
        widths: List[int] = []
        for i, pair in enumerate(buckets):
            if (not isinstance(pair, (list, tuple)) or len(pair) != 2
                    or not _is_int(pair[0]) or pair[0] < 1
                    or not isinstance(pair[1], dict)):
                self.err("RPL002", f"{w}[{i}]",
                         "bucket entries must be [width, geometry] pairs")
                continue
            widths.append(pair[0])
            self._knobs(pair[1], "sell", f"{w}[{i}]", allow_buckets=False,
                        op=op, batch=batch)
        return widths

    def geometry(self, geo: Any, fmt: str, where: str,
                 fp: Optional[Dict[str, Any]], tier: str,
                 params: Dict[str, Any], batch: int) -> None:
        w = f"{where}geometry"
        if not isinstance(geo, dict):
            self.err("RPL001", w, f"geometry must be an object; got "
                                  f"{type(geo).__name__}")
            return
        for op, gd in geo.items():
            wo = f"{w}.{op}"
            if op not in KNOWN_OPS:
                self.err("RPL002", wo,
                         f"unknown op {op!r}; one of {KNOWN_OPS}")
            if not isinstance(gd, dict):
                self.err("RPL002", wo, f"op geometry must be an object; "
                                       f"got {type(gd).__name__}")
                continue
            if fmt == "hybrid":
                self.warn("RPL006", wo, "hybrid plans carry geometry on "
                                        "their block sub-plans, not at "
                                        "the top level")
                continue
            self._knobs(gd, fmt, wo, allow_buckets=(fmt == "sell"),
                        op=op, batch=batch, params=params)
            self._slab_bound(gd, fmt, wo, fp, params)
            if tier == "kernel":
                self._smem(gd, fmt, op, wo, params, batch)

    # -- slab bound (RPL003) -------------------------------------------------
    def _slab_bound(self, gd: Dict[str, Any], fmt: str, where: str,
                    fp: Optional[Dict[str, Any]],
                    params: Dict[str, Any]) -> None:
        spb = gd.get("slabs_per_block")
        if not _is_int(spb) or fmt not in ("csr", "bcsr"):
            # CCS segments columns; the fingerprint has no column count
            # to bound against
            return
        if fp is None:
            self.warn("RPL003", where, "slabs_per_block recorded but the "
                                       "plan has no fingerprint to check "
                                       "it against")
            return
        n, nnz = fp["n"], fp["nnz"]
        br = gd.get("block_rows") or _DEFAULT_BR.get(fmt, 256)
        bn = gd.get("block_nnz") or _DEFAULT_BN.get(fmt, 2048)
        if not _is_int(br) or not _is_int(bn) or br < 1 or bn < 1:
            return                      # RPL002 already reported
        if fmt == "bcsr":
            b = params.get("block")
            b = b if _is_int(b) and b >= 1 else 8
            segments = _ceil(_ceil(n, b), br)    # block-row tiles
            units = _ceil(nnz, b * b)            # >= stored blocks
        else:
            segments = _ceil(n, br)              # row tiles
            units = nnz
        # every launch sweeps segments * spb slabs of bn units each; the
        # recorded structure needs at least ceil(units / (segments * bn))
        # slabs per segment block no matter how the rows distribute
        need = max(1, _ceil(units, max(segments, 1) * bn)) if units else 1
        if spb < need:
            self.err("RPL003", where,
                     f"slabs_per_block={spb} cannot cover the recorded "
                     f"structure: n={n}, nnz={nnz} needs at least {need} "
                     f"slabs per block at block_rows={br}, block_nnz={bn}")

    # -- shared-memory footprint (RPL004) -----------------------------------
    def _smem(self, gd: Dict[str, Any], fmt: str, op: str, where: str,
              params: Dict[str, Any], batch: int) -> None:
        fp = _footprint(gd, fmt, op, params, batch)
        if fp is None:
            return
        threads, size = fp
        if size > self.smem_budget:
            self.err("RPL004", where,
                     f"knob-driven shared memory ~{size / 1024:.1f} KiB a "
                     f"block ({threads} threads) exceeds the "
                     f"{self.smem_budget / 1024:.1f} KiB budget")

    # -- SELL recipe vs bucket table (RPL005) ----------------------------------
    def _sell(self, d: Dict[str, Any], where: str,
              fp: Optional[Dict[str, Any]]) -> None:
        params = _params_of(d)
        quantum = params.get("width_quantum", 8)
        slice_rows = params.get("slice_rows", 128)
        if not _is_int(quantum) or quantum < 1:
            self.err("RPL008", f"{where}transform",
                     f"width_quantum={quantum!r} must be a positive "
                     f"integer")
            quantum = 8
        if not _is_int(slice_rows) or slice_rows < 1:
            self.err("RPL008", f"{where}transform",
                     f"slice_rows={slice_rows!r} must be a positive "
                     f"integer")
            slice_rows = 128
        geo = d.get("geometry")
        if not isinstance(geo, dict):
            return
        for op, gd in geo.items():
            if not isinstance(gd, dict) or "buckets" not in gd:
                continue
            w = f"{where}geometry.{op}.buckets"
            widths = [p[0] for p in gd["buckets"]
                      if isinstance(p, (list, tuple)) and len(p) == 2
                      and _is_int(p[0])]
            seen = set()
            for wd in widths:
                if wd % quantum:
                    self.err("RPL005", w,
                             f"bucket width {wd} is not a multiple of the "
                             f"recipe's width_quantum={quantum}")
                if wd in seen:
                    self.err("RPL005", w, f"duplicate bucket width {wd}")
                seen.add(wd)
            if any(b > a for a, b in zip(widths, widths[1:])):
                self.warn("RPL005", w,
                          "bucket widths are not sorted descending (the "
                          "transform emits them widest-first)")
            if fp is not None and widths:
                max_buckets = max(1, _ceil(fp["n"], slice_rows))
                if len(widths) > max_buckets:
                    self.err("RPL005", w,
                             f"{len(widths)} buckets but slice_rows="
                             f"{slice_rows} over n={fp['n']} rows yields "
                             f"at most {max_buckets}")

    # -- transform recipe (RPL008) ---------------------------------------------
    def transform(self, d: Dict[str, Any], fmt: str, where: str) -> None:
        t = d.get("transform")
        w = f"{where}transform"
        if not isinstance(t, dict) or not isinstance(t.get("name"), str):
            self.err("RPL001", w, "transform must be an object with a "
                                  "string 'name'")
            return
        name = t["name"]
        params = t.get("params", {})
        if not isinstance(params, dict):
            self.err("RPL001", w, f"transform.params must be an object; "
                                  f"got {type(params).__name__}")
            return
        if name not in KNOWN_FORMATS:
            self.err("RPL008", w, f"unknown transform {name!r}; one of "
                                  f"{KNOWN_FORMATS}")
        elif name != fmt:
            self.err("RPL008", w,
                     f"transform {name!r} cannot produce fmt {fmt!r} — "
                     f"bind would dispatch the wrong container")
        if name == "bcsr":
            b = params.get("block", 8)
            if not _is_int(b) or b < 1:
                self.err("RPL008", w, f"block={b!r} must be a positive "
                                      f"integer")
        if name in ("csr", "ccs", "coo_row", "coo_col") and params:
            self.warn("RPL008", w,
                      f"the {name!r} transform takes no params; got "
                      f"{sorted(params)}")

    # -- whole plans -----------------------------------------------------------
    def exec_plan(self, d: Dict[str, Any], where: str,
                  allow_hybrid: bool = True) -> Optional[Dict[str, Any]]:
        """Lint one ExecutionPlan payload; returns its fingerprint dict
        (when usable) so containers can cross-check partitions."""
        for k in d:
            if k not in _EXEC_KEYS:
                self.warn("RPL001", f"{where}{k}", "unknown plan field")
        missing = [k for k in _EXEC_REQUIRED if k not in d]
        if missing:
            self.err("RPL001", where or "plan",
                     f"missing required fields {missing}")
            return None
        if d["schema_version"] != SCHEMA_VERSION:
            self.err("RPL001", f"{where}schema_version",
                     f"unsupported schema_version={d['schema_version']!r};"
                     f" this linter reads version {SCHEMA_VERSION}")
        fmt = d["fmt"]
        if not isinstance(fmt, str) or fmt not in KNOWN_FORMATS:
            self.err("RPL001", f"{where}fmt",
                     f"unknown format {fmt!r}; one of {KNOWN_FORMATS}")
            return None
        if d["tier"] not in KNOWN_TIERS:
            self.err("RPL001", f"{where}tier",
                     f"unknown tier {d['tier']!r}; one of {KNOWN_TIERS}")
        if not isinstance(d["rule"], str):
            self.err("RPL001", f"{where}rule", "rule must be a string")
        batch = d["batch"]
        if not _is_int(batch) or batch < 1:
            self.err("RPL001", f"{where}batch",
                     f"batch={batch!r} must be a positive integer")
            batch = 1
        k_iter = d["expected_iterations"]
        if not _is_int(k_iter) or k_iter < 1:
            self.err("RPL001", f"{where}expected_iterations",
                     f"expected_iterations={k_iter!r} must be a positive "
                     f"integer")
        for key in ("d_mat", "d_star", "expected_gain"):
            v = d.get(key)
            if v is not None and not _is_num(v):
                self.err("RPL001", f"{where}{key}",
                         f"must be a number or null; got {v!r}")

        fp = None
        if d.get("fingerprint") is not None:
            fp = self.fingerprint(d["fingerprint"], where)
        self.transform(d, fmt, where)
        tier = d["tier"] if d["tier"] in KNOWN_TIERS else "reference"
        self.geometry(d.get("geometry"), fmt, where, fp, tier,
                      _params_of(d), batch)
        if fmt == "sell":
            self._sell(d, where, fp)

        blocks = d.get("blocks")
        if fmt == "hybrid":
            if not allow_hybrid:
                self.err("RPL006", where or "plan",
                         "hybrid plans cannot nest inside hybrid blocks")
            if not isinstance(blocks, list) or not blocks:
                self.err("RPL006", where or "plan",
                         "hybrid plan has no blocks")
                return fp
            self._hybrid_blocks(blocks, where, fp)
        elif blocks:
            self.err("RPL006", f"{where}blocks",
                     f"leaf plan (fmt={fmt!r}) carries hybrid blocks")
        return fp

    def _hybrid_blocks(self, blocks: List[Any], where: str,
                       fp: Optional[Dict[str, Any]]) -> None:
        prev_end, nnz_sum, all_fp = 0, 0, True
        for i, blk in enumerate(blocks):
            w = f"{where}blocks[{i}]"
            if not isinstance(blk, dict) or "rows" not in blk \
                    or "plan" not in blk:
                self.err("RPL006", w, "block entries must be objects with "
                                      "'rows' and 'plan'")
                return
            rows = blk["rows"]
            if (not isinstance(rows, list) or len(rows) != 2
                    or not all(_is_int(r) for r in rows)):
                self.err("RPL006", f"{w}.rows",
                         f"rows must be an [start, end) integer pair; "
                         f"got {rows!r}")
                return
            s, e = rows
            if s != prev_end or e <= s:
                self.err("RPL006", f"{w}.rows",
                         f"blocks must tile rows contiguously from 0; "
                         f"block {i} covers [{s}, {e}) after row "
                         f"{prev_end}")
            prev_end = e
            if not isinstance(blk["plan"], dict):
                self.err("RPL006", f"{w}.plan", "block plan must be an "
                                                "object")
                continue
            sub_fp = self.exec_plan(blk["plan"], f"{w}.plan.",
                                    allow_hybrid=False)
            if sub_fp is None:
                if blk["plan"].get("fingerprint") is None:
                    self.warn("RPL006", f"{w}.plan",
                              "block sub-plan has no fingerprint")
                all_fp = False
                continue
            nnz_sum += sub_fp["nnz"]
            if sub_fp["n"] != e - s:
                self.err("RPL006", f"{w}.plan.fingerprint",
                         f"sub-plan was minted on {sub_fp['n']} rows but "
                         f"its block spans [{s}, {e})")
        if fp is not None:
            if prev_end != fp["n"]:
                self.err("RPL006", f"{where}blocks",
                         f"blocks cover {prev_end} rows but the plan's "
                         f"fingerprint has n={fp['n']}")
            if all_fp and nnz_sum != fp["nnz"]:
                self.err("RPL006", f"{where}blocks",
                         f"block fingerprints sum to nnz={nnz_sum} but "
                         f"the plan's fingerprint has nnz={fp['nnz']}")

    def sharded(self, d: Dict[str, Any], where: str) -> None:
        for k in d:
            if k not in _SHARDED_KEYS:
                self.warn("RPL001", f"{where}{k}", "unknown plan field")
        if d.get("schema_version") != SHARDED_SCHEMA_VERSION:
            self.err("RPL001", f"{where}schema_version",
                     f"unsupported ShardedPlan schema_version="
                     f"{d.get('schema_version')!r}")
        axis = d.get("axis")
        if axis not in ("row", "col"):
            self.err("RPL007", f"{where}axis",
                     f"unknown sharding axis {axis!r}; one of "
                     f"('row', 'col')")
            axis = "row"
        if not isinstance(d.get("strategy"), str):
            self.err("RPL001", f"{where}strategy",
                     "strategy must be a string")
        batch = d.get("batch", 1)
        if not _is_int(batch) or batch < 1:
            self.err("RPL001", f"{where}batch",
                     f"batch={batch!r} must be a positive integer")
        fp = None
        if d.get("fingerprint") is not None:
            fp = self.fingerprint(d["fingerprint"], where)
        shards = d.get("shards")
        if not isinstance(shards, list) or not shards:
            self.err("RPL007", f"{where}shards",
                     "sharded plan has no shards")
            return
        mesh = d.get("mesh_shape", [])
        if isinstance(mesh, list) and mesh:
            if not all(_is_int(m) and m >= 1 for m in mesh):
                self.err("RPL001", f"{where}mesh_shape",
                         f"mesh_shape must be positive integers; got "
                         f"{mesh!r}")
            else:
                prod = 1
                for m in mesh:
                    prod *= m
                if prod != len(shards):
                    self.warn("RPL007", f"{where}mesh_shape",
                              f"mesh_shape {mesh} addresses {prod} "
                              f"devices but the plan has {len(shards)} "
                              f"shards")
        prev_end, nnz_sum, all_fp = 0, 0, True
        for i, sh in enumerate(shards):
            w = f"{where}shards[{i}]"
            if not isinstance(sh, dict) or "rows" not in sh \
                    or "plan" not in sh:
                self.err("RPL007", w, "shard entries must be objects "
                                      "with 'rows' and 'plan'")
                return
            rows = sh["rows"]
            if (not isinstance(rows, list) or len(rows) != 2
                    or not all(_is_int(r) for r in rows)):
                self.err("RPL007", f"{w}.rows",
                         f"rows must be an [start, end) integer pair; "
                         f"got {rows!r}")
                return
            s, e = rows
            if s != prev_end or e <= s:
                self.err("RPL007", f"{w}.rows",
                         f"shards must tile the {axis} axis contiguously "
                         f"from 0; shard {i} covers [{s}, {e}) after "
                         f"{prev_end}")
            prev_end = e
            if not isinstance(sh["plan"], dict):
                self.err("RPL007", f"{w}.plan", "shard plan must be an "
                                                "object")
                continue
            sub_fp = self.exec_plan(sh["plan"], f"{w}.plan.")
            if sub_fp is None:
                all_fp = False
                if sh["plan"].get("fingerprint") is None:
                    self.err("RPL007", f"{w}.plan",
                             "per-shard fingerprint missing — a replayed "
                             "shard cannot verify its slab")
                continue
            nnz_sum += sub_fp["nnz"]
            if axis == "row" and sub_fp["n"] != e - s:
                self.err("RPL007", f"{w}.plan.fingerprint",
                         f"shard plan was minted on {sub_fp['n']} rows "
                         f"but its slab spans [{s}, {e})")
            if axis == "col" and fp is not None \
                    and sub_fp["n"] != fp["n"]:
                self.err("RPL007", f"{w}.plan.fingerprint",
                         f"column shards keep the full row space "
                         f"(n={fp['n']}) but shard {i} has "
                         f"n={sub_fp['n']}")
        if fp is not None:
            if axis == "row" and prev_end != fp["n"]:
                self.err("RPL007", f"{where}shards",
                         f"shard spans cover {prev_end} rows but the "
                         f"plan's fingerprint has n={fp['n']}")
            if all_fp and nnz_sum != fp["nnz"]:
                self.err("RPL007", f"{where}shards",
                         f"shard fingerprints sum to nnz={nnz_sum} but "
                         f"the plan's fingerprint has nnz={fp['nnz']}")

    # -- streaming artifacts (RPL010) ------------------------------------------
    def _int_list(self, v: Any, where: str, what: str,
                  upper: Optional[int] = None) -> Optional[int]:
        """Check a JSON list of non-negative ints (optionally bounded
        above); returns its length, or None when unusable."""
        if not isinstance(v, list):
            self.err("RPL010", where, f"{what} must be a list; got "
                                      f"{type(v).__name__}")
            return None
        for i, x in enumerate(v):
            if not _is_int(x) or x < 0:
                self.err("RPL010", f"{where}[{i}]",
                         f"{what} entries must be non-negative integers; "
                         f"got {x!r}")
                return None
            if upper is not None and x >= upper:
                self.err("RPL010", f"{where}[{i}]",
                         f"{what} index {x} out of range [0, {upper})")
                return None
        return len(v)

    def delta_batch(self, d: Dict[str, Any], where: str) -> None:
        """A serialized ``DeltaBatch``: the
        bounds that make ``apply_delta`` safe, checkable from JSON."""
        known = {"kind", "schema_version", "n_cols", "appends", "updates",
                 "deletes"}
        for k in d:
            if k not in known:
                self.warn("RPL001", f"{where}{k}", "unknown delta field")
        if d.get("schema_version") != DELTA_SCHEMA_VERSION:
            self.err("RPL010", f"{where}schema_version",
                     f"unsupported delta schema_version="
                     f"{d.get('schema_version')!r}; this linter reads "
                     f"version {DELTA_SCHEMA_VERSION}")
        n_cols = d.get("n_cols")
        if not _is_int(n_cols) or n_cols < 1:
            self.err("RPL010", f"{where}n_cols",
                     f"n_cols={n_cols!r} must be a positive integer")
            n_cols = None
        appends = d.get("appends", [])
        if not isinstance(appends, list):
            self.err("RPL010", f"{where}appends",
                     f"appends must be a list; got "
                     f"{type(appends).__name__}")
        else:
            for i, pair in enumerate(appends):
                w = f"{where}appends[{i}]"
                if not isinstance(pair, (list, tuple)) or len(pair) != 2:
                    self.err("RPL010", w, "append entries must be "
                                          "[cols, vals] pairs")
                    continue
                cols, vals = pair
                nc = self._int_list(cols, f"{w}.cols", "append cols",
                                    upper=n_cols)
                if not isinstance(vals, list):
                    self.err("RPL010", f"{w}.vals",
                             f"append vals must be a list; got "
                             f"{type(vals).__name__}")
                elif not all(_is_num(v) for v in vals):
                    self.err("RPL010", f"{w}.vals",
                             "append vals must be numbers")
                elif nc is not None and len(vals) != nc:
                    self.err("RPL010", w,
                             f"append row has {nc} cols but "
                             f"{len(vals)} vals")
        for section, fields in (("updates", ("rows", "cols", "vals")),
                                ("deletes", ("rows", "cols"))):
            sec = d.get(section, {})
            w = f"{where}{section}"
            if not isinstance(sec, dict):
                self.err("RPL010", w, f"{section} must be an object; got "
                                      f"{type(sec).__name__}")
                continue
            lens = {}
            for f in fields:
                v = sec.get(f, [])
                if f == "vals":
                    if not isinstance(v, list) \
                            or not all(_is_num(x) for x in v):
                        self.err("RPL010", f"{w}.{f}",
                                 f"{section}.{f} must be a list of "
                                 f"numbers")
                        continue
                    lens[f] = len(v)
                else:
                    n = self._int_list(v, f"{w}.{f}", f"{section}.{f}",
                                       upper=(n_cols if f == "cols"
                                              else None))
                    if n is not None:
                        lens[f] = n
            if len(set(lens.values())) > 1:
                self.err("RPL010", w,
                         f"{section} coordinate lists disagree on "
                         f"length: { {f: n for f, n in lens.items()} }")

    def stream_plan(self, d: Dict[str, Any], where: str) -> None:
        """A ``stream_plan`` artifact
        (the streaming tier's ``StreamingPlannedMatrix.to_dict``): the
        wrapped ExecutionPlan gets the full RPL001–RPL009 pass, plus the
        drift-policy and sketch ranges the re-plan trigger relies on."""
        known = {"kind", "schema_version", "key", "plan", "sketch",
                 "policy", "counters"}
        for k in d:
            if k not in known:
                self.warn("RPL001", f"{where}{k}", "unknown stream_plan "
                                                   "field")
        if d.get("schema_version") != STREAM_PLAN_SCHEMA_VERSION:
            self.err("RPL010", f"{where}schema_version",
                     f"unsupported stream_plan schema_version="
                     f"{d.get('schema_version')!r}; this linter reads "
                     f"version {STREAM_PLAN_SCHEMA_VERSION}")
        plan = d.get("plan")
        if not isinstance(plan, dict):
            self.err("RPL010", f"{where}plan",
                     "stream_plan must embed its ExecutionPlan object")
        else:
            self.exec_plan(plan, f"{where}plan.")
        sketch = d.get("sketch")
        fp_n = None
        if not isinstance(sketch, dict):
            self.err("RPL010", f"{where}sketch",
                     "stream_plan must embed its drift sketch")
        else:
            for f in ("n", "nnz", "updates"):
                if not _is_int(sketch.get(f)) or sketch[f] < 0:
                    self.err("RPL010", f"{where}sketch.{f}",
                             f"sketch.{f} must be a non-negative "
                             f"integer; got {sketch.get(f)!r}")
            if not _is_num(sketch.get("sum_sq")) \
                    or sketch["sum_sq"] < 0:
                self.err("RPL010", f"{where}sketch.sum_sq",
                         f"sketch.sum_sq must be a non-negative number; "
                         f"got {sketch.get('sum_sq')!r}")
            hist_n = self._int_list(sketch.get("hist", []),
                                    f"{where}sketch.hist", "sketch.hist")
            if hist_n is not None and _is_int(sketch.get("n")):
                total = sum(sketch["hist"])
                if total != sketch["n"]:
                    self.err("RPL010", f"{where}sketch.hist",
                             f"row-length histogram sums to {total} but "
                             f"the sketch tracks n={sketch['n']} rows")
                fp_n = sketch["n"]
        if isinstance(plan, dict) and fp_n is not None:
            pf = plan.get("fingerprint")
            if isinstance(pf, dict) and _is_int(pf.get("n")) \
                    and pf["n"] != fp_n:
                self.warn("RPL010", f"{where}sketch",
                          f"sketch tracks n={fp_n} rows but the embedded "
                          f"plan was minted on n={pf['n']} — deltas have "
                          f"outgrown the plan (expected between re-plans)")
        policy = d.get("policy")
        if isinstance(policy, dict):
            hyst = policy.get("hysteresis")
            if not _is_num(hyst) or not (0.0 <= hyst < 1.0):
                self.err("RPL010", f"{where}policy.hysteresis",
                         f"hysteresis={hyst!r} must be a number in "
                         f"[0, 1) — at 1 the dead-band swallows the "
                         f"whole boundary")
            for f in ("retransform_factor", "k_hat"):
                v = policy.get(f)
                if v is not None and (not _is_num(v) or v < 0):
                    self.err("RPL010", f"{where}policy.{f}",
                             f"{f}={v!r} must be a non-negative number")
            b = policy.get("batch")
            if b is not None and (not _is_int(b) or b < 1):
                self.err("RPL010", f"{where}policy.batch",
                         f"batch={b!r} must be a positive integer")
            mdb = policy.get("min_deltas_between")
            if mdb is not None and (not _is_int(mdb) or mdb < 0):
                self.err("RPL010", f"{where}policy.min_deltas_between",
                         f"min_deltas_between={mdb!r} must be a "
                         f"non-negative integer")
        elif policy is not None:
            self.err("RPL010", f"{where}policy",
                     f"policy must be an object; got "
                     f"{type(policy).__name__}")
        counters = d.get("counters")
        if isinstance(counters, dict):
            for f, v in counters.items():
                if not _is_int(v) or v < 0:
                    self.err("RPL010", f"{where}counters.{f}",
                             f"counter {f}={v!r} must be a non-negative "
                             f"integer")


def _params_of(d: Dict[str, Any]) -> Dict[str, Any]:
    t = d.get("transform")
    if isinstance(t, dict) and isinstance(t.get("params"), dict):
        return t["params"]
    return {}


def _knob(gd: Dict[str, Any], name: str) -> Optional[int]:
    v = gd.get(name)
    return v if _is_int(v) and v >= 1 else None


def _block_of(params: Dict[str, Any]) -> int:
    b = params.get("block")
    return b if _is_int(b) and b >= 1 else 8


def _min_lanes(fmt: str, op: str, gd: Dict[str, Any], batch: int,
               params: Dict[str, Any]) -> Optional[int]:
    """Fewest threads the format's launch gives one unit of ``block_rows``
    (a row, a CCS column, a BCSR block row), whatever the matrix; ``None``
    where ``block_rows`` is not bound by the threads a block holds (CSR and
    BCSR SpMM's window and tensor-core kernels, CCS SpMV's warp runs)."""
    bk = _knob(gd, "block_k")
    if op == "spmm":
        if fmt == "csr" and csr_spmm_window(batch, bk):
            return None
        if fmt == "bcsr" and bcsr_spmm_mma(batch, _block_of(params), bk):
            return None
        return rhs_tile(batch, bk)[1]
    if fmt == "bcsr":
        return _block_of(params)
    if fmt in ("ell_row", "ell_col", "sell"):
        return 1
    return None


#: rows, columns and entries of a matrix no launch clamps its shape to: the
#: footprint the knobs allow, at its largest over matrices
_ANY = 1 << 30


def _footprint(gd: Dict[str, Any], fmt: str, op: str,
               params: Dict[str, Any], batch: int
               ) -> Optional[Tuple[int, int]]:
    """``(threads, shared bytes)`` of one CUDA block, from the knobs alone,
    as the launch helpers shape it.

    Counts the shared memory whose size the knobs choose, at its largest
    over matrices (float32 values): COO SpMV's staged pass (8 bytes an
    entry a thread's chunk), the CSR SpMM window kernel's share of the SM
    (the window is cut to it), K10's slice ring (``bcsr_spmm_launch``), and
    K7's y windows (at their largest, ``CCS_SPMV_WINDOW_MAX`` rows of four
    windows and a flag).  K8's Y window is sized by the matrix, not a knob
    (its launch refuses more than 48 KiB), and the other launches keep their
    state in registers.  ``None`` for a launch the helpers reject (RPL002
    reports it) or a format with no CUDA launch."""
    br, bn, bk = (_knob(gd, k) for k in ("block_rows", "block_nnz",
                                         "block_k"))
    b = _block_of(params)
    if op == "spmv":
        if fmt in ("coo_row", "coo_col"):
            threads, _, chunk = coo_launch(bn)
            return threads, threads * chunk * 8
        if fmt == "csr":
            return csr_slices(0, bn)[0], 0
        if fmt == "ccs":
            threads = ccs_spmv_launch(_ANY, _ANY, _ANY, br)[0]
            return threads, threads // 32 * CCS_SPMV_WINDOW_MAX * (4 * 4 + 1)
        if fmt == "bcsr":
            return bcsr_spmv_launch(b, br)[0], 0
        if fmt in ("ell_row", "ell_col", "sell"):
            return rows_per_block(1, br), 0
        return None
    kt, lanes, _ = rhs_tile(batch, bk)
    try:
        check_grid_y(batch, kt)
        if fmt == "csr" and csr_spmm_window(batch, bk):
            threads = csr_spmm_launch(batch, _ANY, _ANY, _ANY, br, bk,
                                      window=True)[3]
            return threads, SMEM_BLOCK_MAX // CSR_SPMM_BLOCKS_PER_SM
        if fmt == "bcsr" and bcsr_spmm_mma(batch, b, bk):
            _, threads, _, slots, stride = bcsr_spmm_launch(batch, b, br, bk)
            return threads, slots * (b * stride + b * b * 4)
        if fmt == "ccs":
            return ccs_spmm_launch(batch, _ANY, _ANY, _ANY, br, bk)[3], 0
    except ValueError:
        return None
    if fmt in ("coo_row", "coo_col"):
        return coo_spmm_groups(lanes, bn)[0], 0
    if fmt in ("csr", "bcsr", "ell_row", "ell_col", "sell"):
        return rows_per_block(lanes, br) * lanes, 0
    return None


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def lint_plan(payload: Any,
              smem_budget: Optional[int] = None) -> List[Finding]:
    """Lint a plan payload dict — ExecutionPlan, ShardedPlan, or a
    streaming artifact (``delta_batch`` / ``stream_plan``), routed on
    ``kind``.  Returns findings; empty means clean.  ``smem_budget``
    (bytes of shared memory a block) defaults to
    :func:`default_smem_budget`, an H100's."""
    lint = _Lint(smem_budget if smem_budget is not None
                 else default_smem_budget())
    if not isinstance(payload, dict):
        lint.err("RPL001", "plan", f"plan payload must be a JSON object; "
                                   f"got {type(payload).__name__}")
        return lint.findings
    kind = payload.get("kind")
    if kind == "sharded_plan":
        lint.sharded(payload, "")
    elif kind == "delta_batch":
        lint.delta_batch(payload, "")
    elif kind == "stream_plan":
        lint.stream_plan(payload, "")
    else:
        lint.exec_plan(payload, "")
    return lint.findings


def lint_envelope(env: Any,
                  smem_budget: Optional[int] = None) -> List[Finding]:
    """Lint a :class:`~repro_torch.core.plan_store.PlanStore` envelope
    (``{store_version, sha256, plan}``) — checksum verified here with the
    same canonical-JSON convention the store writes, then the payload is
    linted."""
    if (not isinstance(env, dict) or "plan" not in env
            or "sha256" not in env):
        return [Finding("RPL001", ERROR, "not a plan-store envelope "
                        "(missing 'plan'/'sha256')", where="envelope")]
    findings: List[Finding] = []
    if env.get("store_version") != 1:
        findings.append(Finding(
            "RPL001", ERROR, f"unsupported store_version="
            f"{env.get('store_version')!r}", where="envelope"))
    canonical = json.dumps(env["plan"], sort_keys=True,
                           separators=(",", ":"))
    digest = hashlib.sha256(canonical.encode("utf-8")).hexdigest()
    if digest != env["sha256"]:
        findings.append(Finding(
            "RPL001", ERROR, "envelope sha256 does not match the payload "
            "(bit rot or a tampered entry)", where="envelope"))
    findings.extend(lint_plan(env["plan"], smem_budget=smem_budget))
    return findings


def lint_text(text: str,
              smem_budget: Optional[int] = None) -> List[Finding]:
    """Lint raw JSON text: auto-detects bare plan payloads vs store
    envelopes."""
    try:
        obj = json.loads(text)
    except json.JSONDecodeError as e:
        return [Finding("RPL001", ERROR, f"not valid JSON: {e}")]
    if isinstance(obj, dict) and "sha256" in obj and "plan" in obj:
        return lint_envelope(obj, smem_budget=smem_budget)
    return lint_plan(obj, smem_budget=smem_budget)


__all__ = ["DEFAULT_SMEM_BUDGET", "SMEM_BLOCK_MAX", "KNOWN_FORMATS",
           "KNOWN_OPS", "KNOWN_TIERS", "GEOM_KNOBS",
           "default_smem_budget", "lint_plan", "lint_envelope",
           "lint_text"]
