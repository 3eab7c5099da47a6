"""Crash-safe persistent plan store: tune once per fleet, not per replica.

A fleet of serving replicas all paying the tuner's search for the same
matrix is the paper's amortization rule applied at the wrong granularity —
``t_trans`` (and the launch-geometry sweep) should be paid once per
*matrix structure per machine class*, then shared.  :class:`PlanStore` is
that shared layer: a fingerprint-keyed on-disk directory of serialized
:class:`~repro_torch.core.plan.ExecutionPlan` (and ``ShardedPlan``)
artifacts that any number of processes read and write concurrently.

Durability contract (what "crash-safe" means here):

* **Atomic writes** — entries are written to a same-directory temp file
  and published with ``os.replace``; a reader never observes a torn or
  partial JSON, and two racing writers leave one intact winner.
* **Checksummed payloads** — each entry is an envelope carrying the
  sha256 of its canonical payload JSON; a flipped bit anywhere fails
  verification on load.
* **Quarantine, never raise** — a corrupted, truncated, checksum-failing,
  or schema-incompatible entry is moved to a ``.bad/`` subdirectory (with
  a reason suffix) and reported through ``repro_torch.obs``; ``get`` returns
  ``None`` and the caller re-tunes.  A broken store entry can cost one
  re-tune; it must never take a replica down.
* **Bounded growth** — with ``max_entries`` set, every ``put`` finishes
  with an LRU sweep (recency = file mtime, refreshed on every hit) that
  unlinks the coldest entries down to the cap and counts them under
  ``store.evict``.  Unbounded by default: a shared fleet store is usually
  curated by capacity, not time.

On-disk layout (the JAX package's, so a directory written by either
package reads in the other; ``docs/robustness.md``)::

    <root>/
      <key>.json          # envelope: {store_version, sha256, plan}
      .bad/
        <key>.json.<reason>.<n>   # quarantined entries, kept for forensics

``key`` is a sha256 hex digest over the matrix fingerprint plus the
registration knobs (batch, expected_iterations, strategy, build kwargs) —
the same identity the in-process plan cache uses, made process-portable.

The ``store.corrupt`` fault point (:mod:`repro_torch.serve.faults`)
scribbles over an entry right after :meth:`PlanStore.put` publishes it, so
the checksum/quarantine path is exercised end-to-end in CI.

A sharded plan (``kind == "sharded_plan"``) is stored, checked and
served like any other: :meth:`PlanStore.get` returns a
:class:`~repro_torch.core.plan.ShardedPlan` for it.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

from .. import obs as _obs

STORE_VERSION = 1

#: quarantine subdirectory name
BAD_DIR = ".bad"

def _canonical(payload: Dict[str, Any]) -> str:
    """The byte-stable JSON the checksum covers."""
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def _sha256(s: str) -> str:
    return hashlib.sha256(s.encode("utf-8")).hexdigest()


def fingerprint_key(fingerprint: Any, **knobs: Any) -> str:
    """Deterministic store key: sha256 over the matrix's structural
    fingerprint (n, nnz, indptr CRC) and the registration knobs.  ``repr``
    of plain values is stable across processes; callers should pass only
    ints/floats/strings/tuples."""
    fp = {"n": int(getattr(fingerprint, "n", 0)),
          "nnz": int(getattr(fingerprint, "nnz", 0)),
          "sig": int(getattr(fingerprint, "sig", 0))}
    body = _canonical({"fp": fp, "knobs": {k: repr(v) for k, v in
                                           sorted(knobs.items())}})
    return _sha256(body)


class PlanStore:
    """Fingerprint-keyed on-disk plan store shared across processes.

    >>> store = PlanStore("/var/lib/repro/plans")
    >>> key = store.key_for(csr, batch=8)
    >>> plan = store.get(key)            # None on miss/corruption
    >>> if plan is None:
    ...     plan = planner.plan(csr, batch=8)
    ...     store.put(key, plan)

    ``SpMVService(plan_store=...)`` does exactly this around every
    registration; :meth:`Planner.plan_or_load` does it for direct
    planning.  ``put`` also takes a plan's ``to_dict()`` payload.
    """

    def __init__(self, root: str, create: bool = True,
                 max_entries: Optional[int] = None):
        if max_entries is not None and int(max_entries) < 1:
            raise ValueError(
                f"max_entries must be >= 1 or None; got {max_entries}")
        self.root = str(root)
        self.max_entries = None if max_entries is None else int(max_entries)
        if create:
            os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.writes = 0
        self.quarantined = 0
        self.evictions = 0

    # -- keys + paths --------------------------------------------------------
    def key_for(self, csr_or_fp: Any, **knobs: Any) -> str:
        """Store key for a matrix (or a prebuilt fingerprint) under the
        given registration knobs."""
        from .plan import PlanFingerprint
        fp = (csr_or_fp if isinstance(csr_or_fp, PlanFingerprint)
              else PlanFingerprint.of(csr_or_fp))
        return fingerprint_key(fp, **knobs)

    def path_for(self, key: str) -> str:
        safe = "".join(c for c in key if c.isalnum() or c in "-_.")
        if not safe:
            raise ValueError(f"unusable store key {key!r}")
        return os.path.join(self.root, safe + ".json")

    def keys(self) -> Tuple[str, ...]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return ()
        return tuple(sorted(n[:-5] for n in names if n.endswith(".json")))

    def __len__(self) -> int:
        return len(self.keys())

    # -- write ---------------------------------------------------------------
    def put(self, key: str, plan: Any) -> str:
        """Serialize ``plan`` under ``key`` atomically; returns the final
        path.  Concurrent writers are safe: each writes its own temp file
        and the last ``os.replace`` wins whole."""
        payload = plan if isinstance(plan, dict) else plan.to_dict()
        envelope = {"store_version": STORE_VERSION,
                    "sha256": _sha256(_canonical(payload)),
                    "plan": payload}
        path = self.path_for(key)
        fd, tmp = tempfile.mkstemp(prefix=".tmp-", suffix=".json",
                                   dir=self.root)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(envelope, f, indent=1, allow_nan=False)
                f.write("\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)      # atomic publish
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            self.writes += 1
        tel = _obs.get()
        if tel.enabled:
            tel.counter("store.write").inc()
        # deterministic corruption hook: scribble over the entry we just
        # published so the *next* reader exercises checksum + quarantine
        from ..serve import faults as _faults
        if _faults.should_fire("store.corrupt"):
            with open(path, "r+") as f:
                f.seek(0)
                f.write('{"store_version": 1, "sha256": "corrupted')
        if self.max_entries is not None:
            self._evict(keep=path)
        return path

    def _evict(self, keep: Optional[str] = None) -> int:
        """LRU-by-mtime sweep down to ``max_entries``: hits refresh an
        entry's mtime, so the entries deleted first are the ones no
        replica has read or written recently.  ``keep`` (the just-written
        path) is never evicted even if a clock oddity makes it look old.
        Unlinked, not quarantined — eviction is capacity policy, not
        corruption forensics.  Returns the number of entries removed."""
        try:
            names = [n for n in os.listdir(self.root) if n.endswith(".json")]
        except OSError:
            return 0
        aged = []
        for n in names:
            p = os.path.join(self.root, n)
            try:
                aged.append((os.path.getmtime(p), p))
            except OSError:
                continue                   # raced a concurrent evictor
        excess = len(aged) - self.max_entries
        if excess <= 0:
            return 0
        tel = _obs.get()
        removed = 0
        for _, p in sorted(aged):
            if removed >= excess:
                break
            if p == keep:
                continue
            try:
                os.unlink(p)
            except OSError:
                continue                   # another writer won the race
            removed += 1
            if tel.enabled:
                tel.counter("store.evict").inc()
        with self._lock:
            self.evictions += removed
        return removed

    # -- read ----------------------------------------------------------------
    def get(self, key: str, fingerprint: Any = None) -> Optional[Any]:
        """Load and verify the entry under ``key``.  Returns the plan, or
        ``None`` when the key is absent **or** the entry is unusable —
        unusable entries are quarantined, never raised.  With a
        ``fingerprint`` the loaded plan must structurally match it (a
        stale entry for a different matrix is treated as a miss, not
        quarantined — it may be valid for its own matrix)."""
        path = self.path_for(key)
        tel = _obs.get()
        try:
            with open(path) as f:
                raw = f.read()
        except FileNotFoundError:
            with self._lock:
                self.misses += 1
            if tel.enabled:
                tel.counter("store.miss").inc()
            return None
        except OSError as e:
            with self._lock:
                self.misses += 1
            if tel.enabled:
                tel.counter("store.miss").inc()
                tel.event("store.read_error", key=key, error=repr(e))
            return None

        plan = self._verify(key, path, raw)
        if plan is None:
            with self._lock:
                self.misses += 1
            if tel.enabled:
                tel.counter("store.miss").inc()
            return None
        if fingerprint is not None:
            fp = getattr(plan, "fingerprint", None)
            if fp is None or not fp.matches(fingerprint):
                with self._lock:
                    self.misses += 1
                if tel.enabled:
                    tel.counter("store.miss").inc()
                return None
        with self._lock:
            self.hits += 1
        if tel.enabled:
            tel.counter("store.hit").inc()
        try:
            os.utime(path)       # refresh recency for the LRU evictor
        except OSError:
            pass                 # evicted/quarantined between read and touch
        return plan

    def _verify(self, key: str, path: str, raw: str) -> Optional[Any]:
        """Envelope → checksum → schema → lint; any failure quarantines."""
        from .plan import ExecutionPlan, PlanError, ShardedPlan
        try:
            env = json.loads(raw)
        except json.JSONDecodeError:
            return self._quarantine(key, path, "not_json")
        if not isinstance(env, dict) or "plan" not in env \
                or "sha256" not in env:
            return self._quarantine(key, path, "bad_envelope")
        if int(env.get("store_version", -1)) != STORE_VERSION:
            return self._quarantine(key, path, "store_version")
        payload = env["plan"]
        if not isinstance(payload, dict):
            return self._quarantine(key, path, "bad_payload")
        if _sha256(_canonical(payload)) != env["sha256"]:
            return self._quarantine(key, path, "checksum")
        try:
            if payload.get("kind") == "sharded_plan":
                plan = ShardedPlan.from_dict(payload)
            else:
                plan = ExecutionPlan.from_dict(payload)
        except PlanError:
            # PlanSchemaError included: written by a different plan
            # schema — stale, not servable by this build
            return self._quarantine(key, path, "schema")
        # schema-valid but semantically infeasible (misaligned geometry,
        # broken partition, over-budget tile): the static plan lint —
        # framework-free, so a store sweep never pays a backend import
        from ..analyze.planlint import lint_plan as _lint_plan
        if any(f.severity == "error" for f in _lint_plan(payload)):
            return self._quarantine(key, path, "lint")
        return plan

    def _quarantine(self, key: str, path: str, reason: str) -> None:
        """Move a bad entry aside (never delete — forensics) and report.
        Racing quarantines of the same file are tolerated."""
        bad_dir = os.path.join(self.root, BAD_DIR)
        try:
            os.makedirs(bad_dir, exist_ok=True)
            base = os.path.basename(path) + "." + reason
            dest = os.path.join(bad_dir, base)
            n = 0
            while os.path.exists(dest):
                n += 1
                dest = os.path.join(bad_dir, f"{base}.{n}")
            os.replace(path, dest)
        except OSError:
            pass                       # raced another quarantine; fine
        with self._lock:
            self.quarantined += 1
        tel = _obs.get()
        if tel.enabled:
            tel.counter("store.quarantine", reason=reason).inc()
        return None

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"root": self.root, "entries": len(self),
                    "hits": self.hits, "misses": self.misses,
                    "writes": self.writes,
                    "quarantined": self.quarantined,
                    "evictions": self.evictions,
                    "max_entries": self.max_entries}

    def __repr__(self) -> str:
        return (f"PlanStore(root={self.root!r}, entries={len(self)}, "
                f"hits={self.hits}, misses={self.misses})")


__all__ = ["STORE_VERSION", "BAD_DIR", "PlanStore", "fingerprint_key"]
