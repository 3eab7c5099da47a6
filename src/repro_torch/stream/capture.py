"""Workload capture: record query/update traces as JSONL.

The trace format rides the ``repro_torch.obs`` JSONL conventions (one JSON
object per line, ``read_jsonl``-loadable) so the same tooling that reads
telemetry streams reads workload traces.  Three record kinds:

* ``stream.base``  — the matrix a trace starts from (shape + nnz, for
  replay sanity checks)
* ``stream.query`` — one ``P @ x`` arrival (op + batch width)
* ``stream.delta`` — one :class:`~repro_torch.stream.delta.DeltaBatch`,
  embedded in its JSON form

Timestamps come from an injectable clock (default
``time.perf_counter``) so tests capture with
:class:`repro_torch.obs.FakeClock` deterministically.  See
:mod:`repro_torch.stream.replay` for the consuming side.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..obs import read_jsonl

from .delta import DeltaBatch

#: trace format version, stamped on every record
TRACE_VERSION = 1


class TraceCapture:
    """Append-only JSONL workload trace recorder.

    >>> with TraceCapture("/tmp/trace.jsonl") as cap:
    ...     cap.base("web", csr)
    ...     cap.query("web", batch=8)
    ...     cap.delta("web", delta)

    Attach to a :class:`~repro_torch.stream.drift.StreamingPlannedMatrix` via
    ``capture=`` and every apply/query records itself.
    """

    def __init__(self, path: str,
                 clock: Optional[Callable[[], float]] = None):
        self.path = str(path)
        self.clock = clock if clock is not None else time.perf_counter
        self._f = open(self.path, "a")
        self._lock = threading.Lock()
        self.records = 0
        self.dropped = 0

    def _write(self, rec: Dict[str, Any]) -> None:
        # capture rides the serving path: a closed or failing trace file
        # drops the record (counted), it never takes down a query — the
        # same discipline repro.obs applies to its sinks
        with self._lock:
            if self._f.closed:
                self.dropped += 1
                return
            try:
                json.dump(rec, self._f, sort_keys=True)
                self._f.write("\n")
                self._f.flush()
            except (OSError, ValueError):
                self.dropped += 1
                return
            self.records += 1

    # -- record kinds ---------------------------------------------------------
    def base(self, key: str, csr: Any) -> None:
        self._write({"kind": "stream.base", "v": TRACE_VERSION,
                     "t": float(self.clock()), "key": key,
                     "n_rows": int(csr.n_rows), "n_cols": int(csr.n_cols),
                     "nnz": int(csr.nnz)})

    def query(self, key: str, batch: int = 1, op: str = "spmv") -> None:
        self._write({"kind": "stream.query", "v": TRACE_VERSION,
                     "t": float(self.clock()), "key": key,
                     "op": op, "batch": int(batch)})

    def delta(self, key: str, delta: DeltaBatch) -> None:
        self._write({"kind": "stream.delta", "v": TRACE_VERSION,
                     "t": float(self.clock()), "key": key,
                     "delta": delta.to_dict()})

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __enter__(self) -> "TraceCapture":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
        return None


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Load a captured trace, sorted by timestamp (records from several
    concurrent captures interleave correctly)."""
    recs = [r for r in read_jsonl(path)
            if r.get("kind", "").startswith("stream.")]
    return sorted(recs, key=lambda r: float(r.get("t", 0.0)))


__all__ = ["TRACE_VERSION", "TraceCapture", "load_trace"]
