"""Telemetry exporters: event sinks, Prometheus text, trace validation.

Three consumption paths for one :class:`~repro_torch.obs.telemetry.Telemetry`:

* **JSONL event stream** (:class:`JsonlSink`) — every finished span and
  point event as one JSON object per line, written through as it
  happens (a crash keeps everything up to the last event).  This is the
  replay format ``python -m repro_torch.obs summarize`` reads, and the raw
  material for the ROADMAP's learned-cost-model and drift-detector
  items.
* **In-memory** (:class:`InMemorySink`) — the test double; also what a
  notebook uses to poke at a session's events.
* **Prometheus text exposition** (:func:`prometheus_text`) — counters,
  gauges, and cumulative ``le``-bucket histograms in the standard
  scrape format, for wiring a long-lived serving process
  into a fleet metrics pipeline.

:func:`validate_chrome_trace` is the schema check used by tests, the
CLI, and CI on exported Chrome traces.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, IO, List, Optional

from .tracing import as_jsonable


class InMemorySink:
    """Collects every emitted record; ``spans()``/``events()`` filter by
    record type, ``named(name)`` by event/span name."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def emit(self, rec: Dict[str, Any]) -> None:
        self.records.append(rec)

    def spans(self) -> List[Dict[str, Any]]:
        return [r for r in self.records if r.get("type") == "span"]

    def events(self) -> List[Dict[str, Any]]:
        return [r for r in self.records if r.get("type") == "event"]

    def named(self, name: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r.get("name") == name]

    def close(self) -> None:
        pass


class JsonlSink:
    """One JSON object per line, flushed per record.

    The file opens lazily on the first record (constructing a sink never
    touches the filesystem) and truncates — each process run is one
    fresh event log."""

    def __init__(self, path: str):
        self.path = path
        self._f: Optional[IO[str]] = None

    def emit(self, rec: Dict[str, Any]) -> None:
        if self._f is None:
            self._f = open(self.path, "w")
        self._f.write(json.dumps(rec, default=as_jsonable) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    """Load a JSONL event stream (skips blank lines, raises on corrupt
    ones with the offending line number)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: corrupt JSONL record: {e}") \
                    from e
    return out


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------
_PROM_NAME = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_TYPES = {"counter": "counter", "gauge": "gauge",
               "histogram": "histogram"}


def _prom_name(name: str) -> str:
    n = _PROM_NAME.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


def _prom_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{_prom_name(k)}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    return repr(float(v)) if v != int(v) else str(int(v))


def prometheus_text(tel: Any) -> str:
    """Standard text exposition of every registered metric.  Histograms
    emit cumulative ``le`` buckets (including ``+Inf``) plus ``_sum`` and
    ``_count``, so any Prometheus-compatible scraper ingests the same
    latency data ``stats()`` summarizes."""
    by_name: Dict[str, List] = {}
    kinds: Dict[str, str] = {}
    for kind, name, labels, m in tel.metrics():
        by_name.setdefault(name, []).append((labels, m))
        kinds[name] = kind
    lines: List[str] = []
    for name in sorted(by_name):
        kind = kinds[name]
        pname = _prom_name(name)
        lines.append(f"# TYPE {pname} {_PROM_TYPES[kind]}")
        for labels, m in by_name[name]:
            if kind in ("counter", "gauge"):
                lines.append(f"{pname}{_prom_labels(labels)} {_fmt(m.value)}")
                continue
            cum = 0
            for edge, c in zip(list(m.edges) + ["+Inf"], m.counts):
                cum += c
                le_v = "+Inf" if edge == "+Inf" else repr(float(edge))
                le = 'le="%s"' % le_v
                lines.append(f"{pname}_bucket{_prom_labels(labels, le)} "
                             f"{cum}")
            lines.append(f"{pname}_sum{_prom_labels(labels)} {_fmt(m.sum)}")
            lines.append(f"{pname}_count{_prom_labels(labels)} {m.count}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Chrome trace validation
# ---------------------------------------------------------------------------
def validate_chrome_trace(obj: Any) -> List[str]:
    """Schema check for an exported Chrome trace: returns a list of
    human-readable problems (empty = valid).  Checks the shape
    ``chrome://tracing``/Perfetto actually require: a ``traceEvents``
    array of complete events with string names, numeric ``ts``/``dur``,
    integer ``pid``/``tid``, and JSON-object ``args``."""
    errors: List[str] = []
    if not isinstance(obj, dict):
        return [f"top level must be an object, got {type(obj).__name__}"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing or non-array 'traceEvents'"]
    for i, ev in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"{where}: missing string 'name'")
        if ev.get("ph") not in ("X", "B", "E", "i", "C", "M"):
            errors.append(f"{where}: unknown phase {ev.get('ph')!r}")
        for k in ("ts",) + (("dur",) if ev.get("ph") == "X" else ()):
            if not isinstance(ev.get(k), (int, float)) \
                    or isinstance(ev.get(k), bool):
                errors.append(f"{where}: missing numeric {k!r}")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int) or isinstance(ev.get(k), bool):
                errors.append(f"{where}: missing integer {k!r}")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"{where}: 'args' must be an object")
        if errors[20:]:
            errors.append("... (truncated)")
            break
    return errors


def save_chrome_trace(tel: Any, path: str) -> None:
    """Dump a telemetry's spans as a Chrome trace JSON file."""
    with open(path, "w") as f:
        json.dump(tel.to_chrome_trace(), f, default=as_jsonable)


__all__ = ["InMemorySink", "JsonlSink", "read_jsonl", "prometheus_text",
           "validate_chrome_trace", "save_chrome_trace"]
