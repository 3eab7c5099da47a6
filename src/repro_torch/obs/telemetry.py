"""Process-wide telemetry registry: counters, gauges, histograms, spans.

The paper's whole method runs on measured quantities — t_trans, t_crs,
t_f, and the D_mat–R graph built from them — so the library's own
measurements must be first-class data, not local variables that die at
function exit.  :class:`Telemetry` is that substrate: a dependency-free
(stdlib-only) registry the tune → plan → serve pipeline reports into.

Design points:

* **Default-off.**  ``Telemetry.enabled`` gates everything; disabled
  calls cost one attribute check (``span`` returns a shared no-op
  context manager, metric mutation is skipped at the call site), so the
  SpMV hot path pays well under 1% overhead.
* **Injectable clock.**  ``clock()`` returns seconds (default
  ``time.perf_counter``); :class:`FakeClock` makes span durations and
  deadline logic deterministic under test.
* **Fixed-bucket histograms.**  Latency histograms use a 1–2–5 ladder
  (:data:`DEFAULT_LATENCY_EDGES`), mergeable across processes and
  exportable as Prometheus text (:func:`repro_torch.obs.export.prometheus_text`).
* **Bounded buffers.**  Spans/events past ``max_records`` are dropped
  (and counted) rather than growing without bound in a long-lived
  service.
"""
from __future__ import annotations

import bisect
import collections
import itertools
import math
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from .tracing import NOOP_SPAN, Span, SpanContext, chrome_trace

#: 1–2–5 ladder from 1 µs to 50 s — wide enough for a host transform on a
#: large matrix and fine enough to separate a tuned from an untuned launch
DEFAULT_LATENCY_EDGES: Tuple[float, ...] = tuple(
    m * (10.0 ** e) for e in range(-6, 2) for m in (1.0, 2.0, 5.0))


class FakeClock:
    """Deterministic clock for tests: returns ``start`` and advances by
    ``tick`` per call; ``advance(dt)`` jumps time explicitly (the fake
    analogue of a sleep)."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self.t = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        t = self.t
        self.t += self.tick
        return t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


class Counter:
    """Monotonically increasing count."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def to_dict(self) -> Dict[str, Any]:
        return {"value": self.value}


class Gauge:
    """Last-set value (queue depth, cache size)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def to_dict(self) -> Dict[str, Any]:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram (Prometheus ``le`` semantics: bucket ``i``
    counts observations ``edges[i-1] < v <= edges[i]``; one overflow
    bucket past the last edge)."""
    __slots__ = ("edges", "counts", "sum", "count")

    def __init__(self, edges: Sequence[float] = DEFAULT_LATENCY_EDGES):
        es = tuple(sorted(float(e) for e in edges))
        if not es:
            raise ValueError("histogram needs at least one bucket edge")
        if len(set(es)) != len(es):
            raise ValueError(f"duplicate bucket edges: {edges}")
        self.edges = es
        self.counts = [0] * (len(es) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (exact only up to bucket
        resolution; the overflow bucket clamps to the last edge)."""
        if not self.count:
            return float("nan")
        target = min(max(q, 0.0), 1.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if c and cum >= target:
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i] if i < len(self.edges) else self.edges[-1]
                frac = (target - (cum - c)) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.edges[-1]

    def summary(self) -> Dict[str, float]:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}

    def to_dict(self) -> Dict[str, Any]:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "sum": self.sum, "count": self.count}


Labels = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> Labels:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def format_metric(name: str, labels: Dict[str, str]) -> str:
    """Canonical ``name{k=v,...}`` display key (no braces when bare)."""
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class Telemetry:
    """The registry.  One process-wide default lives behind
    :func:`repro_torch.obs.get`; tests construct their own with a
    :class:`FakeClock` and an in-memory sink.

    ``sinks`` receive every finished span and point event as a dict
    record (see :mod:`repro_torch.obs.export`); sink failures are counted, not
    raised — telemetry must never take down the serving path."""

    def __init__(self, enabled: bool = False,
                 clock: Optional[Callable[[], float]] = None,
                 sinks: Sequence[Any] = (),
                 max_records: int = 100_000,
                 latency_edges: Sequence[float] = DEFAULT_LATENCY_EDGES):
        self.enabled = bool(enabled)
        self.clock = clock if clock is not None else time.perf_counter
        self.sinks: List[Any] = list(sinks)
        self.max_records = int(max_records)
        self.latency_edges = tuple(latency_edges)
        self.spans: List[Span] = []
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self.sink_errors = 0
        self._metrics: Dict[Tuple[str, str, Labels], Any] = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        # finished spans not yet handed to the sinks, oldest first
        self._unsent: collections.deque = collections.deque()
        self._send_lock = threading.Lock()

    # -- metrics -------------------------------------------------------------
    def _metric(self, kind: str, cls: type, name: str,
                labels: Dict[str, Any], *args: Any) -> Any:
        key = (kind, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = self._metrics[key] = cls(*args)
        return m

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._metric("counter", Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._metric("gauge", Gauge, name, labels)

    def histogram(self, name: str,
                  edges: Optional[Sequence[float]] = None,
                  **labels: Any) -> Histogram:
        return self._metric("histogram", Histogram, name, labels,
                            edges if edges is not None
                            else self.latency_edges)

    def metrics(self, name: Optional[str] = None,
                kind: Optional[str] = None
                ) -> Iterator[Tuple[str, str, Dict[str, str], Any]]:
        """Iterate ``(kind, name, labels, metric)`` over the registry."""
        with self._lock:
            items = list(self._metrics.items())
        for (k, n, lab), m in items:
            if (name is None or n == name) and (kind is None or k == kind):
                yield k, n, dict(lab), m

    def snapshot(self) -> Dict[str, Any]:
        """All metrics as one JSON-ready dict (the "metrics dump"):
        ``{"counters": {key: value}, "gauges": {...}, "histograms":
        {key: summary+buckets}}`` plus span/event bookkeeping."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for kind, name, labels, m in self.metrics():
            key = format_metric(name, labels)
            if kind == "histogram":
                d = m.summary()
                d["buckets"] = [[e, c] for e, c in
                                zip(list(m.edges) + ["+Inf"], m.counts)]
                out["histograms"][key] = d
            else:
                out[kind + "s"][key] = m.value
        out["spans"] = len(self.spans)
        out["events"] = len(self.events)
        out["dropped"] = self.dropped
        return out

    # -- spans + events ------------------------------------------------------
    def span(self, name: str, on: Any = None, **attrs: Any):
        """Context manager timing a region; no-op when disabled.  The
        yielded :class:`Span` accepts ``.set(**attrs)``.

        With ``on`` (a tensor or a device) the span is over work the card
        does for it, timed by two CUDA timing events on the device's
        current stream: ``dur`` is the card's time from the work enqueued
        before the span to the last work enqueued inside it, resolved when
        first read.  Nothing synchronizes and nothing is launched.  On a
        CPU tensor, or with a :class:`FakeClock`, it is a host span."""
        if not self.enabled:
            return NOOP_SPAN
        dev = getattr(on, "device", on)
        if getattr(dev, "type", None) != "cuda" \
                or isinstance(self.clock, FakeClock):
            return SpanContext(self, name, attrs)
        # a CUDA device exists only where the program has loaded torch
        cuda = sys.modules["torch"].cuda
        return SpanContext(self, name, attrs, cuda.current_stream(dev))

    def event(self, name: str, **attrs: Any) -> Optional[Dict[str, Any]]:
        """Point event (a tune winner, a plan decision, a flush), parented
        to the innermost open span; no-op when disabled."""
        if not self.enabled:
            return None
        stack = self._span_stack()
        rec = {"type": "event", "name": name, "ts": self.clock(),
               "span_id": stack[-1].span_id if stack else None,
               "attrs": attrs}
        self._append(self.events, rec)
        self._emit(rec if not self.sinks else _jsonable_record(rec))
        return rec

    def _span_stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _next_id(self) -> int:
        return next(self._ids)

    def _finish_span(self, sp: Span) -> None:
        self._append(self.spans, sp)
        if self.sinks:
            with self._send_lock:
                self._unsent.append(sp)
                self._send(wait=False)

    def _send(self, wait: bool) -> None:
        """Hand finished spans to the sinks in the order they finished, a
        device span once the card has passed its end (``wait``: every one,
        waiting for the card)."""
        q = self._unsent
        while q and (wait or q[0].ready()):
            self._emit(q.popleft().to_record())

    def _append(self, buf: List[Any], item: Any) -> None:
        if len(buf) >= self.max_records:
            self.dropped += 1
            return
        buf.append(item)

    def _emit(self, rec: Dict[str, Any]) -> None:
        for s in self.sinks:
            try:
                s.emit(rec)
            except Exception:
                self.sink_errors += 1

    # -- export + lifecycle --------------------------------------------------
    def to_chrome_trace(self) -> Dict[str, Any]:
        return chrome_trace(self.spans)

    def reset(self) -> None:
        """Clear all metrics, spans, and events (sinks keep what they
        already received)."""
        with self._lock:
            self._metrics.clear()
        self.spans = []
        self.events = []
        self.dropped = 0
        self.sink_errors = 0

    def close(self) -> None:
        with self._send_lock:
            self._send(wait=True)
        for s in self.sinks:
            close = getattr(s, "close", None)
            if callable(close):
                try:
                    close()
                except Exception:
                    self.sink_errors += 1


def _jsonable_record(rec: Dict[str, Any]) -> Dict[str, Any]:
    from .tracing import as_jsonable
    out = dict(rec)
    out["attrs"] = {k: as_jsonable(v) for k, v in rec["attrs"].items()}
    return out


def percentile(values: Sequence[float], q: float) -> float:
    """Exact linear-interpolated percentile of raw samples (the CLI's
    summarizer works on exact span durations, not bucket estimates)."""
    vs = sorted(float(v) for v in values)
    if not vs:
        return float("nan")
    if len(vs) == 1:
        return vs[0]
    pos = min(max(q, 0.0), 1.0) * (len(vs) - 1)
    lo = math.floor(pos)
    frac = pos - lo
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] * (1 - frac) + vs[hi] * frac


__all__ = [
    "DEFAULT_LATENCY_EDGES", "FakeClock", "Counter", "Gauge", "Histogram",
    "Telemetry", "format_metric", "percentile",
]
