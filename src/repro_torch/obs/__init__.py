"""repro_torch.obs — the observability substrate for tune → plan → serve.

One process-wide :class:`Telemetry` (counters, gauges, fixed-bucket
latency histograms, nested spans, point events) that the whole pipeline
reports into:

* ``KernelTuner`` — one span per candidate launch, a ``tune.winner``
  event per sweep (geometry + measured time);
* ``offline_phase`` / the ``decide_*`` rules / ``Planner`` — t_trans,
  t_crs, t_f per (matrix, format) and a ``plan.decision`` event naming
  the rule that fired, so every decision is a replayable point on the
  paper's D_mat–R graph;
* ``transform`` — a span per CRS→{COO,ELL,SELL,BCSR,CCS,hybrid} host
  conversion;
* ``dispatch`` — kernel-tier vs reference-tier resolution counters;
* ``SpMVService`` — per-key query-latency histograms, queue-depth
  gauges, flush-cause counters, plan-replay hit/miss.

Telemetry is **off by default** — the hot path pays one flag check.
Enable programmatically::

    from repro_torch import obs
    sink = obs.InMemorySink()
    obs.enable(sink=sink)                  # or obs.enable(jsonl="run.jsonl")
    ... run the pipeline ...
    obs.get().snapshot()                   # the metrics dump
    obs.get().to_chrome_trace()            # chrome://tracing / Perfetto

or from the environment — ``REPRO_TRACE=<prefix>`` enables telemetry and,
at interpreter exit, leaves ``<prefix>.jsonl`` (event stream, written
through as it happens), ``<prefix>.trace.json`` (Chrome trace), and
``<prefix>.metrics.json`` (metrics snapshot).  ``REPRO_TELEMETRY=1``
enables collection with no files.

``python -m repro_torch.obs`` summarizes event streams and pretty-prints/diffs
saved ``ExecutionPlan`` JSON.  See ``docs/observability.md`` for the
full event vocabulary.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from .export import (InMemorySink, JsonlSink, prometheus_text, read_jsonl,
                     save_chrome_trace, validate_chrome_trace)
from .telemetry import (DEFAULT_LATENCY_EDGES, Counter, FakeClock, Gauge,
                        Histogram, Telemetry, format_metric, percentile)
from .tracing import NOOP_SPAN, Span, as_jsonable, chrome_trace

_default: Optional[Telemetry] = None
_default_lock = threading.Lock()


def get() -> Telemetry:
    """The process-wide default telemetry (created on first use; honours
    ``REPRO_TRACE`` / ``REPRO_TELEMETRY`` — see the module docstring)."""
    tel = _default
    if tel is None:
        with _default_lock:
            tel = _default
            if tel is None:
                tel = _from_env()
                _set(tel)
    return tel


def _set(tel: Telemetry) -> None:
    global _default
    _default = tel


def set_default(tel: Optional[Telemetry]) -> Optional[Telemetry]:
    """Swap the process-wide telemetry (``None`` resets to lazy env
    bootstrap); returns the previous one so tests can restore it."""
    with _default_lock:
        prev = _default
        _set(tel)
        return prev


def enable(sink: Any = None, jsonl: Optional[str] = None,
           clock: Any = None) -> Telemetry:
    """Turn the default telemetry on (optionally attaching a sink, a
    JSONL path, or a replacement clock) and return it."""
    tel = get()
    tel.enabled = True
    if clock is not None:
        tel.clock = clock
    if sink is not None:
        tel.sinks.append(sink)
    if jsonl is not None:
        tel.sinks.append(JsonlSink(jsonl))
    return tel


def disable() -> Telemetry:
    tel = get()
    tel.enabled = False
    return tel


def enabled() -> bool:
    return get().enabled


# -- delegating conveniences (what instrumented modules call) ---------------
def span(name: str, **attrs: Any):
    return get().span(name, **attrs)


def event(name: str, **attrs: Any) -> Optional[Dict[str, Any]]:
    return get().event(name, **attrs)


def counter(name: str, **labels: Any) -> Counter:
    return get().counter(name, **labels)


def gauge(name: str, **labels: Any) -> Gauge:
    return get().gauge(name, **labels)


def histogram(name: str, **labels: Any) -> Histogram:
    return get().histogram(name, **labels)


def _from_env() -> Telemetry:
    import os
    prefix = os.environ.get("REPRO_TRACE", "")
    flag = os.environ.get("REPRO_TELEMETRY", "")
    tel = Telemetry(enabled=bool(prefix) or flag not in ("", "0"))
    if prefix:
        import atexit
        import json
        tel.sinks.append(JsonlSink(prefix + ".jsonl"))

        def _dump(tel: Telemetry = tel, prefix: str = prefix) -> None:
            with open(prefix + ".trace.json", "w") as f:
                json.dump(tel.to_chrome_trace(), f, default=as_jsonable)
            with open(prefix + ".metrics.json", "w") as f:
                json.dump(tel.snapshot(), f, default=as_jsonable, indent=1)
            tel.close()

        atexit.register(_dump)
    return tel


__all__ = [
    # registry + primitives
    "Telemetry", "Counter", "Gauge", "Histogram", "FakeClock",
    "DEFAULT_LATENCY_EDGES", "Span", "NOOP_SPAN",
    # process-wide default + conveniences
    "get", "set_default", "enable", "disable", "enabled",
    "span", "event", "counter", "gauge", "histogram",
    # export
    "InMemorySink", "JsonlSink", "read_jsonl", "prometheus_text",
    "chrome_trace", "save_chrome_trace", "validate_chrome_trace",
    "as_jsonable", "format_metric", "percentile",
]
