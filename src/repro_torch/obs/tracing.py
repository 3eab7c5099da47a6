"""Nested, attributed spans and their Chrome-trace export.

A span is one timed region (``tune.candidate``, ``transform``,
``service.flush``) with free-form attributes.  Spans nest per thread —
each completed span records the ``span_id`` of the span that was open
when it started — so a finished trace reconstructs the full call tree of
a tune sweep or a serving session.

Export target is the Chrome trace-event format (the ``traceEvents``
array of complete ``"ph": "X"`` events, microsecond timestamps), which
both ``chrome://tracing`` and Perfetto load directly; see
:func:`chrome_trace`.

This module is dependency-free (stdlib only) and knows nothing about the
rest of the library — :mod:`repro_torch.obs.telemetry` owns the clock and the
span stack and calls into it.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional


def as_jsonable(v: Any) -> Any:
    """Best-effort conversion of a span/event attribute to a
    JSON-serializable value (numpy scalars unwrap, ``to_dict``-able
    objects flatten, anything else falls back to ``repr``)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    item = getattr(v, "item", None)
    if callable(item) and not getattr(v, "shape", None):
        try:
            return item()          # numpy / torch scalar
        except (TypeError, ValueError):
            pass                   # .item() that isn't the numpy protocol
    to_dict = getattr(v, "to_dict", None)
    if callable(to_dict):
        try:
            return as_jsonable(to_dict())
        except (TypeError, ValueError, KeyError, AttributeError):
            pass                   # fall through to the repr() fallback
    if isinstance(v, dict):
        return {str(k): as_jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [as_jsonable(x) for x in v]
    return repr(v)


@dataclass
class Span:
    """One completed (or still-open) timed region."""
    name: str
    t_start: float
    attrs: Dict[str, Any] = field(default_factory=dict)
    span_id: int = 0
    parent_id: Optional[int] = None
    tid: int = 0
    t_end: Optional[float] = None

    @property
    def dur(self) -> float:
        return (self.t_end if self.t_end is not None else self.t_start) \
            - self.t_start

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes (usable inside the ``with`` block or right
        after it — export reads attrs at dump time)."""
        self.attrs.update(attrs)
        return self

    def to_record(self) -> Dict[str, Any]:
        """The JSONL event-sink form of this span."""
        return {
            "type": "span", "name": self.name, "ts": self.t_start,
            "dur": self.dur, "span_id": self.span_id,
            "parent_id": self.parent_id, "tid": self.tid,
            "attrs": {k: as_jsonable(v) for k, v in self.attrs.items()},
        }


class _NoopSpan:
    """Shared do-nothing span: what ``Telemetry.span`` hands back when
    telemetry is disabled, so instrumented code pays only the flag check."""
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class SpanContext:
    """The live context manager behind ``Telemetry.span`` (enabled path).

    Entering opens a :class:`Span` parented to the thread's innermost
    open span; exiting stamps the end time and hands the finished span to
    the telemetry registry (bounded buffer + sinks)."""
    __slots__ = ("_tel", "_name", "_attrs", "span")

    def __init__(self, tel: Any, name: str, attrs: Dict[str, Any]):
        self._tel = tel
        self._name = name
        self._attrs = attrs
        self.span: Optional[Span] = None

    def __enter__(self) -> Span:
        tel = self._tel
        stack = tel._span_stack()
        sp = Span(name=self._name, t_start=tel.clock(), attrs=self._attrs,
                  span_id=tel._next_id(),
                  parent_id=stack[-1].span_id if stack else None,
                  tid=threading.get_ident())
        stack.append(sp)
        self.span = sp
        return sp

    def __exit__(self, *exc: Any) -> bool:
        sp = self.span
        sp.t_end = self._tel.clock()
        stack = self._tel._span_stack()
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:          # misnested exit: heal the stack
            stack.remove(sp)
        self._tel._finish_span(sp)
        return False


def chrome_trace(spans: Iterable[Span], pid: Optional[int] = None
                 ) -> Dict[str, Any]:
    """Chrome trace-event JSON (``chrome://tracing`` / Perfetto loadable).

    Each span becomes one complete (``"ph": "X"``) event; ``ts``/``dur``
    are microseconds on the telemetry clock's (arbitrary but shared)
    origin.  ``args`` carries the span attributes plus the span/parent
    ids so the tree survives the flat encoding."""
    pid = int(pid if pid is not None else os.getpid())
    events: List[Dict[str, Any]] = []
    for s in spans:
        args = {k: as_jsonable(v) for k, v in s.attrs.items()}
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        events.append({
            "name": s.name,
            "cat": s.name.split(".", 1)[0],
            "ph": "X",
            "ts": s.t_start * 1e6,
            "dur": max(s.dur, 0.0) * 1e6,
            "pid": pid,
            "tid": int(s.tid),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


__all__ = ["Span", "SpanContext", "NOOP_SPAN", "chrome_trace",
           "as_jsonable"]
