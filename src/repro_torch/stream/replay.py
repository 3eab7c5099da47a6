"""Replay captured workload traces through the off-line tuning phase.

A trace from :class:`~repro_torch.stream.capture.TraceCapture` is a faithful
record of how one matrix actually evolved and was queried.  Replaying it
reconstructs every matrix *epoch* (the state between two deltas that
served at least one query) and hands those epochs to
:func:`repro_torch.core.autotune.offline_phase` as the measurement suite — so
format thresholds and launch geometry are tuned against the real access
pattern instead of a synthetic sweep, and the observed query/update ratio
(k̂) prices the streaming amortization rule with data.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core.formats import CSR
from ..device import DeviceLike

from .capture import load_trace
from .delta import DeltaBatch, apply_delta


def _snapshot(m: CSR) -> CSR:
    return CSR(data=m.data.clone(), cols=m.cols.clone(),
               indptr=m.indptr.clone(), shape=m.shape, nnz=m.nnz)


@dataclass
class ReplayStats:
    """What the replay saw, for the drift layer's priors."""

    key: str = ""
    n_records: int = 0
    n_queries: int = 0
    n_deltas: int = 0
    n_epochs: int = 0
    dropped_epochs: int = 0          #: epochs over ``max_epochs``, skipped
    k_hat: float = 0.0               #: mean queries per epoch
    batch: int = 1                   #: modal query batch width
    batches: Dict[int, int] = field(default_factory=dict)


def epochs_of(trace: Sequence[Dict[str, Any]], base: CSR,
              key: Optional[str] = None
              ) -> Tuple[List[Tuple[str, CSR, int]], ReplayStats]:
    """Reconstruct the queried matrix epochs of one key's trace.

    Returns ``([(name, csr, n_queries), ...], stats)`` — only epochs that
    served at least one query become suite entries (a burst of deltas with
    no reads between them collapses into one epoch)."""
    if key is None:
        for r in trace:
            if "key" in r:
                key = str(r["key"])
                break
        else:
            key = ""
    cur = _snapshot(base)
    epochs: List[Tuple[str, CSR, int]] = []
    stats = ReplayStats(key=key)
    q_in_epoch = 0

    def close_epoch() -> None:
        nonlocal q_in_epoch
        if q_in_epoch:
            epochs.append((f"{key}@e{len(epochs)}", _snapshot(cur),
                           q_in_epoch))
            q_in_epoch = 0

    for rec in trace:
        if rec.get("key") not in (None, key):
            continue
        stats.n_records += 1
        kind = rec.get("kind")
        if kind == "stream.base":
            if (int(rec.get("n_rows", base.n_rows)) != base.n_rows
                    or int(rec.get("n_cols", base.n_cols)) != base.n_cols):
                raise ValueError(
                    f"trace base {rec.get('n_rows')}x{rec.get('n_cols')} "
                    f"does not match the provided matrix {base.shape}")
        elif kind == "stream.query":
            q_in_epoch += 1
            stats.n_queries += 1
            b = int(rec.get("batch", 1))
            stats.batches[b] = stats.batches.get(b, 0) + 1
        elif kind == "stream.delta":
            close_epoch()
            delta = DeltaBatch.from_dict(rec["delta"])
            cur = apply_delta(cur, delta, fmt="csr").csr
            stats.n_deltas += 1
    close_epoch()

    stats.n_epochs = len(epochs)
    stats.k_hat = stats.n_queries / max(stats.n_epochs, 1)
    if stats.batches:
        stats.batch = Counter(stats.batches).most_common(1)[0][0]
    return epochs, stats


def replay(trace: Sequence[Dict[str, Any]], base: CSR, *,
           key: Optional[str] = None, max_epochs: int = 16,
           device: DeviceLike = None,
           **offline_kw) -> Tuple[Any, ReplayStats]:
    """Feed a trace's queried epochs through ``offline_phase``.

    ``offline_kw`` forwards to
    :func:`repro_torch.core.autotune.offline_phase` (``formats``, ``iters``,
    ``machine``, ...); ``batch`` defaults to the trace's modal query
    width.  At most ``max_epochs`` epochs are measured — the heaviest-
    queried ones, so the tuner spends its budget where traffic was — and
    ``stats.dropped_epochs`` reports what the cap skipped.  The deltas are
    applied on ``base``'s device; the epochs are timed on ``device``
    (``None`` = the CUDA card)."""
    from ..core.autotune import offline_phase
    epochs, stats = epochs_of(trace, base, key=key)
    if not epochs:
        raise ValueError("trace contains no queried epochs to replay")
    if len(epochs) > max_epochs:
        keep = sorted(sorted(range(len(epochs)),
                             key=lambda i: -epochs[i][2])[:max_epochs])
        stats.dropped_epochs = len(epochs) - len(keep)
        epochs = [epochs[i] for i in keep]
    suite = [(name, csr) for name, csr, _ in epochs]
    offline_kw.setdefault("batch", stats.batch)
    db = offline_phase(suite, device=device, **offline_kw)
    return db, stats


def replay_file(path: str, base: CSR, **kw) -> Tuple[Any, ReplayStats]:
    """``replay`` straight from a trace file on disk."""
    return replay(load_trace(path), base, **kw)


__all__ = ["ReplayStats", "epochs_of", "replay", "replay_file"]
