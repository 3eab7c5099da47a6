"""repro_torch.stream — dynamic matrices for the tuned serving stack.

Production matrices mutate: graph edges arrive, KV pages fill, MoE
routing shifts.  This package keeps the paper's run-time-transformation
economics honest under mutation:

* :mod:`repro_torch.stream.delta` — :class:`DeltaBatch` edits applied to
  CSR and SELL containers **incrementally** (O(Δnnz) tail appends,
  per-bucket SELL rebuilds) with a validated full-re-transform fallback
  for every other format;
* :mod:`repro_torch.stream.drift` — an O(Δ)-updatable (mu, sigma, D_mat)
  sketch, the hysteresis + streaming-amortization re-plan trigger, and
  :class:`StreamingPlannedMatrix` gluing both onto a bound plan;
* :mod:`repro_torch.stream.capture` / :mod:`repro_torch.stream.replay` —
  JSONL workload traces recorded at serve time and replayed through
  ``offline_phase`` so tuning sees the real access pattern.

See ``docs/streaming.md`` for the delta schema, drift rule, and
amortized accounting (the JAX package's; the artifacts interchange).
On the card every edit runs there: a delta never copies the matrix
between host and card.
"""
from .capture import TRACE_VERSION, TraceCapture, load_trace
from .delta import (DELTA_SCHEMA_VERSION, INCREMENTAL_FORMATS, DeltaBatch,
                    DeltaApplyResult, apply_delta, random_delta,
                    sell_apply)
from .drift import (HIST_BUCKETS, STREAM_PLAN_SCHEMA_VERSION, DriftDecision,
                    DriftSketch, ReplanPolicy, StreamingPlannedMatrix)
from .replay import ReplayStats, epochs_of, replay, replay_file

__all__ = [
    "DELTA_SCHEMA_VERSION", "INCREMENTAL_FORMATS", "DeltaBatch",
    "DeltaApplyResult", "apply_delta", "random_delta", "sell_apply",
    "HIST_BUCKETS", "STREAM_PLAN_SCHEMA_VERSION", "DriftDecision",
    "DriftSketch", "ReplanPolicy", "StreamingPlannedMatrix",
    "TRACE_VERSION", "TraceCapture", "load_trace",
    "ReplayStats", "epochs_of", "replay", "replay_file",
]
