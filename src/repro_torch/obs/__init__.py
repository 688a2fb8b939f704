"""Structured telemetry for the port's speculative-decoding stack (port of
``repro/obs``). Three cooperating pieces, all host-side:

  * ``trace``  — span-based tracing with Chrome-trace/Perfetto export, so a
    served workload renders as a draft/verify/commit timeline.
  * ``events`` — a typed per-round event log (RoundEvent) that subsumes the
    round-level counters in ``serving/metrics.py`` and streams to JSONL.
  * ``drift``  — an online predicted-vs-measured monitor of the cost model:
    each measured round is compared against the ``cost_model.round_time``
    terms, and its measured c feeds the paged server's gamma decision.

``clock`` is the ONE module of ``src/repro_torch`` that reads wall/perf
clocks; everything else takes an injectable clock so tests can drive time.
"""
from repro_torch.obs.drift import DriftConfig, DriftMonitor
from repro_torch.obs.events import RoundEvent, RoundEventLog
from repro_torch.obs.trace import NULL_TRACER, Span, Tracer

__all__ = [
    "DriftConfig",
    "DriftMonitor",
    "NULL_TRACER",
    "RoundEvent",
    "RoundEventLog",
    "Span",
    "Tracer",
]
