"""Span-based tracing with Chrome-trace (Perfetto-loadable) export (port of
``repro/obs/trace.py``).

Design constraints, in order:

  1. **Free when off.** ``Tracer(enabled=False).span(...)`` returns a shared
     module-level null context manager — no allocation, no clock read, no
     lock. Hot loops can keep unconditional ``with tracer.span(...):`` lines.
  2. **Honest when on.** A span measures host wall time between ``__enter__``
     and ``__exit__`` on the tracer's clock. CUDA launches are asynchronous,
     so callers that want a span to mean "device phase time" synchronize
     the device *inside* the span (``device.synchronize``; see
     ``core/rounds.TracedRound``). The tracer itself never touches device
     state.
  3. **Bounded.** Spans land in a ring buffer (``capacity``); a long-running
     server keeps the most recent window instead of growing without bound.

Spans carry free-form tags. Two are special on export: ``role`` selects the
timeline row (host / drafter / target), ``phase`` becomes the event
category (draft / verify / commit / ...).
"""
from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs import clock as _clock

_US = 1e6  # chrome trace wants microseconds


@dataclass(frozen=True)
class Span:
    """One closed span. ``t0``/``t1`` are in the tracer's clock domain."""
    name: str
    t0: float
    t1: float
    depth: int
    thread: int
    tags: Dict[str, Any] = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    @property
    def duration(self) -> float:
        return 0.0


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    __slots__ = ("_tracer", "name", "tags", "t0", "t1", "depth")

    def __init__(self, tracer: "Tracer", name: str, tags: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.tags = tags
        self.t0 = 0.0
        self.t1 = 0.0
        self.depth = 0

    def __enter__(self) -> "_LiveSpan":
        tr = self._tracer
        self.depth = tr._enter_depth()
        self.t0 = tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        self.t1 = tr.clock()
        tr._exit_depth()
        tr._record(self)
        return False

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Thread-safe ring-buffered span collector with an injectable clock."""

    def __init__(self, enabled: bool = True, capacity: int = 65536,
                 clock: Optional[Callable[[], float]] = None):
        self.enabled = bool(enabled)
        self.clock = clock if clock is not None else _clock.perf
        self._spans: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._depths = threading.local()

    # ------------------------------------------------------------- recording
    def span(self, name: str, **tags):
        """Open a span. Use as ``with tracer.span("draft", phase="draft"):``.
        Returns a shared null object when disabled (no allocation)."""
        if not self.enabled:
            return _NULL_SPAN
        return _LiveSpan(self, name, tags)

    def _enter_depth(self) -> int:
        d = getattr(self._depths, "v", 0)
        self._depths.v = d + 1
        return d

    def _exit_depth(self):
        self._depths.v = getattr(self._depths, "v", 1) - 1

    def _record(self, live: _LiveSpan):
        span = Span(live.name, live.t0, live.t1, live.depth,
                    threading.get_ident(), live.tags)
        with self._lock:
            self._spans.append(span)

    # --------------------------------------------------------------- queries
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self):
        with self._lock:
            self._spans.clear()

    def _matches(self, s: Span, match: Dict[str, Any]) -> bool:
        for k, v in match.items():
            if k == "name":
                if s.name != v:
                    return False
            elif s.tags.get(k) != v:
                return False
        return True

    def total(self, **match) -> float:
        """Summed duration of spans whose name/tags equal all of ``match``."""
        return sum(s.duration for s in self.spans() if self._matches(s, match))

    def count(self, **match) -> int:
        return sum(1 for s in self.spans() if self._matches(s, match))

    def phase_totals(self) -> Dict[str, float]:
        """Summed duration per ``phase`` tag — the per-phase breakdown."""
        out: Dict[str, float] = {}
        for s in self.spans():
            phase = s.tags.get("phase")
            if phase is not None:
                out[phase] = out.get(phase, 0.0) + s.duration
        return out

    # ---------------------------------------------------------------- export
    def to_chrome_trace(self) -> dict:
        """Chrome-trace JSON object (load in chrome://tracing or Perfetto).

        Rows (tids) are the span ``role`` tags, named via "M" metadata
        events; each span is one complete "X" event with its tags as args.
        """
        rows: Dict[str, int] = {}
        events = []
        for s in self.spans():
            role = str(s.tags.get("role") or "host")
            tid = rows.setdefault(role, len(rows))
            events.append({
                "name": s.name,
                "ph": "X",
                "pid": 0,
                "tid": tid,
                "ts": s.t0 * _US,
                "dur": max(s.duration, 0.0) * _US,
                "cat": str(s.tags.get("phase") or s.name),
                "args": {k: v for k, v in s.tags.items() if v is not None},
            })
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": role}} for role, tid in rows.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, default=str)
        return path


#: Shared disabled tracer — the default everywhere a tracer is optional, so
#: call sites never branch on ``tracer is not None``.
NULL_TRACER = Tracer(enabled=False, capacity=1)
