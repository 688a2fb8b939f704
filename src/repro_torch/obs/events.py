"""Typed per-round event log for speculative serving (port of
``repro/obs/events.py``).

``RoundEvent`` is the unit of record: one speculative (or AR) round, with
what the scheduler decided (gamma), what the verify did (per-row accepted
draft tokens), what it cost (host wall time, per-phase times when the run
is traced) and what it moved (KV blocks read / written).
``RoundEventLog.alpha_hat()`` reproduces ``ServingMetrics.alpha_hat()``
exactly (the same per-row EMA). ``degraded`` marks a round of a batch the
fault plan or the watchdog turned to AR, and ``fault_delay`` the virtual
straggle the fault plan added to ``t_round``; ``t_handoff`` stays None, as
JAX's server leaves it.

Events stream to JSONL (``stream_to`` for online appends, ``to_jsonl`` for
a post-hoc dump), one JSON object per line.
"""
from __future__ import annotations

import json
from collections import deque
from dataclasses import asdict, dataclass
from typing import IO, Dict, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class RoundEvent:
    round: int                   # global round index within the run
    gamma: int                   # draft length this round (0 == AR round)
    n_active: int                # live rows this round
    accepted: Tuple[int, ...]    # per live row: accepted draft tokens
    emitted: int                 # committed tokens incl. bonus, summed
    t_round: float               # host wall seconds, dispatch -> sync
    t_draft: Optional[float] = None    # phase times: only on traced runs
    t_verify: Optional[float] = None
    t_commit: Optional[float] = None
    t_handoff: Optional[float] = None  # cross-device transfer (placed)
    blocks_read: int = 0         # KV blocks touched by reads this round
    blocks_written: int = 0      # KV blocks touched by writes (estimate)
    rids: Tuple[int, ...] = ()   # request ids of the live rows
    t_wall: float = 0.0          # wall-clock timestamp (epoch s)
    queue_depth: int = 0         # requests waiting in the scheduler queue
                                 # while this round ran
    n_preempted: int = 0         # rows evicted + re-queued this round
    n_expired: int = 0           # queued requests expired at admission
    n_failed: int = 0            # requests failed terminally this round
    degraded: bool = False       # batch running AR after a fault
    fault_delay: float = 0.0     # injected virtual straggle in t_round
    prefill_tokens: int = 0      # suffix tokens prefilled this step
    prefill_chunks: int = 0      # chunk programs run this step
    t_prefill: Optional[float] = None  # host seconds spent in chunk programs
    prefix_hit_rate: Optional[float] = None  # running prefix-cache hit rate

    @property
    def alpha_round(self) -> Optional[float]:
        """Mean per-row acceptance rate for this round; None for AR rounds."""
        if self.gamma <= 0 or not self.accepted:
            return None
        return float(np.mean([a / self.gamma for a in self.accepted]))

    def to_json(self) -> str:
        return json.dumps(asdict(self), default=float)


class RoundEventLog:
    """Ring-buffered RoundEvent collector with optional JSONL streaming."""

    def __init__(self, capacity: int = 65536, alpha_ema: float = 0.9,
                 stream: Optional[IO[str]] = None):
        self.alpha_ema = alpha_ema
        self._events: deque = deque(maxlen=int(capacity))
        self._alpha: Optional[float] = None
        self._stream = stream
        self.n_rounds = 0
        self.n_spec_rounds = 0
        self.total_emitted = 0

    # ------------------------------------------------------------- recording
    def record(self, ev: RoundEvent):
        self._events.append(ev)
        self.n_rounds += 1
        self.total_emitted += ev.emitted
        if ev.gamma > 0:
            self.n_spec_rounds += 1
            # same per-row EMA as ServingMetrics.alpha_hat(): each live row
            # contributes one observation acc/gamma, unclamped
            for acc in ev.accepted:
                alpha_round = max(float(acc), 0.0) / ev.gamma
                self._alpha = (alpha_round if self._alpha is None else
                               self.alpha_ema * self._alpha
                               + (1 - self.alpha_ema) * alpha_round)
        if self._stream is not None:
            self._stream.write(ev.to_json() + "\n")

    # --------------------------------------------------------------- queries
    def events(self) -> List[RoundEvent]:
        return list(self._events)

    def alpha_hat(self) -> Optional[float]:
        """EMA acceptance estimate; parity with ServingMetrics.alpha_hat()."""
        return self._alpha

    def accept_hist(self, gamma_max: int) -> np.ndarray:
        hist = np.zeros(gamma_max + 1, np.int64)
        for ev in self._events:
            if ev.gamma <= 0:
                continue
            for acc in ev.accepted:
                hist[int(min(max(acc, 0), gamma_max))] += 1
        return hist

    def phase_means(self) -> Dict[str, float]:
        """Mean per-phase seconds over events that carry phase times."""
        sums: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for ev in self._events:
            for key in ("t_round", "t_draft", "t_verify", "t_commit",
                        "t_handoff", "t_prefill"):
                v = getattr(ev, key)
                if v is not None:
                    sums[key] = sums.get(key, 0.0) + v
                    counts[key] = counts.get(key, 0) + 1
        return {k: sums[k] / counts[k] for k in sums}

    # -------------------------------------------------------------- streaming
    def stream_to(self, f: IO[str]):
        """Append every future event to ``f`` as one JSON line each."""
        self._stream = f

    def to_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for ev in self._events:
                f.write(ev.to_json() + "\n")
        return path
