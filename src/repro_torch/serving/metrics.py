"""Serving telemetry: per-request latency/throughput and acceptance-rate
statistics for the paged speculative server (port of
``repro/serving/metrics.py``). ``degradations`` logs each batch the fault
plan or the watchdog turned to AR.

Two consumers:
  * operators — ``summary()`` aggregates tokens/s, latency, the per-round
    acceptance histogram (the serving-time estimate of the paper's α) and
    the SLO outcome: ``deadline_met`` per deadline-carrying request and
    ``goodput``, the share of them that met it;
  * the scheduler — ``alpha_hat()`` feeds the cost model's gamma/AR decision.

A preempted request stays open: its record keeps the queue wait and TTFT of
its first admission, counts its preemptions, and charges the generated
tokens it must prefill again (``recompute_tokens``). Prefill work is counted
in tokens computed, tokens attached from the prefix cache and chunk
programs run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import clock


@dataclass
class RequestRecord:
    rid: int
    prompt_len: int
    max_new: int
    submitted: float = 0.0
    started: float = 0.0      # prefill time (admission)
    completed: float = 0.0
    n_rounds: int = 0
    n_generated: Optional[int] = None  # actual tokens produced (<= max_new)
    first_token_t: Optional[float] = None  # when the first token committed
    deadline: Optional[float] = None       # absolute SLO deadline (clock domain)
    cancelled: bool = False
    expired: bool = False     # dropped at admission: deadline already passed
    failed: Optional[str] = None  # terminal failure reason
    preemptions: int = 0      # times evicted + re-queued mid-flight
    admissions: int = 0       # prefills run (1 + preemptions that resumed)

    @property
    def latency(self) -> float:
        return self.completed - self.submitted

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token: submission -> first committed token."""
        if self.first_token_t is None:
            return None
        return self.first_token_t - self.submitted

    @property
    def queue_wait(self) -> float:
        """Submission -> admission (the scheduler-queue component of TTFT)."""
        return self.started - self.submitted

    @property
    def deadline_met(self) -> Optional[bool]:
        """Whether the request completed by its deadline (None = no
        deadline)."""
        if self.deadline is None:
            return None
        return (not self.cancelled and self.completed > 0.0
                and self.completed <= self.deadline)

    @property
    def decode_tps(self) -> float:
        n = self.n_generated if self.n_generated is not None else self.max_new
        dt = self.completed - self.started
        return n / dt if dt > 0 else float("nan")


class ServingMetrics:
    """Round- and request-level counters. ``now`` is injectable for tests."""

    def __init__(self, gamma_max: int = 16, alpha_ema: float = 0.9,
                 now=clock.wall):
        self.gamma_max = gamma_max
        self.alpha_ema = alpha_ema
        self.now = now
        self._alpha: Optional[float] = None
        self.accept_hist = np.zeros(gamma_max + 1, np.int64)  # n_accepted/round
        self.row_hists: Dict[int, np.ndarray] = {}            # rid -> histogram
        self.n_rounds = 0
        self.n_spec_rounds = 0
        self.requests: Dict[int, RequestRecord] = {}
        self.completed: List[RequestRecord] = []
        self.cancelled: List[RequestRecord] = []
        self.rejected: List[Tuple[int, str]] = []   # (rid, reason)
        self.expired: List[RequestRecord] = []
        self.failed: List[RequestRecord] = []
        self.n_preemptions = 0
        self.recompute_tokens = 0   # generated tokens evicted -> re-prefilled
        self.degradations: List[Tuple[int, str]] = []  # (round, reason)
        self._t0: Optional[float] = None
        self._t_last: Optional[float] = None
        self.total_generated = 0
        # prefill accounting (chunked prefill + prefix cache)
        self.prefill_tokens = 0       # suffix tokens actually prefilled
        self.prefix_hit_tokens = 0    # prefill tokens skipped via cached blocks
        self.prefill_chunks = 0       # chunk programs run
        self.n_prefills = 0           # prefills completed (1 + resumes)

    # ------------------------------------------------------------- requests
    def submit(self, rid: int, prompt_len: int, max_new: int,
               deadline: Optional[float] = None,
               submitted: Optional[float] = None):
        """``deadline`` is absolute in the metrics clock domain; ``submitted``
        lets an async front end stamp the true arrival time even when the
        request reaches the scheduler a round later."""
        rec = RequestRecord(rid, prompt_len, max_new,
                            submitted=(self.now() if submitted is None
                                       else submitted),
                            deadline=deadline)
        self.requests[rid] = rec
        return rec

    def reject(self, rid: int, reason: str):
        """Record a submit-time rejection (demand can never fit)."""
        self.rejected.append((rid, reason))

    def start(self, rid: int):
        rec = self.requests[rid]
        t = self.now()
        if rec.admissions == 0:
            # re-admission after preemption must not rewrite the queue wait
            rec.started = t
        rec.admissions += 1
        if self._t0 is None:
            self._t0 = t

    def first_token(self, rid: int):
        """Stamp the first committed token for ``rid`` (idempotent)."""
        rec = self.requests.get(rid)
        if rec is not None and rec.first_token_t is None:
            rec.first_token_t = self.now()

    def cancel(self, rid: int, n_generated: int = 0):
        """Client cancellation: the record goes to ``cancelled``, not to
        the latency stats; tokens already committed count toward
        throughput."""
        rec = self.requests.pop(rid)
        rec.completed = self.now()
        rec.cancelled = True
        rec.n_generated = max(int(n_generated), 0)
        self._t_last = rec.completed
        self.total_generated += rec.n_generated
        self.cancelled.append(rec)
        return rec

    def complete(self, rid: int, n_generated: Optional[int] = None):
        rec = self.requests.pop(rid)
        rec.completed = self.now()
        rec.n_generated = (int(n_generated) if n_generated is not None
                           else rec.max_new)
        self._t_last = rec.completed
        self.total_generated += rec.n_generated
        self.completed.append(rec)
        return rec

    def preempt(self, rid: int, n_resume_generated: int):
        """Mid-flight eviction: the request stays open (re-queued, not
        terminal). ``n_resume_generated`` = generated tokens in the committed
        prefix that re-admission prefills again (the recompute debt)."""
        rec = self.requests.get(rid)
        if rec is not None:
            rec.preemptions += 1
        self.n_preemptions += 1
        self.recompute_tokens += max(int(n_resume_generated), 0)

    def expire(self, rid: int):
        """Deadline passed while queued: terminal, no blocks ever spent."""
        rec = self.requests.pop(rid)
        rec.completed = self.now()
        rec.expired = True
        rec.n_generated = 0
        self.expired.append(rec)
        return rec

    def fail(self, rid: int, reason: str, n_generated: int = 0):
        """Terminal failure with a recorded reason (e.g. the output guard)."""
        rec = self.requests.pop(rid)
        rec.completed = self.now()
        rec.failed = reason
        rec.n_generated = max(int(n_generated), 0)
        self._t_last = rec.completed
        self.failed.append(rec)
        return rec

    def prefill(self, rid: int, n_tokens: int, hit_tokens: int = 0,
                chunks: int = 1):
        """One completed prefill: ``n_tokens`` suffix tokens computed across
        ``chunks`` chunk programs, ``hit_tokens`` skipped by attaching cached
        prefix blocks. A resume prefill (after preemption) records again."""
        self.prefill_tokens += max(int(n_tokens), 0)
        self.prefix_hit_tokens += max(int(hit_tokens), 0)
        self.prefill_chunks += max(int(chunks), 0)
        self.n_prefills += 1

    def prefix_hit_rate(self) -> Optional[float]:
        """Fraction of candidate prefill tokens served from the prefix cache
        (None until a prefill ran)."""
        total = self.prefill_tokens + self.prefix_hit_tokens
        return self.prefix_hit_tokens / total if total else None

    def degrade(self, round_idx: int, reason: str):
        """A batch fell back from speculative to AR rounds (watchdog trip or
        drafter failure) — a quality-of-service event, not a request event."""
        self.degradations.append((int(round_idx), reason))

    # --------------------------------------------------------------- rounds
    def record_round(self, n_accepted, gamma: int, active=None, rids=None):
        """n_accepted: [B] accepted draft tokens this round; ``active`` masks
        live rows; ``rids`` maps rows to request ids for the per-request
        histograms (``row_hists``)."""
        n_accepted = np.asarray(n_accepted)
        active = (np.asarray(active) if active is not None
                  else np.ones_like(n_accepted, bool))
        self.n_rounds += 1
        if gamma <= 0:
            return
        self.n_spec_rounds += 1
        for b, (acc, live) in enumerate(zip(n_accepted, active)):
            if not live:
                continue
            a = int(min(max(acc, 0), self.gamma_max))
            self.accept_hist[a] += 1
            if rids is not None and rids[b] is not None:
                h = self.row_hists.setdefault(rids[b],
                                              np.zeros(self.gamma_max + 1,
                                                       np.int64))
                h[a] += 1
            # alpha uses the UNCLAMPED acceptance (the clamp only bounds the
            # histogram bins)
            alpha_round = max(float(acc), 0.0) / gamma
            self._alpha = (alpha_round if self._alpha is None else
                           self.alpha_ema * self._alpha
                           + (1 - self.alpha_ema) * alpha_round)

    def alpha_hat(self) -> Optional[float]:
        """EMA acceptance-rate estimate; None until a speculative round ran."""
        return self._alpha

    # -------------------------------------------------------------- summary
    def summary(self) -> dict:
        lat = [r.latency for r in self.completed]
        ttft = [r.ttft for r in self.completed if r.ttft is not None]
        wall = ((self._t_last - self._t0)
                if self._t0 is not None and self._t_last is not None else 0.0)
        # per-request deadline outcomes over every terminal deadline-
        # carrying request: expired and failed ones count as unmet, so
        # goodput does not improve by dropping doomed work
        deadline_met = {r.rid: r.deadline_met for r in self.completed
                        if r.deadline is not None}
        deadline_met.update({r.rid: False for r in self.expired + self.failed
                             if r.deadline is not None})
        return {
            "requests_completed": len(self.completed),
            "requests_cancelled": len(self.cancelled),
            "requests_rejected": len(self.rejected),
            "requests_expired": len(self.expired),
            "requests_failed": len(self.failed),
            "n_preemptions": self.n_preemptions,
            "recompute_tokens": self.recompute_tokens,
            "degradations": len(self.degradations),
            "total_generated_tokens": self.total_generated,
            "aggregate_tokens_per_s": (self.total_generated / wall
                                       if wall > 0 else None),
            "mean_latency_s": float(np.mean(lat)) if lat else float("nan"),
            "p95_latency_s": (float(np.percentile(lat, 95)) if lat
                              else float("nan")),
            "mean_ttft_s": float(np.mean(ttft)) if ttft else None,
            "p50_ttft_s": float(np.percentile(ttft, 50)) if ttft else None,
            "p95_ttft_s": float(np.percentile(ttft, 95)) if ttft else None,
            "deadline_met": deadline_met,
            "goodput": (sum(bool(v) for v in deadline_met.values())
                        / len(deadline_met) if deadline_met else None),
            "rounds": self.n_rounds,
            "spec_rounds": self.n_spec_rounds,
            "alpha_hat": self._alpha,
            "accept_hist": self.accept_hist.copy(),
            "prefill_tokens": self.prefill_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefill_chunks": self.prefill_chunks,
            "prefix_hit_rate": self.prefix_hit_rate(),
            "prefill_compute_saved": self.prefix_hit_rate() or 0.0,
            "chunks_per_prefill": (self.prefill_chunks / self.n_prefills
                                   if self.n_prefills else None),
        }
