"""Open-loop arrival traces (Poisson / bursty) and the replay harness
(port of ``repro/serving/frontend/traffic.py``; the same seed gives the
same arrivals, prompts, budgets and deadlines bit for bit: the numpy
Generator is called in the same order).

Trace GENERATION is pure and deterministic: arrivals are *relative offsets*
produced by a seeded ``numpy`` Generator — no wall clock, no global RNG
(a test greps this package for both). Real time enters only at REPLAY,
through the injectable ``repro_torch.obs.clock`` (``now=``), so tests can
assert on trace content without sleeping.

  * ``poisson_trace`` — memoryless arrivals at a fixed rate: the standard
    open-system model ("Efficient LLM Inference over Heterogeneous Edge
    Networks" optimizes per-request latency under exactly this process).
  * ``bursty_trace`` — on/off modulated Poisson: arrivals at the burst rate
    during ON windows, silence for ``off_s`` between them — the tail-latency
    stressor (queue depth spikes at each burst head).

Both draw ragged prompt/output lengths and an optional per-request deadline
``deadline_s = slo_base_s + slo_per_token_s * max_new`` — the SLO the
scheduler's EDF admission and the goodput metric are evaluated against.

``replay`` submits a trace against an ``AsyncSpecServer`` at its arrival
offsets and consumes every stream concurrently, recording per-request
client-side TTFT, per-output-token latency, and deadline outcomes — the
raw rows ``launch.serve_async.report`` aggregates into percentiles.
"""
from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import clock


@dataclass(frozen=True)
class TraceRequest:
    rid: int
    arrival_s: float                 # offset from trace start
    prompt: np.ndarray               # [P] int32
    max_new: int
    deadline_s: Optional[float] = None   # SLO, relative to arrival


def _ragged(rng: np.random.Generator, n: int, vocab: int,
            prompt_lens: Tuple[int, int], max_news: Tuple[int, int]):
    Ps = rng.integers(prompt_lens[0], prompt_lens[1] + 1, n)
    news = rng.integers(max_news[0], max_news[1] + 1, n)
    prompts = [rng.integers(0, vocab, int(P)).astype(np.int32) for P in Ps]
    return prompts, news


def _build(arrivals, prompts, news, slo_base_s, slo_per_token_s):
    out = []
    for i, (t, p, new) in enumerate(zip(arrivals, prompts, news)):
        ddl = (None if slo_base_s is None
               else slo_base_s + slo_per_token_s * int(new))
        out.append(TraceRequest(i, float(t), p, int(new), ddl))
    return out


def poisson_trace(n: int, rate_rps: float, vocab: int, *, seed: int = 0,
                  prompt_lens: Tuple[int, int] = (4, 18),
                  max_news: Tuple[int, int] = (4, 24),
                  slo_base_s: Optional[float] = None,
                  slo_per_token_s: float = 0.0) -> List[TraceRequest]:
    """``n`` requests with exponential inter-arrival gaps at ``rate_rps``."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, n)
    gaps[0] = 0.0                       # the trace starts with its first job
    prompts, news = _ragged(rng, n, vocab, prompt_lens, max_news)
    return _build(np.cumsum(gaps), prompts, news, slo_base_s, slo_per_token_s)


def bursty_trace(n: int, burst_rate_rps: float, vocab: int, *, seed: int = 0,
                 on_s: float = 0.5, off_s: float = 1.0,
                 prompt_lens: Tuple[int, int] = (4, 18),
                 max_news: Tuple[int, int] = (4, 24),
                 slo_base_s: Optional[float] = None,
                 slo_per_token_s: float = 0.0) -> List[TraceRequest]:
    """On/off modulated Poisson: Poisson arrivals at ``burst_rate_rps``
    folded onto an ON(``on_s``)/OFF(``off_s``) square wave — every ``on_s``
    seconds of active time is followed by an ``off_s`` silence."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / burst_rate_rps, n)
    gaps[0] = 0.0
    t_active = np.cumsum(gaps)          # time within ON windows only
    cycle = np.floor(t_active / on_s)   # how many OFF gaps precede each
    arrivals = t_active + cycle * off_s
    prompts, news = _ragged(rng, n, vocab, prompt_lens, max_news)
    return _build(arrivals, prompts, news, slo_base_s, slo_per_token_s)


def shared_prefix_trace(n: int, rate_rps: float, vocab: int, *,
                        seed: int = 0, prefix_len: int = 16,
                        suffix_lens: Tuple[int, int] = (2, 8),
                        max_news: Tuple[int, int] = (4, 24),
                        slo_base_s: Optional[float] = None,
                        slo_per_token_s: float = 0.0) -> List[TraceRequest]:
    """Poisson arrivals where every prompt opens with the SAME
    ``prefix_len``-token system prompt followed by a unique ragged suffix —
    the multi-client chat shape the prefix cache exists for. A prefix-cache
    run on this trace must record a nonzero hit-rate; a cache-less run
    re-prefills the shared head ``n`` times."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, n)
    gaps[0] = 0.0
    system = rng.integers(0, vocab, prefix_len).astype(np.int32)
    Ps = rng.integers(suffix_lens[0], suffix_lens[1] + 1, n)
    news = rng.integers(max_news[0], max_news[1] + 1, n)
    prompts = [np.concatenate(
        [system, rng.integers(0, vocab, int(P)).astype(np.int32)])
        for P in Ps]
    return _build(np.cumsum(gaps), prompts, news, slo_base_s, slo_per_token_s)


async def replay(front, trace: Sequence[TraceRequest], *, now=clock.wall,
                 on_token=None) -> List[dict]:
    """Replay ``trace`` open-loop against an AsyncSpecServer: each request
    is submitted at its arrival offset REGARDLESS of how the server is
    keeping up (that is what makes queueing delay measurable), and its
    stream is consumed concurrently. Returns one record per request:

        rid, arrival_s (actual, relative to replay start), n_tokens,
        tokens (np.ndarray), ttft_s, tpot_s (mean per-output-token latency
        after the first), latency_s, deadline_s, deadline_met, rounds
        (distinct RoundEvent ids the stream joined)

    ``on_token(rid, StreamEvent)`` is an optional synchronous callback per
    streamed token (the CLI uses it to print live).
    """
    t0 = now()

    async def one(item: TraceRequest) -> dict:
        delay = (t0 + item.arrival_s) - now()
        if delay > 0:
            await asyncio.sleep(delay)
        t_submit = now()
        stream = await front.submit(item.prompt, item.max_new,
                                    deadline_s=item.deadline_s,
                                    rid=item.rid, events=True)
        toks, t_toks, rounds = [], [], []
        async for ev in stream:
            toks.append(ev.token)
            t_toks.append(now())
            rounds.append(ev.round)
            if on_token is not None:
                on_token(item.rid, ev)
        n = len(toks)
        ttft = (t_toks[0] - t_submit) if n else None
        latency = (t_toks[-1] - t_submit) if n else None
        tpot = ((t_toks[-1] - t_toks[0]) / (n - 1)) if n > 1 else None
        return {
            "rid": item.rid,
            "arrival_s": t_submit - t0,
            "n_tokens": n,
            "tokens": np.asarray(toks, np.int32),
            "ttft_s": ttft,
            "tpot_s": tpot,
            "latency_s": latency,
            "deadline_s": item.deadline_s,
            "deadline_met": (None if item.deadline_s is None else
                             (latency is not None
                              and n >= item.max_new
                              and latency <= item.deadline_s)),
            "rounds": sorted(set(rounds)),
        }

    return list(await asyncio.gather(*(one(it) for it in trace)))
