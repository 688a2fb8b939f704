"""Straggler watchdog for the serving round loop (port of
``repro/serving/watchdog.py``).

Tracks an EMA baseline of healthy *speculative* round times and trips after
``patience`` consecutive rounds slower than ``slow_factor`` times that
baseline. A tripped watchdog is the server's signal to degrade the current
batch to AR via the existing one-way spec->AR rule: a straggling drafter
(contended edge accelerator, stalled link in a placed deployment) makes
gamma>0 rounds strictly worse than AR, and the degradation is exactly the
alpha-collapse fallback the batch already knows how to take.

Only speculative rounds feed the baseline — AR rounds have a different cost
profile, and a degraded batch must not teach the watchdog that slow is the
new normal. The server resets the watchdog when the batch drains (batch
re-formation is where spec mode is re-enabled, so the two recover
together). All times come from the server's injected tracer clock, so
chaos tests drive the watchdog with purely virtual delays.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class RoundWatchdog:
    """Trip detector over speculative round times.

    slow_factor: a round is a breach if t > slow_factor * EMA baseline.
    patience:    consecutive breaches required to trip (one slow round is
                 usually a compilation or GC blip, not a straggler).
    ema:         baseline smoothing weight for healthy rounds.
    min_rounds:  healthy observations needed before breaches count — the
                 first rounds of a batch include warmup noise.
    """
    slow_factor: float = 4.0
    patience: int = 2
    ema: float = 0.3
    min_rounds: int = 3

    baseline: float = field(default=0.0, init=False)
    n_healthy: int = field(default=0, init=False)
    breaches: int = field(default=0, init=False)
    tripped: bool = field(default=False, init=False)
    n_trips: int = field(default=0, init=False)

    def observe(self, t_round: float) -> bool:
        """Feed one speculative round time; returns True iff this
        observation trips the watchdog."""
        if self.tripped:
            return False
        if self.n_healthy >= self.min_rounds and \
                t_round > self.slow_factor * self.baseline > 0.0:
            self.breaches += 1
            if self.breaches >= self.patience:
                self.tripped = True
                self.n_trips += 1
                return True
            return False
        self.breaches = 0
        self.baseline = (t_round if self.n_healthy == 0
                         else (1 - self.ema) * self.baseline
                         + self.ema * t_round)
        self.n_healthy += 1
        return False

    def reset(self) -> None:
        """Forget the trip and the baseline (called at batch drain: the next
        batch may run on recovered hardware with a different cost profile)."""
        self.baseline = 0.0
        self.n_healthy = 0
        self.breaches = 0
        self.tripped = False
