"""Seeded fault injection for the paged serving stack (port of
``repro/serving/faults.py``, the same schedules from the same seeds).

The chaos layer: a ``FaultPlan`` is a *deterministic, replayable* schedule
of failures keyed by the server's global round index. ``PagedSpecServer``
consults it at fixed hook points every round (a no-op ``NO_FAULTS`` plan by
default — the hot path pays four dict lookups per round when chaos is off):

  * ``round_delay(r)``   — VIRTUAL seconds added to the round's measured
    ``t_round`` before it reaches telemetry and the watchdog. Simulates a
    straggling drafter/link deterministically: no real sleeping, so chaos
    tests never depend on wall time, yet the watchdog, drift monitor, and
    RoundEvents all see the straggle.
  * ``drafter_fails(r)`` — the speculative dispatch raises ``DrafterFault``
    *before* the round runs (device state untouched). The server must
    degrade the batch to AR via the one-way spec->AR rule, not wedge.
  * ``pool_delta(r)``    — blocks seized from (>0) or released back to (<0)
    the allocator free list: forced memory pressure driving preemption.
    Seizure only takes FREE blocks; live rows are never corrupted.
  * ``corrupts(r)``      — one live row's newest committed token is poisoned
    to an out-of-vocab id after the round: the stand-in for non-finite
    logits / sampler corruption. The server's output guard must FAIL that
    request cleanly instead of streaming the garbage token.

``FaultPlan.seeded`` draws a schedule from one ``numpy`` Generator so an
entire chaos run is reproduced by (seed, horizon, rates): the same seed
gives the JAX package's schedule field for field, so a chaos run of the
port replays the faults of the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet

import numpy as np


class DrafterFault(RuntimeError):
    """Injected drafter failure (raised before the speculative dispatch)."""


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic fault schedule keyed by global round index.

    All-empty (the ``NO_FAULTS`` default) means no fault ever fires. Field
    semantics are documented in the module docstring; ``seed`` records the
    generator seed for ``seeded`` plans (purely informational — the schedule
    itself is frozen at construction)."""
    delay_rounds: Dict[int, float] = field(default_factory=dict)
    drafter_fail_rounds: FrozenSet[int] = frozenset()
    corrupt_rounds: FrozenSet[int] = frozenset()
    pool_deltas: Dict[int, int] = field(default_factory=dict)
    seed: int = -1   # -1 = hand-built plan

    # ------------------------------------------------------------- queries
    def round_delay(self, round_idx: int) -> float:
        return float(self.delay_rounds.get(round_idx, 0.0))

    def drafter_fails(self, round_idx: int) -> bool:
        return round_idx in self.drafter_fail_rounds

    def corrupts(self, round_idx: int) -> bool:
        return round_idx in self.corrupt_rounds

    def pool_delta(self, round_idx: int) -> int:
        return int(self.pool_deltas.get(round_idx, 0))

    @property
    def empty(self) -> bool:
        return not (self.delay_rounds or self.drafter_fail_rounds
                    or self.corrupt_rounds or self.pool_deltas)

    def describe(self) -> str:
        if self.empty:
            return "no faults"
        return (f"faults(seed={self.seed}): "
                f"{len(self.delay_rounds)} delays, "
                f"{len(self.drafter_fail_rounds)} drafter failures, "
                f"{len(self.corrupt_rounds)} corruptions, "
                f"{len(self.pool_deltas)} pool squeezes")

    # ---------------------------------------------------------- generation
    @classmethod
    def seeded(cls, seed: int, *, horizon: int = 256,
               p_delay: float = 0.08, delay_s: float = 0.25,
               p_drafter: float = 0.04, p_corrupt: float = 0.0,
               p_seize: float = 0.06, max_seize: int = 4) -> "FaultPlan":
        """Draw a fault schedule over rounds ``[0, horizon)`` from one seeded
        Generator. Seizures are paired: every seized batch of blocks is
        released a few rounds later, so forced pressure is transient and the
        pool's block census stays auditable mid-run. ``p_corrupt`` defaults
        to 0 because corruption FAILS requests (a loss, not a degradation) —
        opt in explicitly."""
        rng = np.random.default_rng(seed)
        delays: Dict[int, float] = {}
        drafter: set = set()
        corrupt: set = set()
        deltas: Dict[int, int] = {}
        for r in range(horizon):
            if rng.random() < p_delay:
                delays[r] = float(delay_s * (0.5 + rng.random()))
            if rng.random() < p_drafter:
                drafter.add(r)
            if rng.random() < p_corrupt:
                corrupt.add(r)
            if rng.random() < p_seize:
                n = int(rng.integers(1, max_seize + 1))
                deltas[r] = deltas.get(r, 0) + n
                back = r + int(rng.integers(2, 6))
                deltas[back] = deltas.get(back, 0) - n
        return cls(delay_rounds=delays, drafter_fail_rounds=frozenset(drafter),
                   corrupt_rounds=frozenset(corrupt), pool_deltas=deltas,
                   seed=int(seed))


NO_FAULTS = FaultPlan()
