"""The single place ``src/repro_torch`` reads real clocks (port of
``repro/obs/clock.py``).

Everything else takes a clock as a parameter or imports these callables,
so a test can hand in ``ManualClock`` and drive time deterministically.

  * ``perf()`` — monotonic, high-resolution; use for durations.
  * ``wall()`` — epoch seconds; use for timestamps (request arrival).
"""
from __future__ import annotations

import time

perf = time.perf_counter
wall = time.time


class ManualClock:
    """A callable clock for tests: returns a fixed value until advanced."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t
