"""The single place ``src/repro_torch`` reads real clocks (port of
``repro/obs/clock.py``).

Everything else takes a clock as a parameter or imports these callables,
so a test can hand in a clock of its own.

  * ``perf()`` — monotonic, high-resolution; use for durations.
  * ``wall()`` — epoch seconds; use for timestamps (request arrival).
"""
from __future__ import annotations

import time

perf = time.perf_counter
wall = time.time

