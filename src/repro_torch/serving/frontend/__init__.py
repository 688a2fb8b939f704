"""Async streaming serving front end over the paged speculative server
(port of ``repro/serving/frontend``).

The closed synchronous loops elsewhere measure offline throughput; this
package turns the paged server into an OPEN system — the thing edge-serving
latency claims are made about:

  * ``async_server.AsyncSpecServer`` — asyncio front end: per-request token
    streams with bounded backpressure, client cancellation that frees KV
    blocks mid-generation, per-request deadlines feeding the scheduler's
    EDF admission.
  * ``traffic.py`` — seeded Poisson / bursty / shared-prefix open-loop
    arrival traces with ragged lengths, plus the ``replay`` harness that
    drives a front end with them and records per-request TTFT and
    per-token latency.

Nothing in this package reads a clock or an unseeded RNG directly
(``tests/test_torch_package.py`` holds it to that).
"""
from repro_torch.serving.frontend.async_server import AsyncSpecServer, StreamEvent
from repro_torch.serving.frontend.traffic import (TraceRequest, bursty_trace,
                                                  poisson_trace, replay,
                                                  shared_prefix_trace)

__all__ = ["AsyncSpecServer", "StreamEvent", "TraceRequest",
           "poisson_trace", "bursty_trace", "shared_prefix_trace", "replay"]
