"""Paged speculative serving (port of ``repro.serving``'s default path)."""
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.paged_server import PagedSpecServer
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig, ServeRequest

__all__ = ["PagedSpecServer", "Scheduler", "SchedulerConfig", "ServeRequest",
           "ServingMetrics"]
