"""Paged speculative serving (port of ``repro.serving``'s default path)."""
from repro_torch.serving.faults import NO_FAULTS, DrafterFault, FaultPlan
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.paged_server import PagedSpecServer
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig, ServeRequest
from repro_torch.serving.watchdog import RoundWatchdog

__all__ = ["NO_FAULTS", "DrafterFault", "FaultPlan", "PagedSpecServer",
           "RoundWatchdog", "Scheduler", "SchedulerConfig", "ServeRequest",
           "ServingMetrics"]
