"""Paged speculative serving (port of ``repro.serving``): scheduler,
telemetry, the paged continuous-batching server, the async streaming front
end and the robustness layer (watchdog degradation + seeded fault
injection)."""
from repro_torch.serving.faults import NO_FAULTS, DrafterFault, FaultPlan
from repro_torch.serving.metrics import RequestRecord, ServingMetrics
from repro_torch.serving.paged_server import PagedSpecServer
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig, ServeRequest
from repro_torch.serving.watchdog import RoundWatchdog


def __getattr__(name):
    # lazy: the async front end loads only when asked for
    if name in ("AsyncSpecServer", "StreamEvent"):
        from repro_torch.serving import frontend
        return getattr(frontend, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["RequestRecord", "ServingMetrics", "PagedSpecServer",
           "Scheduler", "SchedulerConfig", "ServeRequest",
           "FaultPlan", "NO_FAULTS", "DrafterFault", "RoundWatchdog",
           "AsyncSpecServer", "StreamEvent"]
