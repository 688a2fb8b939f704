"""Phase two of the two-phase API: execute a frozen ExecutionPlan (port of
``repro/api/session.py``).

``Session`` is the one entry point over the port's speculative execution
paths:

    spec = DeploymentSpec(batch_size=4, prompt_lens=(6, 12), max_new=24,
                          streaming=True, alpha=0.8, cost_coefficient=0.2)
    plan = Planner(spec).plan()          # or ExecutionPlan.from_json(...)
    sess = Session(target, drafter, params_t, params_d, plan)
    done = sess.serve(requests)          # or .generate(...) / .generate_batch(...)

The plan's (batching, cache) pair picks the backend: SpecEngine,
BatchedSpecEngine or PagedSpecServer (each a shell over the round core,
core/rounds.py), or the plain-AR fallback when the cost model emitted
gamma*=0. A Session runs on ``cuda`` unless the caller passes
``device="cpu"``, and raises when no GPU is visible; the params must
already live on its device.

The plan's PlacementPlan is lowered to per-role devices
(``api/placement.py``) over the session device's visible list and handed
to the backend; a plan whose submeshes do not fit runs degenerately, with
the reason on ``session.placement.note``.

Not yet ported: the continuous backend and ``serve_async`` (the front end,
ROADMAP.md Queue 1 item 4: a plan that selects the continuous backend
raises, it does not fall back).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from repro_torch import device as devices
from repro_torch.api import placement as placement_mod
from repro_torch.api.backends import (EngineBackend, PagedBackend,
                                      PerRowBackend, SpecBackend)
from repro_torch.api.plan import DeploymentSpec, ExecutionPlan
from repro_torch.api.planner import Planner
from repro_torch.core.batched_engine import KV_FAMILIES
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving import ServeRequest


def _select_backend(plan: ExecutionPlan, target, drafter) -> str:
    """(batching, cache) -> backend name, with fallbacks to the
    batch-synchronized engine, which honors every plan knob:

      * per-row rollback needs KV-cache families — recurrent targets fall
        back;
      * the per-row/continuous/paged backends are inherently greedy, cached,
        and host-orchestrated (modular) — a plan pinning stochastic sampling,
        no-cache mode, or the monolithic strategy falls back rather than
        silently dropping the knob.
    """
    kv = target.family in KV_FAMILIES and drafter.family in KV_FAMILIES
    if plan.batching == "single":
        return "engine"
    if (not kv or not plan.greedy or not plan.use_cache
            or plan.strategy != "modular"):
        return "engine"
    if plan.batching == "per_row":
        return "per_row"
    return "paged" if plan.cache.kind == "paged" else "continuous"


class Session:
    """Facade executing one ExecutionPlan on a (target, drafter) pair."""

    _BACKENDS = {"engine": EngineBackend, "per_row": PerRowBackend,
                 "paged": PagedBackend}

    def __init__(self, target, drafter, params_t, params_d,
                 plan: ExecutionPlan, *, max_batch: Optional[int] = None,
                 placement=None, tracer=None, device=None):
        """``placement``: a pre-lowered ``api.placement.Placement``; None
        lowers the plan's PlacementPlan over the session device's visible
        devices (``lower_or_degenerate``: plans whose submeshes do not fit
        fall back to the degenerate lowering, with the reason on
        ``session.placement.note``).

        ``tracer``: a ``repro_torch.obs.Tracer`` the Session owns for its
        lifetime and threads through the backend (None = disabled tracing,
        which is free). An ENABLED tracer switches speculative rounds onto
        the phase-split traced execution — inspect via
        ``session.telemetry()``. ``device``: ``cuda`` unless ``"cpu"`` is
        passed; raises when no GPU is visible."""
        self.device = devices.resolve(device)
        self.target, self.drafter = target, drafter
        self.params_t, self.params_d = params_t, params_d
        self.plan = plan
        self.tracer = tracer if tracer is not None else NULL_TRACER
        if placement is None:
            placement = placement_mod.lower_or_degenerate(
                plan.placement, devices.visible(self.device))
        self.placement = placement
        self.backend_name = _select_backend(plan, target, drafter)
        if self.backend_name == "continuous":
            raise NotImplementedError(
                "the plan selects the continuous backend (ContinuousSpecServer"
                "), which waits for the front end's port (ROADMAP.md, Queue 1 "
                "item 4); re-plan with a paged cache (ragged traffic) or "
                "without streaming")
        paged = self.backend_name == "paged"
        if max_batch is None:
            max_batch = 4 if paged else 8
        # the engines run where the params live; the paged server holds
        # its pools and state on the session's device
        self.backend: SpecBackend = self._BACKENDS[self.backend_name](
            target, drafter, params_t, params_d, plan, max_batch=max_batch,
            placement=placement, tracer=self.tracer,
            **({"device": self.device} if paged else {}))

    # --------------------------------------------------------- construction
    @classmethod
    def from_spec(cls, target, drafter, params_t, params_d,
                  spec: DeploymentSpec, **kw) -> "Session":
        """Plan-and-open in one call (the plan is still inspectable after)."""
        return cls(target, drafter, params_t, params_d, Planner(spec).plan(),
                   **kw)

    # ------------------------------------------------------------ execution
    def generate(self, prompt, max_new: Optional[int] = None, key=None):
        """One batch to completion; returns (tokens, stats). ``key`` feeds
        sampled plans (``sampling.keys``; default ``TorchKey(0)``)."""
        return self.backend.generate(prompt, max_new, key=key)

    def generate_batch(self, prompts, max_new: Optional[int] = None):
        """One batch to completion with per-row lengths;
        returns (token buffer, lengths, stats)."""
        return self.backend.generate_batch(prompts, max_new)

    def serve(self, requests: Sequence[Any]) -> List[ServeRequest]:
        """Drain a request list through the plan's serving path. Accepts
        ServeRequests or (rid, prompt, max_new) tuples; returns them with
        ``.tokens`` filled (completion order not guaranteed)."""
        reqs = [r if isinstance(r, ServeRequest) else ServeRequest(*r)
                for r in requests]
        return self.backend.serve(reqs)

    def serve_async(self, **kw):
        """Open-system streaming entry point (paged plans only). The async
        front end is not ported: on a paged plan this raises
        NotImplementedError (ROADMAP.md, Queue 1 item 4)."""
        if self.backend_name != "paged":
            raise ValueError(
                f"serve_async needs the paged backend (plan selected "
                f"{self.backend_name!r}) — async streaming rides the paged "
                f"server's round loop; re-plan with a paged cache")
        return self.backend.serve_async(**kw)

    def request(self, prompt, max_new: Optional[int] = None,
                rid: int = 0) -> ServeRequest:
        """Convenience constructor for serve() inputs."""
        return ServeRequest(rid, np.asarray(prompt, np.int32),
                            self.plan.max_new if max_new is None else max_new)

    # ---------------------------------------------------------- observability
    @property
    def alpha_hat(self) -> Optional[float]:
        """Measured acceptance EMA from the runtime-feedback hook (None until
        a speculative round has run)."""
        ctl = getattr(self.backend, "controller", None)
        if ctl is not None:
            return ctl.alpha_hat
        metrics = getattr(self.backend, "metrics", None)
        return metrics.alpha_hat() if metrics is not None else None

    def telemetry(self) -> dict:
        """The session's telemetry bundle (repro_torch.obs):

            tracer  — the Session-owned Tracer (export via .export(path))
            events  — per-round RoundEventLog (paged backend; else None)
            drift   — cost-model DriftMonitor (paged backend, None until a
                      speculative round has run)
            metrics — ServingMetrics counters (paged backend; else None)

        Live objects, not snapshots."""
        srv = getattr(self.backend, "server", None)
        return {
            "tracer": self.tracer,
            "events": getattr(srv or self.backend, "events", None),
            "drift": getattr(srv or self.backend, "drift", None),
            "metrics": getattr(self.backend, "metrics", None),
        }

    def describe(self) -> str:
        p = self.plan
        lines = [f"Session[{self.backend_name}] strategy={p.strategy} "
                 f"batching={p.batching} cache={p.cache.kind} "
                 f"gamma={p.gamma.gamma}"
                 f"{' (adaptive ' + str(p.gamma.candidates) + ')' if p.gamma.adaptive else ''} "
                 f"predicted_S={p.predicted_speedup:.2f}"]
        lines.append(f"  {self.placement.describe()}")
        lines += [f"  - {r}" for r in p.rationale]
        return "\n".join(lines)
