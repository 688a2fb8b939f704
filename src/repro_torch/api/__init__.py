"""Unified plan -> session API over the port's speculative execution paths
(port of ``repro.api``).

Two phases, mirroring the paper's compile-then-run split:

  1. PLAN — ``Planner(DeploymentSpec).plan()`` runs the analytical cost model
     (Eq. 1) and the heterogeneous-mapping DSE offline and freezes every
     decision (strategy, gamma schedule or AR fallback, cache layout,
     batching mode, submesh placement) into a serializable ``ExecutionPlan``
     (the same JSON as the JAX package's).
  2. RUN — ``Session(target, drafter, params_t, params_d, plan)`` executes
     the plan through one facade: ``generate()``, ``generate_batch()``,
     ``serve()``. The engines and the paged server are backends behind the
     ``SpecBackend`` protocol.

The JAX package's placement exports (``Placement``, ``lower``, ...) wait
for placement's port (ROADMAP.md, Queue 1 item 2c).
"""
from repro_torch.api.backends import SpecBackend
from repro_torch.api.feedback import (AlphaEma, GammaController, best_gamma,
                                      respec_from_drift)
from repro_torch.api.plan import (CacheLayout, DeploymentSpec, ExecutionPlan,
                                  GammaSchedule, PlacementPlan, SubmeshSpec)
from repro_torch.api.planner import Planner
from repro_torch.api.planner import plan as plan_deployment
from repro_torch.api.session import Session
from repro_torch.serving.scheduler import ServeRequest

__all__ = ["AlphaEma", "CacheLayout", "DeploymentSpec", "ExecutionPlan",
           "GammaController", "GammaSchedule", "PlacementPlan", "Planner",
           "ServeRequest", "Session", "SpecBackend", "SubmeshSpec",
           "best_gamma", "plan_deployment", "respec_from_drift"]
