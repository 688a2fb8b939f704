"""Runtime-feedback hook of an ExecutionPlan: online alpha-EMA re-planning.

The Planner fixes gamma offline from an *expected* acceptance rate; this hook
closes the loop at run time, identically for every backend. It keeps an EMA
of the measured acceptance rate and re-evaluates the same Eq. (1) cost model
the planner used, over the plan's candidate gammas — so "adapt gamma to the
prompt" (the engine backend's adaptive loop), "retune gamma per batch"
(serving/scheduler.py), and "downgrade to AR when speculation stops paying"
are all the one function ``GammaController.gamma()``.

The port's copy of ``repro/api/feedback.py``; ``respec_from_drift`` reads
the port's ``obs/drift.py::DriftMonitor.evidence()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from repro_torch.core import cost_model


def best_gamma(candidates: Sequence[int], alpha: float, c: float) -> int:
    """argmax_{g in candidates} S(alpha, g, c) — the discrete analogue of
    cost_model.optimal_gamma restricted to the plan's compiled rounds."""
    alpha = min(max(float(alpha), 1e-3), 0.999)
    best_g, best_s = candidates[0], -1.0
    for g in candidates:
        s = cost_model.speedup(alpha, g, c)
        if s > best_s:
            best_g, best_s = g, s
    return best_g


@dataclass
class AlphaEma:
    """Exponential moving average of the per-round acceptance rate.

    ``value`` stays None until the first observation (so callers can tell
    "no telemetry yet" apart from a measured rate); the first observation
    blends against ``prior`` when one is set, so a single unlucky round
    cannot erase the planner's offline alpha estimate.
    """
    ema: float = 0.9
    value: Optional[float] = None           # None until the first observation
    prior: Optional[float] = None           # blended into the first update

    def observe(self, n_accepted: int, n_drafted: int) -> float:
        alpha_round = n_accepted / max(n_drafted, 1)
        base = self.value if self.value is not None else self.prior
        if base is None:
            self.value = alpha_round
        else:
            self.value = self.ema * base + (1 - self.ema) * alpha_round
        return self.value

    def get(self, default: float) -> float:
        return default if self.value is None else self.value


def respec_from_drift(spec, monitor, alpha: Optional[float] = None):
    """Fold a DriftMonitor's measured evidence back into a DeploymentSpec.

    The re-planning half of the observability loop (docs/DESIGN.md §7): a
    traced run's drift monitor measures t_draft (per token), t_target, and
    the dispatch overhead; this replaces the spec's priors with those
    measurements and clears ``cost_coefficient`` so the Planner re-derives
    c = t_draft/t_target from them. Pass the run's measured acceptance EMA
    as ``alpha`` (e.g. ``session.alpha_hat``) to replace that prior too.
    Returns ``spec`` unchanged when the monitor has no evidence yet (not
    calibrated, or no draft phase observed).
    """
    import dataclasses

    ev = monitor.evidence() if monitor is not None else None
    if not ev:
        return spec
    updates = dict(cost_coefficient=None, t_draft=ev["t_draft"],
                   t_target=ev["t_target"])
    if ev.get("dispatch_overhead") is not None:
        updates["dispatch_overhead"] = ev["dispatch_overhead"]
    if alpha is not None:
        updates["alpha"] = min(max(float(alpha), 1e-3), 0.999)
    return dataclasses.replace(spec, **updates)


class GammaController:
    """Per-session gamma controller driven by a GammaSchedule.

    Non-adaptive schedules return the planned gamma forever; adaptive ones
    re-pick from ``candidates`` after every ``observe()``. ``allow_ar=True``
    additionally lets the controller emit gamma=0 (stop speculating) when the
    measured alpha makes every candidate infeasible — the serving-side
    downgrade rule (docs/DESIGN.md §4).
    """

    def __init__(self, schedule, c: float, *, allow_ar: bool = False):
        self.schedule = schedule
        self.c = float(c)
        self.allow_ar = allow_ar
        self.tracker = AlphaEma(ema=schedule.alpha_ema,
                                prior=schedule.alpha_init)
        self.gamma_trace: list = []

    def gamma(self) -> int:
        s = self.schedule
        if not (s.adaptive and s.candidates):
            return s.gamma
        alpha = self.tracker.get(s.alpha_init)
        cands: Tuple[int, ...] = s.candidates
        if self.allow_ar:
            cands = (0,) + tuple(c for c in cands if c > 0)
        g = best_gamma(cands, alpha, self.c)
        self.gamma_trace.append(g)
        return g

    def observe(self, n_accepted: int, n_drafted: int):
        if n_drafted > 0:
            self.tracker.observe(int(n_accepted), int(n_drafted))

    @property
    def alpha_hat(self) -> Optional[float]:
        return self.tracker.value
