"""Online predicted-vs-measured cost-model drift detection (port of
``repro/obs/drift.py``).

The paper's Eq. (1) and the round-time model *predict* serving behaviour;
this monitor checks that continuously against live rounds.

Units. The cost model is dimensionless: it prices a round in units of one
target forward pass (t_target): draft costs ``gamma * c``, verify costs
``1``, a round costs ``round_time(gamma, c, h) = gamma*c + 1 + h``. To
compare against measured seconds the monitor needs the t_target unit in
seconds, which it **calibrates from the first ``calibration_rounds``
observed rounds and thereafter only ratchets DOWN** (to the fastest verify
ever seen: warm-up rounds and contention are strictly slower, so min is the
clean sample). Never up: if the unit tracked the measurement, a uniformly
slowing system would hide inside a self-updating unit. Components with no
model term (commit, handoff, prefill) are calibrated the same way, so for
them the monitor detects *change from the calibrated baseline*.

Per component it keeps an EMA of measured seconds and of predicted units,
and flags when the relative error leaves the tolerance band for
``min_samples``+ observations: "cost model is wrong by X% on component Y".

``evidence()`` turns the measurements back into planner inputs (measured
t_draft per token, t_target, c, dispatch_overhead); the paged server's
gamma decision reads its ``c``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core import cost_model

COMPONENTS = ("draft", "verify", "commit", "handoff", "prefill", "round")


@dataclass(frozen=True)
class DriftConfig:
    ema: float = 0.9               # smoothing for measured/predicted EMAs
    tol: float = 0.25              # flag when |measured/predicted - 1| > tol
    warmup_rounds: int = 1         # observations dropped before calibrating
                                   # (the first round pays warm-up costs —
                                   # in the unit it would dwarf every
                                   # steady-state measurement)
    calibration_rounds: int = 3    # rounds used to pin the t_target unit
    min_samples: int = 3           # post-calibration obs before flagging
    min_abs: float = 0.0           # absolute floor (s) on flagged deltas


class _Component:
    __slots__ = ("measured", "units", "n")

    def __init__(self):
        self.measured: Optional[float] = None   # seconds, EMA
        self.units: Optional[float] = None      # t_target units, EMA
        self.n = 0

    def observe(self, measured_s: float, units: float, ema: float):
        if self.measured is None:
            self.measured, self.units = measured_s, units
        else:
            self.measured = ema * self.measured + (1 - ema) * measured_s
            self.units = ema * self.units + (1 - ema) * units
        self.n += 1


class DriftMonitor:
    """Compare measured round/phase times against the cost model.

    ``c``/``dispatch_overhead``/``overlap`` are the values the decision was
    made with; ``gamma`` is the default draft length (overridable per
    observation since the scheduler retunes gamma online).
    """

    def __init__(self, gamma: int, c: float,
                 dispatch_overhead: float = cost_model.DISPATCH_OVERHEAD_DEFAULT,
                 overlap: bool = False, cfg: Optional[DriftConfig] = None):
        self.gamma = max(int(gamma), 1)
        self.c = float(c)
        self.h = float(dispatch_overhead)
        self.overlap = bool(overlap)
        self.cfg = cfg or DriftConfig()
        self.unit: Optional[float] = None          # t_target in seconds
        self._warmup_left = self.cfg.warmup_rounds
        self._cal: Dict[str, List[float]] = {k: [] for k in COMPONENTS}
        self._cal_rounds = 0
        self._baseline_units: Dict[str, float] = {}  # commit/handoff/prefill
        self._comp: Dict[str, _Component] = {k: _Component()
                                             for k in COMPONENTS}
        self._draft_per_token: Optional[float] = None  # seconds, EMA

    # ----------------------------------------------------------- predictions
    def predicted_units(self, component: str,
                        gamma: Optional[int] = None) -> Optional[float]:
        """Model-predicted cost of ``component`` in t_target units."""
        g = self.gamma if gamma is None else max(int(gamma), 1)
        if component == "draft":
            return g * self.c
        if component == "verify":
            return 1.0
        if component == "round":
            return cost_model.round_time(g, self.c, self.h, self.overlap)
        return self._baseline_units.get(component)   # commit/handoff/prefill

    # ------------------------------------------------------------ observation
    def observe(self, t_round: Optional[float] = None,
                t_draft: Optional[float] = None,
                t_verify: Optional[float] = None,
                t_commit: Optional[float] = None,
                t_handoff: Optional[float] = None,
                t_prefill: Optional[float] = None,
                gamma: Optional[int] = None):
        """Feed one round's measured seconds (any subset of components).
        ``t_prefill`` is the interleaved chunk-program time of steps that
        advanced a prefill."""
        if self._warmup_left > 0:
            self._warmup_left -= 1
            return
        g = self.gamma if gamma is None else max(int(gamma), 1)
        measured = {"draft": t_draft, "verify": t_verify, "commit": t_commit,
                    "handoff": t_handoff, "prefill": t_prefill,
                    "round": t_round}
        if self.unit is None:
            self._calibrate(measured, g)
            return
        # the unit only ratchets DOWN: the fastest verify ever seen is the
        # cleanest t_target sample. report() scales the units-EMA by the
        # current unit, so a late refinement applies retroactively; a unit
        # that could rise would hide real slowdowns
        if t_verify is not None:
            self.unit = min(self.unit, float(t_verify))
        ema = self.cfg.ema
        for comp, t in measured.items():
            if t is None:
                continue
            units = self.predicted_units(comp, g)
            if units is None:
                # component with no model term and no calibration sample:
                # its first live observation becomes the baseline
                self._baseline_units[comp] = t / self.unit
                units = self._baseline_units[comp]
            self._comp[comp].observe(float(t), units, ema)
        if t_draft is not None:
            per_tok = float(t_draft) / g
            self._draft_per_token = (per_tok if self._draft_per_token is None
                                     else ema * self._draft_per_token
                                     + (1 - ema) * per_tok)

    def _calibrate(self, measured: Dict[str, Optional[float]], g: int):
        for comp, t in measured.items():
            if t is not None:
                self._cal[comp].append(float(t))
        self._cal_rounds += 1
        if self._cal_rounds < self.cfg.calibration_rounds:
            return
        # pin the t_target unit: prefer measured verify (verify IS one
        # target pass); fall back to the full round over its model cost.
        # min, not mean: the fastest sample is the clean one
        if self._cal["verify"]:
            self.unit = min(self._cal["verify"])
        elif self._cal["round"]:
            self.unit = min(self._cal["round"]) / cost_model.round_time(
                g, self.c, self.h, self.overlap)
        else:
            self._cal_rounds -= 1    # nothing usable yet; keep calibrating
            return
        for comp in ("commit", "handoff", "prefill"):
            if self._cal[comp]:
                self._baseline_units[comp] = min(self._cal[comp]) / self.unit

    # ---------------------------------------------------------------- reports
    @property
    def calibrated(self) -> bool:
        return self.unit is not None

    def report(self) -> Dict[str, dict]:
        """Per-component predicted vs measured seconds and drift verdict."""
        out: Dict[str, dict] = {}
        for comp in COMPONENTS:
            c = self._comp[comp]
            if c.n == 0:
                continue
            predicted = (c.units * self.unit
                         if c.units is not None and self.unit else None)
            err = (c.measured / predicted - 1.0
                   if predicted and predicted > 0 else None)
            flagged = (err is not None and c.n >= self.cfg.min_samples
                       and abs(err) > self.cfg.tol
                       and abs(c.measured - predicted) > self.cfg.min_abs)
            out[comp] = {"predicted_s": predicted, "measured_s": c.measured,
                         "rel_err": err, "flagged": flagged, "n": c.n}
        return out

    def alerts(self) -> List[str]:
        msgs = []
        for comp, r in self.report().items():
            if r["flagged"]:
                msgs.append(
                    f"cost model is wrong by {r['rel_err']:+.0%} on component "
                    f"'{comp}' (predicted {r['predicted_s'] * 1e3:.2f} ms, "
                    f"measured {r['measured_s'] * 1e3:.2f} ms)")
        return msgs

    def evidence(self) -> Optional[dict]:
        """Measured planner inputs. None until the monitor has both a unit
        and a draft observation."""
        if self.unit is None:
            return None
        verify = self._comp["verify"]
        t_target = verify.measured if verify.n else self.unit
        if self._draft_per_token is None:
            return None
        ev = {"t_target": t_target, "t_draft": self._draft_per_token,
              "c": self._draft_per_token / t_target}
        rnd, draft = self._comp["round"], self._comp["draft"]
        if rnd.n and draft.n and verify.n:
            extra = rnd.measured - draft.measured - verify.measured
            for comp in ("commit", "handoff"):
                if self._comp[comp].n:
                    extra -= self._comp[comp].measured
            ev["dispatch_overhead"] = max(extra / t_target, 0.0)
        return ev

    def to_dict(self) -> dict:
        return {"gamma": self.gamma, "c": self.c, "h": self.h,
                "overlap": self.overlap, "unit_s": self.unit,
                "report": self.report(), "alerts": self.alerts(),
                "evidence": self.evidence()}
