"""Per-row batched speculative decoding (port of the round part of
``repro/core/batched_engine.py``).

Every round runs ``rounds.spec_round`` with per-row commits: each row
commits its OWN accepted prefix, so throughput tracks each row's own alpha.
``serving.paged_server`` drives this engine on paged caches. With an
enabled tracer the engine also holds a ``rounds.TracedRound`` over the same
spec (``traced_round``), which the server runs instead of ``round``.
``generate`` (which runs on the ring cache) waits for the ring-cache slice.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import rounds
from repro_torch.core.rounds import RoundState
from repro_torch.obs.trace import NULL_TRACER

KV_FAMILIES = ("dense",)

# the per-row state IS the round core's state with [B] lengths and an
# ``active`` mask
RowState = RoundState


@dataclass(frozen=True)
class BatchedEngineConfig:
    gamma: int = 4


class BatchedSpecEngine:
    def __init__(self, target_model, drafter_model, ecfg: BatchedEngineConfig,
                 tracer=None):
        """An ENABLED ``tracer`` (repro_torch.obs) builds ``traced_round``,
        the phase-split round with draft/verify/commit spans; otherwise it
        stays None and tracing adds no sync and no launch."""
        if (target_model.family not in KV_FAMILIES
                or drafter_model.family not in KV_FAMILIES):
            raise ValueError("per-row speculation needs KV-cache families, got "
                             f"{target_model.family}/{drafter_model.family}")
        self.target = target_model
        self.drafter = drafter_model
        self.ecfg = ecfg
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._round_spec = rounds.RoundSpec(gamma=ecfg.gamma)
        self.traced_round = (rounds.TracedRound(self.target, self.drafter,
                                                self._round_spec, self.tracer)
                             if self.tracer.enabled else None)

    def round(self, params_t, params_d, st: RowState) -> RowState:
        return rounds.spec_round(self.target, self.drafter, params_t,
                                 params_d, st, self._round_spec)
