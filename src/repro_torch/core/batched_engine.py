"""Per-row batched speculative decoding (port of the round part of
``repro/core/batched_engine.py``).

Every round runs ``rounds.spec_round`` with per-row commits: each row
commits its OWN accepted prefix, so throughput tracks each row's own alpha.
``serving.paged_server`` drives this engine on paged caches. ``generate``
(which runs on the ring cache) waits for the ring-cache slice.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import rounds
from repro_torch.core.rounds import RoundState

KV_FAMILIES = ("dense",)

# the per-row state IS the round core's state with [B] lengths and an
# ``active`` mask
RowState = RoundState


@dataclass(frozen=True)
class BatchedEngineConfig:
    gamma: int = 4


class BatchedSpecEngine:
    def __init__(self, target_model, drafter_model, ecfg: BatchedEngineConfig):
        if (target_model.family not in KV_FAMILIES
                or drafter_model.family not in KV_FAMILIES):
            raise ValueError("per-row speculation needs KV-cache families, got "
                             f"{target_model.family}/{drafter_model.family}")
        self.target = target_model
        self.drafter = drafter_model
        self.ecfg = ecfg
        self._round_spec = rounds.RoundSpec(gamma=ecfg.gamma)

    def round(self, params_t, params_d, st: RowState) -> RowState:
        return rounds.spec_round(self.target, self.drafter, params_t,
                                 params_d, st, self._round_spec)
