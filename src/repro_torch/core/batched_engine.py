"""Per-row batched speculative decoding (port of
``repro/core/batched_engine.py``).

Every round runs ``rounds.spec_round`` with per-row commits: each row
commits its OWN accepted prefix, so throughput tracks each row's own alpha.
``generate`` runs the rounds on ring KV caches (the per-row index is a [B]
vector); ``serving.paged_server`` drives ``round`` on paged caches. With
an enabled tracer the engine also holds a ``rounds.TracedRound`` over the
same spec (``traced_round``), which ``generate`` and the server run instead
of ``round``. With a heterogeneous ``placement`` (``api/placement.py``) it
holds a ``rounds.PlacedRound`` instead (``placed_round``: draft on the
drafter's device, verify and commit on the target's), which ``generate``
and the paged server run; a placed round's spans do not synchronize.

Sampling: greedy is the serving configuration; stochastic per-row
acceptance is exact per row (each row is standard speculative sampling on
its own stream) and available through ``BatchedEngineConfig(greedy=
False)`` and ``generate(..., key=)`` (default ``TorchKey(0)``).

Invariant (tested): every greedy row's output equals that row's own
autoregressive greedy continuation, regardless of what other rows do.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import rounds
from repro_torch.core.engine import _prompt_on, init_rings, ring_slack
from repro_torch.core.rounds import RoundState
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sampling.keys import TorchKey

KV_FAMILIES = ("dense",)

# the per-row state IS the round core's state with [B] lengths and an
# ``active`` mask
RowState = RoundState


@dataclass(frozen=True)
class BatchedEngineConfig:
    gamma: int = 4
    max_new_tokens: int = 32
    greedy: bool = True
    temperature: float = 1.0
    draft_policy: str = "linear"        # or "tree" (cached W-chain tree
    draft_k: int = 2                    # rounds; draft_k = tree width)


class BatchedSpecEngine:
    def __init__(self, target_model, drafter_model, ecfg: BatchedEngineConfig,
                 placement=None, tracer=None):
        """``placement``: run per-row rounds placed (``placed_round``,
        linear cached rounds only, as ``PlacedRound`` checks). Otherwise an
        ENABLED ``tracer`` (repro_torch.obs) builds ``traced_round``, the
        phase-split round with draft/verify/commit spans; with neither both
        stay None and tracing adds no sync and no launch."""
        if (target_model.family not in KV_FAMILIES
                or drafter_model.family not in KV_FAMILIES):
            raise ValueError("per-row speculation needs KV-cache families, got "
                             f"{target_model.family}/{drafter_model.family}")
        self.target = target_model
        self.drafter = drafter_model
        self.ecfg = ecfg
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._round_spec = rounds.RoundSpec(
            gamma=ecfg.gamma, greedy=ecfg.greedy,
            temperature=ecfg.temperature, commit="per_row", use_cache=True,
            policy=rounds.make_policy(ecfg.draft_policy, ecfg.draft_k))
        self.placement = (placement if placement is not None
                          and placement.heterogeneous else None)
        self.placed_round = self.traced_round = None
        if self.placement is not None:
            self.placed_round = rounds.PlacedRound(
                self.target, self.drafter, self._round_spec, self.placement,
                tracer=self.tracer)
        elif self.tracer.enabled:
            self.traced_round = rounds.TracedRound(
                self.target, self.drafter, self._round_spec, self.tracer)

    def round(self, params_t, params_d, st: RowState) -> RowState:
        return rounds.spec_round(self.target, self.drafter, params_t,
                                 params_d, st, self._round_spec)

    def generate(self, params_t, params_d, prompt, max_new_tokens=None,
                 key=None):
        """Per-row rounds on ring caches until every row has
        ``max_new_tokens`` new tokens (default: the config's); sampled
        rounds draw with ``key``. Returns (tokens [B, P + max_new + gamma
        + 2], lengths [B], stats)."""
        e = self.ecfg
        max_new = max_new_tokens or e.max_new_tokens
        prompt = _prompt_on(prompt, params_t)
        B, P = prompt.shape
        dev = prompt.device
        max_len = P + max_new + e.gamma + 2
        buf = torch.zeros((B, max_len), dtype=torch.int32, device=dev)
        buf[:, :P] = prompt
        tcache, dcache = init_rings(
            self.target, self.drafter, params_t, params_d, prompt, max_len,
            ring_slack(e.gamma, self._round_spec.policy), e.gamma)
        # promote the shared scalar index to a per-row vector
        row_index = torch.full((B,), P - 1, dtype=torch.int32, device=dev)
        st = RowState(tokens=buf,
                      length=torch.full((B,), P, dtype=torch.int32, device=dev),
                      dcache={**dcache, "index": row_index},
                      tcache={**tcache, "index": row_index.clone()},
                      key=key if key is not None else TorchKey(0),
                      active=torch.ones((B,), dtype=torch.bool, device=dev),
                      n_rounds=torch.zeros((), dtype=torch.int32, device=dev),
                      n_accepted=torch.zeros((B,), dtype=torch.int32, device=dev),
                      n_drafted=torch.zeros((), dtype=torch.int32, device=dev))
        if self.placement is not None:
            params_t = self.placement.target.put_params(self.target, params_t)
            params_d = self.placement.drafter.put_params(self.drafter,
                                                         params_d)
            st = rounds.place_state(st, self.placement, self.target,
                                    self.drafter)
        round_fn = self.placed_round or self.traced_round or self.round
        target_len = P + max_new
        while int(st.length.min()) < target_len:
            st = round_fn(params_t, params_d, st)
        stats = {"rounds": int(st.n_rounds),
                 "alpha_hat_per_row": (st.n_accepted.float()
                                       / max(int(st.n_rounds) * e.gamma, 1)),
                 "lengths": st.length}
        return st.tokens, st.length, stats
