"""The speculative round core: draft -> verify -> commit -> rollback
(port of the linear, cached, per-row, greedy subset of
``repro/core/rounds.py``).

Every round of the paged server runs ``spec_round`` (or ``ar_round`` when
the cost model says drafting does not pay). A round drafts gamma tokens per
row with the drafter's cached single-token steps, verifies them in ONE
target pass over ``[t_last, d_1..d_gamma]``, commits each row's own
accepted prefix plus the correction/bonus token (``per_row`` commits) and
rolls both caches back by index.

Greedy verification dispatches by device: the fused CUDA argmax kernel
(``kernels.spec_verify``) for a CUDA tensor, the plain version
(``core.acceptance``) for a CPU tensor. Both give the same tokens. The
JAX switch ``RoundSpec.fused_verify``, which could route a GPU tensor away
from the kernel, is left out.

Everything stays on the device: the round-level live bound (``_live0``)
is a 0-dim device tensor handed to the attention kernel, so a round issues
no host sync. Batch-synchronized commits, sampled acceptance, stateful
drafters, multi-draft and tree policies, and the placed and traced round
runners wait for later slices.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import torch

from repro_torch.cache import ops as cache_ops
from repro_torch.core import acceptance


# ==================================================================== state
class RoundState(NamedTuple):
    """The generation state every round threads through: per-row ``[B]``
    lengths, an ``active`` mask (frozen slots draft along but commit
    nothing; None = all rows live) and the two paged caches."""
    tokens: torch.Tensor           # [B, T] token buffer
    length: torch.Tensor           # [B] committed tokens
    dcache: Any = None
    tcache: Any = None
    active: Any = None             # [B] bool or None (= all rows live)
    n_rounds: Any = 0              # scalar
    n_accepted: Any = 0            # [B]
    n_drafted: Any = 0             # scalar


class DraftOut(NamedTuple):
    """Draft-phase output: one chain of gamma tokens per row."""
    drafts: torch.Tensor           # [B, 1, G] drafted tokens
    t_last: torch.Tensor           # [B] last committed token
    dcache: Any = None


class VerifyOut(NamedTuple):
    """Verify-phase output: per-row acceptance + the commit base buffer."""
    res: acceptance.VerifyResult
    base_tokens: torch.Tensor      # [B, T] buffer the commit scatters into
    tcache: Any = None


def _gather_last(tokens, length):
    """tokens[b, length[b]-1] per row."""
    lvec = length.expand(tokens.shape[0]) if length.ndim == 0 else length
    return torch.gather(tokens, 1, (lvec - 1)[:, None].long())[:, 0]


# ================================================================= policies
@dataclass(frozen=True)
class LinearDraftPolicy:
    """Classic speculative sampling: ONE chain of gamma sequential greedy
    draft steps per row, each a cached single-token drafter step."""
    name: str = "linear"

    def draft_cached(self, drafter, params_d, state: RoundState, spec,
                     live0) -> DraftOut:
        t_last = _gather_last(state.tokens, state.length)
        tok, cache = t_last, state.dcache
        drafts = []
        for i in range(spec.gamma):
            ml = None if live0 is None else live0 + i
            logits, cache, _ = drafter.apply(params_d, tok[:, None], cache,
                                             logits_slice="last", max_live=ml)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            drafts.append(tok)
        drafts = torch.stack(drafts, dim=1)                    # [B, G]
        return DraftOut(drafts=drafts[:, None], t_last=t_last, dcache=cache)


# ===================================================================== spec
@dataclass(frozen=True)
class RoundSpec:
    """Static parameterization of one round: cached, greedy, per-row."""
    gamma: int = 4
    policy: Any = field(default_factory=LinearDraftPolicy)

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")
        if getattr(self.policy, "name", "") != "linear":
            raise NotImplementedError("only linear drafting is ported")

    @property
    def drafted_per_round(self) -> int:
        return self.gamma


def _live0(state: RoundState):
    """Round-level live-token bound for the paged block-scan reads."""
    return cache_ops.ops_for(state.tcache).live_bound(state.length,
                                                      state.active)


# =================================================================== phases
def draft_phase(drafter, params_d, state: RoundState,
                spec: RoundSpec) -> DraftOut:
    """Phase 1: run the draft policy."""
    return spec.policy.draft_cached(drafter, params_d, state, spec,
                                    _live0(state))


def _greedy_verify(drafts, p_logits):
    """Greedy acceptance through the argmax kernel's wrapper, which takes
    the plain version for a CPU tensor."""
    from repro_torch.kernels import ops as kernel_ops
    return kernel_ops.verify_greedy(drafts, p_logits)


def verify_phase(target, params_t, state: RoundState, d: DraftOut,
                 spec: RoundSpec) -> VerifyOut:
    """Phase 2: one cached target pass over [t_last, d_1..d_G] + acceptance."""
    drafts = d.drafts[:, 0]
    verify_in = torch.cat([d.t_last[:, None], drafts], dim=1)
    ml = _live0(state) + spec.gamma
    p_logits, tcache, _ = target.apply(params_t, verify_in, state.tcache,
                                       max_live=ml)
    res = _greedy_verify(drafts, p_logits)
    return VerifyOut(res=res, base_tokens=state.tokens, tcache=tcache)


def _scatter_commit(tokens, length, out_tokens, n_eff, gamma):
    """THE commit: write each row's emitted prefix at its own offset
    (returns a new buffer)."""
    B, T = tokens.shape
    dev = tokens.device
    pos = torch.arange(gamma + 1, device=dev)[None, :]       # [1, G+1]
    lvec = length.expand(B) if length.ndim == 0 else length
    cols = torch.clamp(lvec[:, None] + pos, 0, T - 1).long()  # [B, G+1]
    keep = pos < n_eff[:, None]
    rows = torch.arange(B, device=dev)[:, None]
    vals = torch.where(keep, out_tokens.to(tokens.dtype), tokens[rows, cols])
    tokens = tokens.clone()
    tokens[rows, cols] = vals
    return tokens


def commit_phase(target, state: RoundState, d: DraftOut, v: VerifyOut,
                 spec: RoundSpec) -> RoundState:
    """Phase 3: commit each row's accepted prefix + roll both caches back."""
    res = v.res
    B = state.tokens.shape[0]
    active = (state.active if state.active is not None
              else torch.ones((B,), dtype=torch.bool, device=state.tokens.device))
    zero = torch.zeros_like(res.n_emitted)
    n_eff = torch.where(active, res.n_emitted, zero)
    tokens = _scatter_commit(v.base_tokens, state.length, res.out_tokens,
                             n_eff, spec.gamma)
    new_len = state.length + n_eff                           # PER ROW
    tcache = cache_ops.ops_for(v.tcache).rollback(v.tcache, new_len - 1)
    dcache = cache_ops.ops_for(d.dcache).rollback(d.dcache, new_len - 1)
    return state._replace(
        tokens=tokens, length=new_len, dcache=dcache, tcache=tcache,
        n_rounds=state.n_rounds + 1,
        n_accepted=state.n_accepted + torch.where(active, res.n_accepted, zero),
        n_drafted=state.n_drafted + spec.drafted_per_round)


# ==================================================================== rounds
def spec_round(target, drafter, params_t, params_d, state: RoundState,
               spec: RoundSpec) -> RoundState:
    """ONE speculative round: the composition of the three phases."""
    d = draft_phase(drafter, params_d, state, spec)
    v = verify_phase(target, params_t, state, d, spec)
    return commit_phase(target, state, d, v, spec)


def ar_round(target, params_t, state: RoundState) -> RoundState:
    """γ*=0 fallback round: one committed greedy token per active row,
    target model only (the cost model said drafting does not pay)."""
    B, T = state.tokens.shape
    dev = state.tokens.device
    rows = torch.arange(B, device=dev)
    ops_t = cache_ops.ops_for(state.tcache)
    lvec = state.length
    t_last = state.tokens[rows, (lvec - 1).long()]
    logits, tcache, _ = target.apply(
        params_t, t_last[:, None], state.tcache, logits_slice="last",
        max_live=ops_t.live_bound(state.length, state.active))
    nxt = torch.argmax(logits[:, -1], dim=-1).to(state.tokens.dtype)
    active = (state.active if state.active is not None
              else torch.ones((B,), dtype=torch.bool, device=dev))
    cols = torch.clamp(lvec, 0, T - 1).long()
    tokens = state.tokens.clone()
    tokens[rows, cols] = torch.where(active, nxt, state.tokens[rows, cols])
    new_len = state.length + active.to(state.length.dtype)
    tcache = ops_t.rollback(tcache, new_len - 1)
    return state._replace(tokens=tokens, length=new_len, tcache=tcache,
                          n_rounds=state.n_rounds + 1)
