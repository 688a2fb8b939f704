"""Single-stream speculative engine (port of ``repro/core/engine.py``).

``SpecEngine`` is the batch-synchronized specialization of the round core
(``core/rounds.py``): every round drafts, verifies and commits through
``rounds.spec_round`` with ``commit="batch_min"`` — the batch-minimum
emitted length is committed, which is exact greedy decoding (discarded
acceptances are re-drafted) and standard speculative sampling at B=1, the
paper's operating point. Two cache modes:

  * ``use_cache=False`` — paper-faithful (§IV: "no KV cache is enabled"):
    every forward recomputes the whole fixed-size token buffer;
    ``draft_policy="multi"`` (k-candidate drafting) is available.
  * ``use_cache=True`` — the production path: ring KV caches (dense) or
    recurrent state caches (ssm) filled by a prefill over the prompt, with
    O(1) / trail rollback through the CacheOps seam (``repro_torch.cache.
    ops``); ``draft_policy="tree"`` (ring rows replicated per branch) is
    available, and an ssm drafter runs as a stateful drafter.

Both strategies run one host loop of rounds, reading the committed length
once per round: PyTorch runs eagerly, so JAX's "monolithic" strategy (the
whole loop as one jitted ``while_loop``) has no counterpart here, and
"modular" is the same loop. They differ under an enabled ``tracer`` as
JAX's do: monolithic puts one ``generate`` span (phase "round") over the
whole loop, synchronized before it closes, as over JAX's fused loop;
modular runs each round as a ``rounds.TracedRound`` (draft/verify/commit
spans tagged ``round=k``). ``autoregressive_generate`` is the
non-speculative baseline, with or without a cache.

``EngineConfig(greedy=False, temperature=T)`` samples (speculative
sampling: drafts drawn from the drafter, the stochastic acceptance rule,
so the tokens follow the target's distribution); ``generate(key=)`` and
``autoregressive_generate(key=)`` take a key (``sampling.keys``; default
``TorchKey(0)``, where JAX defaults to ``PRNGKey(0)``), split as JAX
splits its own, so a key handing out ``jax.random``'s bits replays JAX's
tokens.

``SpecEngine(placement=)`` (``api/placement.py``, lowered from the plan's
PlacementPlan) runs cached linear generation on ``rounds.PlacedRound``:
the draft on the drafter's device, verify and commit on the target's, the
gamma-token package handed across. With the plan's ``overlap`` armed, the
loop dispatches round k+1 before the host waits for round k's committed
length. The placed path takes precedence over either strategy; what it
cannot run (no-cache, multi or tree drafts, stateful drafters) keeps the
unplaced path, and ``placement_note`` says why.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import device as devices
from repro_torch.cache.ops import RING
from repro_torch.core import rounds
from repro_torch.core.rounds import (RoundState, _slice_logits, _slice_tokens,
                                     _write_col, next_token)
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sampling.keys import TorchKey

STRATEGIES = ("monolithic", "modular")
STATEFUL_FAMILIES = ("ssm",)


@dataclass(frozen=True)
class EngineConfig:
    gamma: int = 4
    greedy: bool = True                 # paper §IV uses greedy everywhere
    temperature: float = 1.0
    use_cache: bool = False             # False = paper-faithful mode
    strategy: str = "monolithic"        # or "modular": the same host loop here
    draft_policy: str = "linear"        # "multi" (greedy no-cache only) or
                                        # "tree" (cached, greedy or sampled)
    draft_k: int = 2                    # candidates per row for "multi";
                                        # tree width for "tree"


def ring_slack(gamma: int, policy) -> int:
    """Ring slots past the committed length a round may write: gamma + 1
    unverified slots for linear rounds, a tree's whole span (1 + width *
    gamma) for tree rounds, plus one."""
    if getattr(policy, "name", "") == "tree":
        return 1 + policy.width * gamma + 1
    return gamma + 2


def init_rings(target, drafter, params_t, params_d, prompt, max_len, slack,
               gamma):
    """Ring (or state) caches for both models, each prefilled with
    ``prompt[:, :-1]`` (the last prompt token is the first round's input).
    ``max_len`` is the token buffer's length, P + max_new + gamma + 2; the
    rings hold ``max_len - (gamma + 2) + slack`` positions, which adds what
    a tree round's span writes past a linear round's (JAX sizes them at
    ``max_len`` and lets the last tree round wrap its ring, reading that
    round through a concat; the identity view needs the span to fit). The
    prefills unembed only the last position: their logits are not used,
    and the written caches are the same."""
    B, P = prompt.shape
    cap = max_len - (gamma + 2) + slack
    dev = prompt.device
    tcache = RING.init(target, B, max_len=cap, spec_slack=slack, device=dev)
    dcache = RING.init(drafter, B, max_len=cap, spec_slack=slack, device=dev)
    if P > 1:
        _, tcache, _ = target.apply(params_t, prompt[:, :-1], tcache,
                                    logits_slice="last")
        _, dcache, _ = drafter.apply(params_d, prompt[:, :-1], dcache,
                                     logits_slice="last")
    return tcache, dcache


def _prompt_on(prompt, params):
    dev = params["embed"]["table"].device
    return torch.as_tensor(prompt, device=dev).to(torch.int32)


class SpecEngine:
    """Drives a (target, drafter) pair with speculative decoding (greedy,
    or speculative sampling) on the device of the parameters, or placed
    (``placement``; see the module docstring)."""

    def __init__(self, target_model, drafter_model, ecfg: EngineConfig,
                 placement=None, tracer=None):
        if ecfg.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}, "
                             f"got {ecfg.strategy!r}")
        self.target = target_model
        self.drafter = drafter_model
        self.ecfg = ecfg
        self.d_stateful = drafter_model.family in STATEFUL_FAMILIES
        self._policy = rounds.make_policy(ecfg.draft_policy, ecfg.draft_k)
        self._spec = rounds.RoundSpec(
            gamma=ecfg.gamma, greedy=ecfg.greedy, temperature=ecfg.temperature,
            commit="batch_min", use_cache=ecfg.use_cache,
            d_stateful=self.d_stateful and ecfg.use_cache, policy=self._policy)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._traced_round = None
        self.placement = None
        self.placement_note = ""
        self._placed_round = None
        if placement is not None and placement.heterogeneous:
            if not ecfg.use_cache:
                self.placement_note = "no-cache rounds are single-mesh"
            elif ecfg.draft_policy != "linear":
                self.placement_note = (f"{ecfg.draft_policy}-draft rounds "
                                       "are single-mesh")
            elif self.d_stateful:
                self.placement_note = "stateful drafters are single-mesh"
            else:
                self.placement = placement
                self._placed_round = rounds.PlacedRound(
                    self.target, self.drafter, self._spec, placement,
                    tracer=self.tracer)

    def round(self, params_t, params_d, state: RoundState) -> RoundState:
        """ONE round in the engine's cache mode."""
        return rounds.spec_round(self.target, self.drafter, params_t,
                                 params_d, state, self._spec)

    def prefill(self, params_t, params_d, prompt, max_len,
                key=None) -> RoundState:
        """The generation state for a [B, P] prompt in a [B, max_len]
        buffer, carrying ``key`` (default ``TorchKey(0)``). No cache:
        nothing is computed until the first round. Cached: both caches
        consume prompt[:, :-1] (``init_rings``)."""
        prompt = _prompt_on(prompt, params_t)
        B, P = prompt.shape
        dev = prompt.device
        buf = torch.zeros((B, max_len), dtype=torch.int32, device=dev)
        buf[:, :P] = prompt

        def zero():
            return torch.zeros((), dtype=torch.int32, device=dev)
        st = RoundState(tokens=buf,
                        length=torch.full((), P, dtype=torch.int32, device=dev),
                        key=key if key is not None else TorchKey(0),
                        n_rounds=zero(), n_accepted=zero(), n_drafted=zero())
        if not self.ecfg.use_cache:
            return st
        tcache, dcache = init_rings(
            self.target, self.drafter, params_t, params_d, prompt, max_len,
            ring_slack(self.ecfg.gamma, self._policy), self.ecfg.gamma)
        # cache-index offset: prefill consumed P-1 text tokens plus any
        # prefix the cache also holds (none for the ported families)
        return st._replace(tcache=tcache, dcache=dcache,
                           t_off=tcache["index"] - (P - 1),
                           d_off=dcache["index"] - (P - 1))

    def _generate_placed(self, params_t, params_d, state, target_len):
        """Round loop on the placed round. Params are pinned onto their
        role's device (the same tensors when already there). With
        ``placement.overlap`` the loop runs one round ahead: round k+1 is
        dispatched before the host blocks on round k's committed length, so
        the card has the next round queued while the host waits, at the
        cost of one extra round at the end, whose result is discarded. That
        round writes the caches in place past the returned state's length
        (masked, and the caches are dropped after the loop); the returned
        state's tokens, length and counters are its own tensors."""
        pm = self.placement
        params_t = pm.target.put_params(self.target, params_t)
        params_d = pm.drafter.put_params(self.drafter, params_d)
        state = rounds.place_state(state, pm, self.target, self.drafter)
        placed = self._placed_round
        if pm.overlap:
            k = 0
            prev = state
            pending = placed(params_t, params_d, prev, round=k)
            while int(prev.length) < target_len:
                k += 1
                prev = pending
                pending = placed(params_t, params_d, prev, round=k)
            return prev
        k = 0
        while int(state.length) < target_len:
            state = placed(params_t, params_d, state, round=k)
            k += 1
        return state

    def generate(self, params_t, params_d, prompt, max_new_tokens, key=None):
        """Returns (tokens [B, length], stats); the last round may commit
        past ``P + max_new_tokens``. ``key`` feeds the sampled rounds."""
        B, P = prompt.shape
        max_len = P + max_new_tokens + self.ecfg.gamma + 2
        state = self.prefill(params_t, params_d, prompt, max_len, key)
        target_len = P + max_new_tokens
        if self._placed_round is not None:
            state = self._generate_placed(params_t, params_d, state,
                                          target_len)
        elif self.tracer.enabled and self.ecfg.strategy == "modular":
            # phase-split traced rounds (draft/verify/commit spans)
            if self._traced_round is None:
                self._traced_round = rounds.TracedRound(
                    self.target, self.drafter, self._spec, self.tracer)
            k = 0
            while int(state.length) < target_len:
                state = self._traced_round(params_t, params_d, state, round=k)
                k += 1
        else:
            # monolithic: one span over the whole loop, as over JAX's fused
            # while_loop (the shared null span when tracing is off)
            with self.tracer.span("generate", phase="round", role="target",
                                  strategy="monolithic"):
                while int(state.length) < target_len:
                    state = self.round(params_t, params_d, state)
                if self.tracer.enabled:
                    devices.synchronize(state.tokens.device)
        n_rounds, n_acc, n_drafted, length = (
            int(x) for x in torch.stack([state.n_rounds, state.n_accepted,
                                         state.n_drafted, state.length]).cpu())
        stats = {"rounds": n_rounds, "accepted": n_acc, "drafted": n_drafted,
                 "alpha_hat": n_acc / max(n_drafted, 1),
                 "tokens_generated": length - P}
        return state.tokens[:, :length], stats


def autoregressive_generate(model, params, prompt, max_new_tokens, *,
                            greedy=True, temperature=1.0, key=None,
                            use_cache=False):
    """The non-speculative baseline (the paper's 'standard sampling') over
    a [B, P + max_new_tokens] buffer, returned whole: each token the
    argmax, or (``greedy=False``) a draw from softmax(logits /
    temperature) with a child of ``key`` (default ``TorchKey(0)``; one
    split per token, as in JAX). No cache: ``max_new_tokens`` full-buffer
    passes. Cached: one prefill over the prompt (its last position gives
    the first token), then one single-token cached step per further
    token."""
    prompt = _prompt_on(prompt, params)
    B, P = prompt.shape
    dev = prompt.device
    max_len = P + max_new_tokens
    buf = torch.zeros((B, max_len), dtype=torch.int32, device=dev)
    buf[:, :P] = prompt
    length = torch.full((), P, dtype=torch.int32, device=dev)
    key = key if key is not None else TorchKey(0)
    if use_cache:
        cache = model.init_cache(B, model.cache_len(max_len), spec_slack=2,
                                 device=dev)
        logits, cache, _ = model.apply(params, prompt, cache,
                                       logits_slice="last")
        for i in range(max_new_tokens):
            if i:
                logits, cache, _ = model.apply(
                    params, _slice_tokens(buf, length - 1, 1), cache,
                    logits_slice="last")
            nxt, key = next_token(logits[:, -1], greedy, temperature, key)
            buf = _write_col(buf, length, nxt)
            length = length + 1
        return buf
    for _ in range(max_new_tokens):
        logits, _, _ = model.apply(params, buf)
        q = _slice_logits(logits, length - 1, 1)[:, 0]
        nxt, key = next_token(q, greedy, temperature, key)
        buf = _write_col(buf, length, nxt)
        length = length + 1
    return buf
