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
  * ``use_cache=True`` — the production path: ring KV caches (dense),
    recurrent state caches (ssm) or both (hybrid) filled by a prefill over
    the prompt, with O(1) / trail rollback through the CacheOps seam
    (``repro_torch.cache.ops``); ``draft_policy="tree"`` (ring rows
    replicated per branch) is available, and an ssm or hybrid drafter runs
    as a stateful drafter.

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

Modality extras (``generate(extras_t=, extras_d=)``, each model's
``Model.apply`` keywords: the VLM's ``patches``, the encoder-decoder's
``frames``) follow JAX's semantics. No cache: every forward takes them,
so each no-cache encoder-decoder pass runs the encoder again. Cached: the
prefill consumes them (a VLM's vision prefix lands in the ring even for a
one-token prompt) and the decode passes keep only the encoder-decoder's
cross K/V; ``t_off``/``d_off`` shift each cache's index past the vision
prefix.

``SpecEngine(placement=)`` (``api/placement.py``, lowered from the plan's
PlacementPlan) runs cached linear generation on ``rounds.PlacedRound``:
the draft on the drafter's device, verify and commit on the target's, the
gamma-token package handed across. With the plan's ``overlap`` armed, the
loop dispatches round k+1 before the host waits for round k's committed
length. The placed path takes precedence over either strategy; what it
cannot run (no-cache, multi or tree drafts, stateful drafters) keeps the
unplaced path, and ``placement_note`` says why; so does a generation
with modality extras. A tensor-parallel role (``parallel.tp``) gets its
params split by ``put_params`` before the prefill (``split_roles``), so
its prefill runs split into a split ring; given a split params record,
the prefills and ``autoregressive_generate`` make their rings split by
its layout.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import device as devices
from repro_torch.cache.ops import RING
from repro_torch.core import rounds
from repro_torch.core.rounds import (RoundState, _slice_logits, _slice_tokens,
                                     _write_col, next_token)
from repro_torch.models.model import RECURRENT as STATEFUL_FAMILIES
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.parallel import tp
from repro_torch.sampling.keys import TorchKey

STRATEGIES = ("monolithic", "modular")


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


def prefill_rings(target, drafter, params_t, params_d, prompt, max_len, slack,
                  gamma, extras_t=None, extras_d=None):
    """Ring (or state) caches for both models, each prefilled with
    ``prompt[:, :-1]`` (the last prompt token is the first round's input)
    and the model's modality extras (``_prefill``), and each model's
    decode extras: (tcache, dcache, extras_t, extras_d).
    ``max_len`` is the token buffer's length, P + max_new + gamma + 2; the
    rings hold ``max_len - (gamma + 2) + slack`` positions, which adds what
    a tree round's span writes past a linear round's (JAX sizes them at
    ``max_len`` and lets the last tree round wrap its ring, reading that
    round through a concat; the identity view needs the span to fit). A
    windowed config's rings hold window + ``slack`` slots instead, as in
    JAX, and wrap: the slack is what a round writes past the committed
    length, so a round never evicts a key inside the window. The prefills
    unembed only the last position: their logits are not used, and the
    written caches are the same. Each model prefills on its params'
    device; a split params record (``parallel.tp``) prefills split, into
    a ring made split by its layout."""
    B, P = prompt.shape
    cap = max_len - (gamma + 2) + slack
    rings = []
    for model, params, extras in ((target, params_t, extras_t),
                                  (drafter, params_d, extras_d)):
        toks = _prompt_on(prompt, params)
        cache = RING.init(model, B, max_len=cap, spec_slack=slack,
                          device=toks.device, layout=tp.layout_of(params))
        rings.append(_prefill(model, params, toks[:, :-1], cache, extras))
    (tcache, extras_t), (dcache, extras_d) = rings
    return tcache, dcache, extras_t, extras_d


def split_roles(placement, target, drafter, params_t, params_d):
    """(params_t, params_d) with a tensor-parallel role's params split by
    its ``put_params`` (the other role's as given), so that its prefill
    runs split and makes its ring split; a split the heads do not allow
    raises ``PlacementError`` here, before any forward."""
    def one(role, model, params):
        return (role.put_params(model, params)
                if role.layout(model) is not None else params)
    return (one(placement.target, target, params_t),
            one(placement.drafter, drafter, params_d))


def decode_extras(extras, aux):
    """The extras a model's decode passes take after its cached prefill:
    the modality front ends' inputs (``patches``, ``frames``) were
    consumed there and are dropped; the encoder-decoder's cross K/V,
    computed once by the encoder, is kept (None when nothing is left)."""
    out = {k: v for k, v in (extras or {}).items()
           if k not in ("patches", "frames")}
    if "cross" in (aux or {}):
        out["cross"] = aux["cross"]
    return out or None


def _prefill(model, params, tokens, cache, extras):
    """``cache`` after consuming ``tokens`` [B, P - 1] and ``extras``, and
    the decode extras. A VLM's vision prefix is prefilled even when there
    are no text tokens (P = 1); an encoder-decoder with no text tokens
    only encodes its frames."""
    ex = extras or {}
    aux = {}
    if tokens.shape[1] or "patches" in ex:
        _, cache, aux = model.apply(params, tokens, cache, logits_slice="last",
                                    **ex)
    elif "frames" in ex:
        aux = {"cross": model.encode(params, ex["frames"])}
    return cache, decode_extras(ex, aux)


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

    def prefill(self, params_t, params_d, prompt, max_len, extras_t=None,
                extras_d=None, key=None) -> RoundState:
        """The generation state for a [B, P] prompt in a [B, max_len]
        buffer, carrying ``key`` (default ``TorchKey(0)``) and each
        model's modality extras. No cache: nothing is computed until the
        first round, and every forward takes the extras as given. Cached:
        both caches consume prompt[:, :-1] and the extras
        (``prefill_rings``); the state keeps the decode extras (the cross
        K/V; patches and frames are consumed) and the offsets of the cache
        indices past the text (the VLM's vision tokens)."""
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
                        n_rounds=zero(), n_accepted=zero(), n_drafted=zero(),
                        extras_t=extras_t, extras_d=extras_d)
        if not self.ecfg.use_cache:
            return st
        tcache, dcache, ex_t, ex_d = prefill_rings(
            self.target, self.drafter, params_t, params_d, prompt, max_len,
            ring_slack(self.ecfg.gamma, self._policy), self.ecfg.gamma,
            extras_t, extras_d)
        # cache-index offset: prefill consumed P-1 text tokens plus any
        # modality prefix (vision patches) that also landed in the cache
        return st._replace(tcache=tcache, dcache=dcache, extras_t=ex_t,
                           extras_d=ex_d, t_off=tcache["index"] - (P - 1),
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

    def generate(self, params_t, params_d, prompt, max_new_tokens, key=None,
                 extras_t=None, extras_d=None):
        """Returns (tokens [B, length], stats); the last round may commit
        past ``P + max_new_tokens``. ``key`` feeds the sampled rounds;
        ``extras_t``/``extras_d`` are the target's and the drafter's
        modality extras (``Model.apply``'s patches/frames/cross). A
        generation with extras keeps the unplaced path (placed rounds do
        not carry them, as in JAX) and says so in ``placement_note``."""
        B, P = prompt.shape
        max_len = P + max_new_tokens + self.ecfg.gamma + 2
        if self._placed_round is not None:
            params_t, params_d = split_roles(self.placement, self.target,
                                             self.drafter, params_t, params_d)
        state = self.prefill(params_t, params_d, prompt, max_len, extras_t,
                             extras_d, key)
        target_len = P + max_new_tokens
        placed = self._placed_round is not None
        if placed and (state.extras_t or state.extras_d):
            self.placement_note = "modality extras are single-mesh"
            placed = False
        if placed:
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
                            use_cache=False, extras=None):
    """The non-speculative baseline (the paper's 'standard sampling') over
    a [B, P + max_new_tokens] buffer, returned whole: each token the
    argmax, or (``greedy=False``) a draw from softmax(logits /
    temperature) with a child of ``key`` (default ``TorchKey(0)``; one
    split per token, as in JAX). No cache: ``max_new_tokens`` full-buffer
    passes. Cached: one prefill over the prompt (its last position gives
    the first token), then one single-token cached step per further
    token. ``extras`` (``Model.apply``'s patches/frames/cross) go to
    every no-cache pass; cached, the prefill takes them and the steps
    their decode extras (``decode_extras``)."""
    prompt = _prompt_on(prompt, params)
    ex = extras or {}
    B, P = prompt.shape
    dev = prompt.device
    max_len = P + max_new_tokens
    buf = torch.zeros((B, max_len), dtype=torch.int32, device=dev)
    buf[:, :P] = prompt
    length = torch.full((), P, dtype=torch.int32, device=dev)
    key = key if key is not None else TorchKey(0)
    if use_cache:
        cache = model.init_cache(B, model.cache_len(max_len), spec_slack=2,
                                 device=dev, layout=tp.layout_of(params))
        logits, cache, aux = model.apply(params, prompt, cache,
                                         logits_slice="last", **ex)
        ex = decode_extras(ex, aux) or {}
        for i in range(max_new_tokens):
            if i:
                logits, cache, _ = model.apply(
                    params, _slice_tokens(buf, length - 1, 1), cache,
                    logits_slice="last", **ex)
            nxt, key = next_token(logits[:, -1], greedy, temperature, key)
            buf = _write_col(buf, length, nxt)
            length = length + 1
        return buf
    for _ in range(max_new_tokens):
        logits, _, _ = model.apply(params, buf, **ex)
        q = _slice_logits(logits, length - 1, 1)[:, 0]
        nxt, key = next_token(q, greedy, temperature, key)
        buf = _write_col(buf, length, nxt)
        length = length + 1
    return buf
