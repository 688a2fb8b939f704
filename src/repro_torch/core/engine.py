"""Single-stream speculative engine, paper-faithful no-cache mode (port of
the no-cache greedy part of ``repro/core/engine.py``).

``SpecEngine`` is the batch-synchronized specialization of the round core
(``core/rounds.py``): every round drafts, verifies and commits through
``rounds.spec_round`` with ``commit="batch_min"`` — the batch-minimum
emitted length is committed, which is exact greedy decoding (discarded
acceptances are re-drafted) and standard speculative sampling at B=1, the
paper's operating point. With ``use_cache=False`` (§IV: "no KV cache is
enabled") every forward recomputes the whole fixed-size token buffer, and
``draft_policy="multi"`` (k-candidate drafting) is available.

Both strategies run one host loop of rounds, reading the committed length
once per round: PyTorch runs eagerly, so JAX's "monolithic" strategy (the
whole loop as one jitted ``while_loop``) has no counterpart here, and
"modular" is the same loop. ``autoregressive_generate`` is the
non-speculative baseline. Greedy only; sampling, the cached (ring-cache)
engine, placement and the tracer wait for later slices.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import rounds
from repro_torch.core.rounds import (RoundState, _slice_logits, _write_col)

STRATEGIES = ("monolithic", "modular")


def _no_ring_cache():
    return NotImplementedError(
        "use_cache=True runs on the ring KV cache, which a later slice "
        "ports; the cached path available today is the paged server "
        "(repro_torch.serving.PagedSpecServer)")


@dataclass(frozen=True)
class EngineConfig:
    gamma: int = 4
    use_cache: bool = False             # False = paper-faithful mode
    strategy: str = "monolithic"        # or "modular": the same host loop here
    draft_policy: str = "linear"        # or "multi" (greedy no-cache only)
    draft_k: int = 2                    # candidates per row for "multi"


def _prompt_on(prompt, params):
    dev = params["embed"]["table"].device
    return torch.as_tensor(prompt, device=dev).to(torch.int32)


class SpecEngine:
    """Drives a (target, drafter) pair with greedy speculative decoding on
    the device of the parameters."""

    def __init__(self, target_model, drafter_model, ecfg: EngineConfig):
        if ecfg.use_cache:
            raise _no_ring_cache()
        if ecfg.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}, "
                             f"got {ecfg.strategy!r}")
        self.target = target_model
        self.drafter = drafter_model
        self.ecfg = ecfg
        self._spec = rounds.RoundSpec(
            gamma=ecfg.gamma, commit="batch_min", use_cache=False,
            policy=rounds.make_policy(ecfg.draft_policy, ecfg.draft_k))

    def round_nocache(self, params_t, params_d, state: RoundState) -> RoundState:
        return rounds.spec_round(self.target, self.drafter, params_t,
                                 params_d, state, self._spec)

    def prefill(self, params_t, params_d, prompt, max_len) -> RoundState:
        """The generation state for a [B, P] prompt in a [B, max_len]
        buffer. No cache: nothing is computed until the first round."""
        prompt = _prompt_on(prompt, params_t)
        B, P = prompt.shape
        dev = prompt.device
        buf = torch.zeros((B, max_len), dtype=torch.int32, device=dev)
        buf[:, :P] = prompt

        def zero():
            return torch.zeros((), dtype=torch.int32, device=dev)
        return RoundState(tokens=buf,
                          length=torch.full((), P, dtype=torch.int32, device=dev),
                          n_rounds=zero(), n_accepted=zero(), n_drafted=zero())

    def generate(self, params_t, params_d, prompt, max_new_tokens):
        """Returns (tokens [B, length], stats); the last round may commit
        past ``P + max_new_tokens``."""
        B, P = prompt.shape
        max_len = P + max_new_tokens + self.ecfg.gamma + 2
        state = self.prefill(params_t, params_d, prompt, max_len)
        target_len = P + max_new_tokens
        while int(state.length) < target_len:
            state = self.round_nocache(params_t, params_d, state)
        n_rounds, n_acc, n_drafted, length = (
            int(x) for x in torch.stack([state.n_rounds, state.n_accepted,
                                         state.n_drafted, state.length]).cpu())
        stats = {"rounds": n_rounds, "accepted": n_acc, "drafted": n_drafted,
                 "alpha_hat": n_acc / max(n_drafted, 1),
                 "tokens_generated": length - P}
        return state.tokens[:, :length], stats


def autoregressive_generate(model, params, prompt, max_new_tokens, *,
                            use_cache=False):
    """The non-speculative greedy baseline (the paper's 'standard
    sampling'): ``max_new_tokens`` full-buffer passes over a
    [B, P + max_new_tokens] buffer. Returns the buffer."""
    if use_cache:
        raise _no_ring_cache()
    prompt = _prompt_on(prompt, params)
    B, P = prompt.shape
    dev = prompt.device
    buf = torch.zeros((B, P + max_new_tokens), dtype=torch.int32, device=dev)
    buf[:, :P] = prompt
    length = torch.full((), P, dtype=torch.int32, device=dev)
    for _ in range(max_new_tokens):
        logits, _, _ = model.apply(params, buf)
        q = _slice_logits(logits, length - 1, 1)[:, 0]
        buf = _write_col(buf, length, torch.argmax(q, dim=-1))
        length = length + 1
    return buf
