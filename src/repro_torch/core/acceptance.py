"""Greedy speculative acceptance (port of the greedy part of
``repro/core/acceptance.py``).

Paper §IV: "greedy sampling is used across all experiments" — acceptance is
exact match: accept while argmax_p == draft token, then emit the target
argmax at the first mismatch (or the bonus position). ``verify_greedy`` is
the plain version; ``kernels.spec_verify.verify_greedy_fused`` computes the
argmax with the CUDA kernel and shares the epilogue below.
``verify_tree_greedy`` checks every chain of a chain tree against one
stacked target pass. The stochastic variants wait for later slices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class VerifyResult(NamedTuple):
    n_accepted: torch.Tensor    # [B] int32 — accepted draft tokens (0..gamma)
    out_tokens: torch.Tensor    # [B, gamma+1] int32 — committed tokens (padded)
    n_emitted: torch.Tensor     # [B] int32 — n_accepted + 1 (bonus or correction)


def verify_from_argmax(draft_tokens, tgt) -> VerifyResult:
    """The acceptance epilogue on the target argmax ``tgt`` [B, G+1]."""
    B, G = draft_tokens.shape
    match = tgt[:, :G] == draft_tokens
    n_accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    extra = torch.gather(tgt, 1, n_accepted[:, None].long())[:, 0]
    pos = torch.arange(G + 1, device=tgt.device)[None, :]
    drafts_pad = F.pad(draft_tokens, (0, 1))
    zero = torch.zeros((), dtype=drafts_pad.dtype, device=tgt.device)
    out = torch.where(pos < n_accepted[:, None], drafts_pad, zero)
    out = torch.where(pos == n_accepted[:, None], extra[:, None].to(out.dtype), out)
    return VerifyResult(n_accepted.to(torch.int32), out.to(torch.int32),
                        (n_accepted + 1).to(torch.int32))


def verify_greedy(draft_tokens, p_logits) -> VerifyResult:
    """draft_tokens: [B, G]; p_logits: [B, G+1, V] target logits."""
    return verify_from_argmax(draft_tokens, torch.argmax(p_logits, dim=-1))


# --------------------------------------------------------------- tree verify
class TreeVerifyResult(NamedTuple):
    winner: torch.Tensor        # [B] int32 — accepted chain (0 when none)
    n_accepted: torch.Tensor    # [B] int32 — accepted path tokens (0..depth)
    out_tokens: torch.Tensor    # [B, depth+1] int32 — committed (padded)
    n_emitted: torch.Tensor     # [B] int32 — n_accepted + 1


def _winner_result(res, n_em, B, W) -> TreeVerifyResult:
    """Pick the best chain from a flattened [B*W] VerifyResult."""
    winner = torch.argmax(n_em, dim=1).to(torch.int32)   # ties -> chain 0
    rows = torch.arange(B, device=n_em.device)

    def take(x):
        return x.reshape(B, W, *x.shape[1:])[rows, winner.long()]
    return TreeVerifyResult(winner, take(res.n_accepted), take(res.out_tokens),
                            take(res.n_emitted))


def verify_tree_greedy(draft_chains, p_logits_tree, chain_slots) -> TreeVerifyResult:
    """Greedy tree verification: every chain is checked against the ONE
    stacked target pass, the chain with the most emitted tokens wins (ties
    break to chain 0, keeping width-1 trees identical to the linear round).

    draft_chains:  [B, W, D] drafted tokens, level-major chains
    p_logits_tree: [B, span, V] target logits over [last committed, nodes]
    chain_slots:   [W, D] int32 — slot of chain w's level-l node
                   (core.tree.ChainTree.chain_slots)

    The argmax goes through the greedy-verify dispatch
    (``kernels.ops.verify_greedy``): one kernel launch over all B*W*(D+1)
    rows on the card, the plain version on the CPU. Both take the first
    maximum, as the JAX version's jnp argmax does."""
    from repro_torch.kernels import ops as kernel_ops
    B, W, D = draft_chains.shape
    cs = torch.as_tensor(chain_slots, dtype=torch.long,
                         device=p_logits_tree.device)
    slots = torch.cat([torch.zeros((W, 1), dtype=torch.long, device=cs.device),
                       cs], dim=1)                          # [W, D+1]
    per_chain = p_logits_tree[:, slots]                     # [B, W, D+1, V]
    res = kernel_ops.verify_greedy(draft_chains.reshape(B * W, D),
                                   per_chain.reshape(B * W, D + 1, -1))
    return _winner_result(res, res.n_emitted.reshape(B, W), B, W)
