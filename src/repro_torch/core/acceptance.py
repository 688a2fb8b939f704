"""Greedy speculative acceptance (port of the greedy part of
``repro/core/acceptance.py``).

Paper §IV: "greedy sampling is used across all experiments" — acceptance is
exact match: accept while argmax_p == draft token, then emit the target
argmax at the first mismatch (or the bonus position). ``verify_greedy`` is
the plain version; ``kernels.spec_verify.verify_greedy_fused`` computes the
argmax with the CUDA kernel and shares the epilogue below. The stochastic
and tree variants wait for later slices.
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
