"""Speculative acceptance (port of ``repro/core/acceptance.py``).

Sampled mode is the speculative-sampling rule (Leviathan et al., App. A):
a drafted token x is accepted with probability min(1, p(x)/q(x)); at the
first rejection the replacement is drawn from norm(max(0, p - q)), and
after a full accept a bonus token from p. This keeps the target
distribution exactly. ``verify_stochastic`` is that rule vectorized over
[B, gamma]; ``verify_tree_stochastic`` is its multi-path form over a chain
tree's W i.i.d. root heads (recursive rejection), which at W = 1 draws and
decides exactly as ``verify_stochastic``. Both take a key
(``sampling.keys``) and split it in JAX's order, with JAX's epsilons (the
1e-20 floor of the uniforms, the residual's fallback to p, the 1e-30 in
its log), so that ``jax.random``'s bits give JAX's tokens. They stay
PyTorch on the card, as they stay jnp in JAX: no Pallas kernel covers them.

Paper §IV: "greedy sampling is used across all experiments" — greedy
acceptance is exact match: accept while argmax_p == draft token, then emit
the target argmax at the first mismatch (or the bonus position).
``verify_greedy`` is the plain version; ``kernels.spec_verify.
verify_greedy_fused`` computes the argmax with the CUDA kernel and shares
the epilogue below. ``verify_tree_greedy`` checks every chain of a chain
tree against one stacked target pass.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.sampling.keys import categorical


class VerifyResult(NamedTuple):
    n_accepted: torch.Tensor    # [B] int32 — accepted draft tokens (0..gamma)
    out_tokens: torch.Tensor    # [B, gamma+1] int32 — committed tokens (padded)
    n_emitted: torch.Tensor     # [B] int32 — n_accepted + 1 (bonus or correction)


def _result(draft_tokens, n_accepted, extra) -> VerifyResult:
    """[accepted drafts..., extra, 0-padding] per row, and the counts."""
    G = draft_tokens.shape[1]
    pos = torch.arange(G + 1, device=draft_tokens.device)[None, :]
    drafts_pad = F.pad(draft_tokens, (0, 1))
    zero = torch.zeros((), dtype=drafts_pad.dtype, device=drafts_pad.device)
    out = torch.where(pos < n_accepted[:, None], drafts_pad, zero)
    out = torch.where(pos == n_accepted[:, None], extra[:, None].to(out.dtype), out)
    return VerifyResult(n_accepted.to(torch.int32), out.to(torch.int32),
                        (n_accepted + 1).to(torch.int32))


def _accepted_prefix(accept):
    """[B, G] bool -> [B]: the leading run of accepts (the first rejection
    truncates)."""
    return torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)


def verify_from_argmax(draft_tokens, tgt) -> VerifyResult:
    """The acceptance epilogue on the target argmax ``tgt`` [B, G+1]."""
    G = draft_tokens.shape[1]
    n_accepted = _accepted_prefix(tgt[:, :G] == draft_tokens)
    extra = torch.gather(tgt, 1, n_accepted[:, None].long())[:, 0]
    return _result(draft_tokens, n_accepted, extra)


def verify_greedy(draft_tokens, p_logits) -> VerifyResult:
    """draft_tokens: [B, G]; p_logits: [B, G+1, V] target logits."""
    return verify_from_argmax(draft_tokens, torch.argmax(p_logits, dim=-1))


def _take(logp, tokens):
    """logp [..., V] at ``tokens`` [...]."""
    return torch.gather(logp, -1, tokens.long()[..., None])[..., 0]


def _at(x, idx):
    """x [B, G, V] at row-wise position idx [B] -> [B, V]."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def _residual(p, q):
    """max(p - q, 0), or p where that is all (numerically) zero."""
    r = torch.clamp_min(p - q, 0.0)
    return torch.where(r.sum(-1, keepdim=True) > 1e-9, r, p)


def verify_stochastic(key, draft_tokens, q_logits, p_logits,
                      temperature=1.0) -> VerifyResult:
    """Vectorized accept/reject + residual resample.

    draft_tokens: [B, G] tokens proposed by the drafter
    q_logits:     [B, G, V] drafter logits for those positions
    p_logits:     [B, G+1, V] target logits (G draft positions + 1 bonus)
    Token layout of out_tokens[b]: [accepted drafts..., replacement-or-
    bonus, 0-padding]."""
    B, G = draft_tokens.shape
    t = max(temperature, 1e-6)
    logq = torch.log_softmax(q_logits / t, dim=-1)
    logp = torch.log_softmax(p_logits[:, :G] / t, dim=-1)
    k_acc, k_res, k_bonus = key.split(3)
    u = k_acc.uniform((B, G), 1e-20, draft_tokens.device)
    accept = torch.log(u) < (_take(logp, draft_tokens) - _take(logq, draft_tokens))
    n_accepted = _accepted_prefix(accept)
    # the residual at the first rejected position (clamped for the gather)
    first_rej = torch.clamp_max(n_accepted, G - 1)
    residual = _residual(torch.exp(_at(logp, first_rej)),
                         torch.exp(_at(logq, first_rej)))
    resampled = categorical(k_res, torch.log(residual + 1e-30))
    # the bonus token when all drafts are accepted: p at position G
    bonus = categorical(k_bonus, torch.log_softmax(p_logits[:, G] / t, dim=-1))
    extra = torch.where(n_accepted == G, bonus, resampled)
    return _result(draft_tokens, n_accepted, extra)


def empirical_alpha(n_accepted, gamma) -> torch.Tensor:
    """Per-round acceptance-rate estimate: accepted / drafted (the paper's
    alpha)."""
    return n_accepted.float() / float(gamma)


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


def verify_tree_stochastic(key, draft_chains, q_logits_chains, p_logits_tree,
                           chain_slots, temperature=1.0) -> TreeVerifyResult:
    """Lossless multi-path rejection sampling over a chain tree.

    The W root heads are i.i.d. draws from the drafter's root distribution
    q, so recursive rejection sampling applies (SpecInfer / SpecTr): head i
    is tested against p_i, with p_1 = p and p_{i+1} = norm(max(p_i - q, 0));
    the first accepted head selects its chain, which continues with the
    linear accept/reject down the levels. If every head is rejected, the
    root is resampled from the last residual. For W == 1 this is
    ``verify_stochastic`` draw for draw (same splits, uniforms and
    epsilons).

    draft_chains:    [B, W, D] drafted tokens
    q_logits_chains: [B, W, D, V] drafter logits along each chain (level 1
                     holds the shared root distribution)
    p_logits_tree:   [B, span, V] target logits over [last committed, nodes]
    chain_slots:     [W, D] slot of chain w's level-l node
    ``winner`` is meaningful only when ``n_accepted > 0``."""
    B, W, D = draft_chains.shape
    dev = draft_chains.device
    t = max(temperature, 1e-6)
    k_acc, k_res, k_bonus = key.split(3)
    u = k_acc.uniform((B, W + D - 1), 1e-20, dev)

    # ---- root: recursive rejection over the W i.i.d. heads
    logq_root = torch.log_softmax(q_logits_chains[:, 0, 0] / t, dim=-1)
    q_root = torch.exp(logq_root)                            # [B, V]
    logp_root = torch.log_softmax(p_logits_tree[:, 0] / t, dim=-1)
    p_cur = torch.exp(logp_root)                             # p_i, normalized
    resid_unnorm = p_cur                                     # max(p_i - q, 0) | p_i
    root_acc = torch.zeros((B,), dtype=torch.bool, device=dev)
    root_chain = torch.zeros((B,), dtype=torch.int32, device=dev)
    for i in range(W):
        x = draft_chains[:, i, 0]
        lq = _take(logq_root, x)
        if i == 0:
            lp = _take(logp_root, x)
        else:
            px = _take(p_cur, x)
            lp = torch.where(px > 0, torch.log(torch.clamp_min(px, 1e-38)),
                             float("-inf"))
        acc_i = (torch.log(u[:, i]) < (lp - lq)) & ~root_acc
        root_chain = torch.where(acc_i, i, root_chain).to(torch.int32)
        root_acc = root_acc | acc_i
        residual = torch.clamp_min(p_cur - q_root, 0.0)
        s = residual.sum(-1, keepdim=True)
        resid_unnorm = torch.where(s > 1e-9, residual, p_cur)
        p_cur = torch.where(s > 1e-9, residual / torch.clamp_min(s, 1e-30), p_cur)

    # ---- the winning chain's drafts, drafter logits and target logits
    rows = torch.arange(B, device=dev)
    win = root_chain.long()
    drafts_c = draft_chains[rows, win]                       # [B, D]
    q_c = q_logits_chains[rows, win]                         # [B, D, V]
    cs = torch.as_tensor(chain_slots, dtype=torch.long, device=dev)
    slots = torch.cat([torch.zeros((B, 1), dtype=torch.long, device=dev),
                       cs[win]], dim=1)                      # [B, D+1]
    p_chain = p_logits_tree[rows[:, None], slots]            # [B, D+1, V]

    logq_c = torch.log_softmax(q_c / t, dim=-1)
    logp_c = torch.log_softmax(p_chain[:, :D] / t, dim=-1)
    # levels 2..D draw from u columns W..W+D-2 (columns 1..D-1 at W == 1,
    # verify_stochastic's layout)
    acc_lv = torch.log(u[:, W:]) < (_take(logp_c, drafts_c)[:, 1:]
                                    - _take(logq_c, drafts_c)[:, 1:])
    n_accepted = _accepted_prefix(torch.cat([root_acc[:, None], acc_lv], dim=1))

    # ---- one residual resample serves both rejection sites
    first_rej = torch.clamp_max(n_accepted, D - 1)
    chain_resid = _residual(torch.exp(_at(logp_c, first_rej)),
                            torch.exp(_at(logq_c, first_rej)))
    resid_sel = torch.where((n_accepted == 0)[:, None], resid_unnorm, chain_resid)
    resampled = categorical(k_res, torch.log(resid_sel + 1e-30))
    bonus = categorical(k_bonus, torch.log_softmax(p_chain[:, D] / t, dim=-1))
    extra = torch.where(n_accepted == D, bonus, resampled)
    res = _result(drafts_c, n_accepted, extra)
    return TreeVerifyResult(root_chain, *res)
