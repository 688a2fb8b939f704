"""The speculative round core: draft -> verify -> commit -> rollback
(port of ``repro/core/rounds.py``: cached linear and tree rounds on both
cache layouts, with per-row or batch-synchronized commits, and no-cache
batch-synchronized rounds; greedy or sampled).

Every round of the paged server runs ``spec_round`` (or ``ar_round`` when
the cost model says drafting does not pay). A cached round drafts gamma
tokens per row with the drafter's cached single-token steps, verifies them
in ONE target pass over ``[t_last, d_1..d_gamma]``, commits each row's own
accepted prefix plus the correction/bonus token (``per_row`` commits; or
the batch minimum, ``batch_min``, as ``SpecEngine(use_cache=True)`` does)
and rolls both caches back: by index for KV caches, through the verify
pass's state trail for a recurrent (ssm) target, and for a stateful
drafter (``RoundSpec.d_stateful``) to the state snapshot its draft steps
kept (it drafts gamma + 1 steps so the trail covers a full accept).

A tree round (``TreeDraftPolicy``) drafts ``width`` chains branching once
at the root against branch caches: ring rows replicated [B] -> [B*W]
(``_replicate_rows``), or copy-on-write forks of the drafter's block
tables (``PagedTreeRound``). It verifies the whole tree in ONE stacked
target pass through tree attention (``Model.apply(tree=...)``), commits
the winning chain's KV by compaction and keeps the winning drafter branch
(``_take_branch`` on a ring; ``PagedTreeRound`` adopts it on a pool).

A no-cache round (``SpecEngine(use_cache=False)``, the paper's mode)
recomputes the whole fixed-size token buffer in every forward: gamma
drafter passes write the drafts into a candidate buffer
(``draft_nocache``), ONE target pass over it verifies them (recompute
verify), and the batch-minimum emitted length is committed to every row
(``batch_min``), so ``length`` is a scalar. ``MultiDraftPolicy`` drafts k
candidate chains from the drafter's top-k first tokens and commits the
best one. The buffer positions are 0-dim device tensors: the column
writes and the logits/token slices gather and scatter on the device, so a
round makes no host sync of its own.

Greedy verification dispatches by device: the fused CUDA argmax kernel
(``kernels.spec_verify``) for a CUDA tensor, the plain version
(``core.acceptance``) for a CPU tensor. Both give the same tokens. The
JAX switch ``RoundSpec.fused_verify``, which could route a GPU tensor away
from the kernel, is left out.

Sampled rounds (``RoundSpec(greedy=False)``) draw every draft token from
softmax(q / temperature) and verify with ``acceptance.verify_stochastic``
(a tree: ``verify_tree_stochastic``, whose W root heads are i.i.d. draws),
so the committed tokens follow the target's distribution exactly. The
round threads ``RoundState.key`` (``sampling.keys``) and splits it where
JAX splits its threefry key: once per sampled draft step (gamma + 1 steps
for a stateful drafter), once for a tree's heads, once per verify; the
next state carries what is left. The argmax kernel is not used there.
Multi-draft stays greedy, as in JAX.

A cached round stays on the device too: the round-level live bound
(``_live0``; paged per-row rounds only) is a 0-dim device tensor handed to
the attention kernel, and the stateful drafter's snapshot is picked on the
device (a paged tree round reads the lengths before its forks and the
winners and new lengths after its commit, as in JAX). ``TracedRound`` runs
the same three phases with a span around each and the device synchronized
inside it, so a traced run commits exactly what ``spec_round`` commits.

``PlacedRound`` runs the same phases with plan-carried placement
(``api/placement.py``): the draft on the drafter's device, the gamma-token
package handed across, verify and commit on the target's device, the
drafter rollback back on the drafter's. Its spans measure host dispatch,
not device time (it never synchronizes).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.cache import ops as cache_ops
from repro_torch.cache import paged_kv
from repro_torch.core import acceptance
from repro_torch.core.tree import chain_tree
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.sampling.keys import categorical


COMMIT_MODES = ("batch_min", "per_row")


# ==================================================================== state
class RoundState(NamedTuple):
    """The generation state every round threads through. ``length`` (and
    ``n_accepted``) is a scalar for batch-synchronized rounds (all rows
    share one committed length) or per-row ``[B]`` for per-row rounds;
    ``active`` marks rows that still commit (frozen slots draft along but
    commit nothing; None = all rows live); the two caches are None on the
    no-cache path. ``t_off``/``d_off`` shift cache indices past any prefix
    the cache holds besides the text (0 for the ported text families; JAX's
    VLM vision tokens)."""
    tokens: torch.Tensor           # [B, T] token buffer
    length: torch.Tensor           # scalar or [B] committed tokens
    dcache: Any = None
    tcache: Any = None
    key: Any = None                # sampling key (sampling.keys)
    active: Any = None             # [B] bool or None (= all rows live)
    n_rounds: Any = 0              # scalar
    n_accepted: Any = 0            # scalar (batch_min) or [B] (per_row)
    n_drafted: Any = 0             # scalar
    t_off: Any = 0                 # cache-index offset vs text length
    d_off: Any = 0


class DraftOut(NamedTuple):
    """Draft-phase output: K candidate chains of gamma tokens per row
    (K = 1 for linear rounds, the tree width for tree rounds, k for
    multi-draft)."""
    drafts: torch.Tensor           # [B, K, G] drafted tokens
    t_last: Any = None             # [B] last committed token (cached path)
    dcache: Any = None
    cand_tokens: Any = None        # [B, K, T] no-cache candidate buffers
    snaps: Any = None              # stateful drafter: {leaf: [G+1, ...]} states
    q_logits: Any = None           # [B, K, G, V] drafter logits (sampled)
    key: Any = None                # the key left after drafting


class VerifyOut(NamedTuple):
    """Verify-phase output: per-row acceptance + the commit base buffer."""
    res: Any                       # VerifyResult or TreeVerifyResult
    base_tokens: torch.Tensor      # [B, T] buffer the commit scatters into
    tcache: Any = None
    key: Any = None                # the key left after verifying


def _write_col(tokens, pos, vals):
    """A copy of tokens [B, T] with column ``pos`` (a 0-dim device tensor,
    clamped into the buffer as ``dynamic_update_slice`` clamps it) set to
    vals [B]."""
    B, T = tokens.shape
    col = torch.clamp(pos, 0, T - 1).long().reshape(1, 1).expand(B, 1)
    return torch.scatter(tokens, 1, col, vals.to(tokens.dtype)[:, None])


def _slice_logits(logits, start, width):
    """logits [B, T, V] -> [B, width, V] from position ``start`` (a 0-dim
    device tensor, clamped as ``dynamic_slice`` clamps it)."""
    return torch.index_select(logits, 1, _window(start, width, logits.shape[1]))


def _slice_tokens(tokens, start, width):
    """tokens [B, T] -> [B, width] from position ``start`` (as above)."""
    return torch.index_select(tokens, 1, _window(start, width, tokens.shape[1]))


def _window(start, width, T):
    start = torch.clamp(start, 0, T - width).long()
    return start + torch.arange(width, device=start.device)


def _gather_last(tokens, length):
    """tokens[b, length[b]-1] per row. A per-row engine's finished row
    keeps drafting and may commit past the buffer (JAX reads a fill value
    there); the column is clamped into the buffer, which only that row's
    discarded tokens see."""
    lvec = length.expand(tokens.shape[0]) if length.ndim == 0 else length
    col = torch.clamp(lvec - 1, 0, tokens.shape[1] - 1)
    return torch.gather(tokens, 1, col[:, None].long())[:, 0]


def _state_leaves(cache):
    """The small recurrent-state leaves (state/conv) of a cache: the only
    parts that need a per-step snapshot; KV buffers roll back by index."""
    return {k: cache[k] for k in ("state", "conv") if k in cache}


def _restore_state_leaves(cache, snaps, j):
    """``cache`` with its state leaves taken from snapshot ``j`` (a 0-dim
    device tensor) of the stacked ``snaps``, gathered on the device."""
    j = j.long().reshape(1)
    return {**cache, **{k: torch.index_select(v, 0, j)[0]
                        for k, v in snaps.items()}}


def _replicate_rows(cache, W):
    """Row-replicate a ring KV cache for tree drafting: [B] rows -> [B*W]
    branch rows (branch w of row b is row b*W + w). The drafter's branches
    are linear chains, so each replica runs plain causal decode steps."""
    if W == 1:
        return cache
    if not (isinstance(cache, dict) and "k" in cache and "v" in cache) \
            or paged_kv.is_paged(cache):
        raise NotImplementedError(
            "tree drafting needs a KV-family drafter cache: ring rows are "
            "replicated here, a paged cache is forked by PagedTreeRound")
    out = {**cache, "k": torch.repeat_interleave(cache["k"], W, dim=1),
           "v": torch.repeat_interleave(cache["v"], W, dim=1)}
    if cache["index"].ndim:
        out["index"] = torch.repeat_interleave(cache["index"], W)
    return out


def _take_branch(cache, winner, W):
    """Inverse of ``_replicate_rows``: keep each row's winning branch of a
    [B*W]-row ring cache -> [B] rows. The winner's replica holds exactly
    the committed chain's KV at contiguous positions, so it simply becomes
    the next round's drafter cache."""
    if W == 1:
        return cache
    B = winner.shape[0]
    rows = torch.arange(B, device=winner.device)
    win = winner.long()
    out = dict(cache)
    for kk in ("k", "v"):
        leaf = cache[kk]
        out[kk] = leaf.reshape(leaf.shape[0], B, W, *leaf.shape[2:])[:, rows, win]
    if cache["index"].ndim:
        out["index"] = cache["index"].reshape(B, W)[rows, win]
    return out


def _is_paged_branched(dcache, B):
    """A paged drafter cache whose table has B*W rows was pre-branched by
    the host (``PagedTreeRound``'s copy-on-write forks)."""
    return (isinstance(dcache, dict) and "block_table" in dcache
            and dcache["block_table"].shape[0] != B)


def _take_candidate(x, win):
    """x: [B, K, ...] -> the winner candidate per row: [B, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), win.long()]


def next_token(q, greedy, temperature, key):
    """The next token per row of logits q [N, V] and the key to carry:
    q's argmax (greedy; the key is returned as it came), or a draw from
    softmax(q / temperature) with the second child of ``key``, the first
    being carried (JAX's ``k, ks = split(k)``)."""
    if greedy:
        return torch.argmax(q, dim=-1).to(torch.int32), key
    key, ks = key.split()
    return categorical(ks, q / temperature), key


def _top_k(x, k):
    """[B, V] -> int32 [B, k]: the k largest entries per row, largest first
    and the lower index first among ties, as ``jax.lax.top_k`` orders them.
    ``torch.topk`` promises no order among ties; a stable sort does."""
    return torch.sort(x, dim=-1, descending=True,
                      stable=True).indices[:, :k].to(torch.int32)


# ================================================================= policies
@dataclass(frozen=True)
class LinearDraftPolicy:
    """Classic speculative sampling: ONE chain of gamma sequential draft
    steps per row — cached single-token drafter steps, or no-cache
    full-buffer recomputes; greedy, or sampled (the drafter logits of
    every step are kept for the verify)."""
    name: str = "linear"

    def draft_cached(self, drafter, params_d, state: RoundState, spec,
                     live0) -> DraftOut:
        t_last = _gather_last(state.tokens, state.length)
        tok, cache, key = t_last, state.dcache, state.key
        drafts, qs, snaps = [], [], []
        # +1 step for stateful drafters so the snapshot trail covers the
        # full-acceptance rollback target
        for i in range(spec.gamma + 1 if spec.d_stateful else spec.gamma):
            ml = None if live0 is None else live0 + i
            logits, cache, _ = drafter.apply(params_d, tok[:, None], cache,
                                             logits_slice="last", max_live=ml)
            tok, key = next_token(logits[:, -1], spec.greedy,
                                  spec.temperature, key)
            drafts.append(tok)
            if not spec.greedy:
                qs.append(logits[:, -1])
            if spec.d_stateful:
                snaps.append(_state_leaves(cache))
        drafts = torch.stack(drafts[:spec.gamma], dim=1)       # [B, G]
        if snaps:
            snaps = {k: torch.stack([s[k] for s in snaps]) for k in snaps[0]}
        return DraftOut(drafts=drafts[:, None], t_last=t_last, dcache=cache,
                        snaps=snaps or None, q_logits=_stack_q(qs, spec.gamma),
                        key=key)

    def draft_nocache(self, drafter, params_d, state: RoundState,
                      spec) -> DraftOut:
        G = spec.gamma
        length = state.length
        toks, key = state.tokens, state.key
        qs = []
        for i in range(G):
            logits, _, _ = drafter.apply(params_d, toks)
            pos = length - 1 + i
            q_i = _slice_logits(logits, pos, 1)[:, 0]           # [B, V]
            d_i, key = next_token(q_i, spec.greedy, spec.temperature, key)
            toks = _write_col(toks, pos + 1, d_i)
            if not spec.greedy:
                qs.append(q_i)
        drafts = _slice_tokens(toks, length, G)
        return DraftOut(drafts=drafts[:, None], cand_tokens=toks[:, None],
                        q_logits=_stack_q(qs, G), key=key)


def _stack_q(qs, G):
    """The first G steps' drafter logits [B, V] -> [B, 1, G, V] (None when
    greedy: nothing was kept)."""
    return torch.stack(qs[:G], dim=1)[:, None] if qs else None


@dataclass(frozen=True)
class MultiDraftPolicy:
    """k parallel draft candidates per row: the drafter's top-k FIRST tokens
    each continued greedily, all k verified in ONE stacked target pass, the
    best accepted prefix committed. Greedy and no-cache only (cached
    k-candidate rounds are the tree policy). Every candidate's emission is
    a prefix of THE target greedy continuation, so committing the longest
    one is still exact greedy decoding."""
    name: str = "multi"
    k: int = 2

    def draft_nocache(self, drafter, params_d, state: RoundState,
                      spec) -> DraftOut:
        K, G = self.k, spec.gamma
        tokens, length = state.tokens, state.length
        B, T = tokens.shape
        # chain heads: the drafter's top-k next tokens after the prefix
        logits, _, _ = drafter.apply(params_d, tokens)
        q0 = _slice_logits(logits, length - 1, 1)[:, 0]         # [B, V]
        heads = _top_k(q0, K)                                   # [B, K]
        cand = _write_col(torch.repeat_interleave(tokens, K, dim=0), length,
                          heads.reshape(B * K))                 # [B*K, T]
        for i in range(1, G):
            lg, _, _ = drafter.apply(params_d, cand)
            pos = length - 1 + i
            q_i = _slice_logits(lg, pos, 1)[:, 0]               # [B*K, V]
            cand = _write_col(cand, pos + 1, torch.argmax(q_i, dim=-1))
        drafts = _slice_tokens(cand, length, G).reshape(B, K, G)
        return DraftOut(drafts=drafts, cand_tokens=cand.reshape(B, K, T),
                        key=state.key)


@dataclass(frozen=True)
class TreeDraftPolicy:
    """Tree drafting: ``width`` chains branching once at the root, drafted
    against branch caches and verified in ONE stacked cached target pass
    through tree attention (``Model.apply(tree=...)``).

    Draft: a root step consumes t_last and yields the root distribution q0:
    on the unbranched [B]-row drafter cache, which ``_replicate_rows`` then
    copies into W branch rows per row (a ring), or on every branch row of a
    pre-branched [B*W]-row paged cache (each branch's private tail block
    gets t_last's KV; the branch logits are identical, so row 0 of each
    group is q0). The W chain heads are q0's top-W (greedy) or W i.i.d.
    draws from softmax(q0 / temperature) (sampled: ONE categorical over
    the row-repeated q0, which at width 1 is the linear round's first
    draw; the i.i.d.-ness is what keeps multi-path rejection lossless);
    each head then continues as a LINEAR chain against its own branch, so
    the drafter itself never needs tree attention. Sampled, the drafter
    logits are kept as [B, W, D, V], q0 at level 1 of every chain. Width 1
    runs on the unbranched cache and drafts exactly what the linear policy
    drafts.
    """
    name: str = "tree"
    width: int = 2

    def draft_cached(self, drafter, params_d, state: RoundState, spec,
                     live0) -> DraftOut:
        W, D = self.width, spec.gamma
        t_last = _gather_last(state.tokens, state.length)
        B = t_last.shape[0]
        if _is_paged_branched(state.dcache, B):
            logits, cache, _ = drafter.apply(
                params_d, torch.repeat_interleave(t_last, W)[:, None],
                state.dcache, logits_slice="last", max_live=live0)
            q0 = logits[:, -1].reshape(B, W, -1)[:, 0]         # [B, V]
        else:
            logits, cache, _ = drafter.apply(
                params_d, t_last[:, None], state.dcache, logits_slice="last",
                max_live=live0)
            q0 = logits[:, -1]
            cache = _replicate_rows(cache, W)
        key = state.key
        if spec.greedy:
            tok = _top_k(q0, W).reshape(B * W)
        else:
            key, ks = key.split()
            tok = categorical(ks, torch.repeat_interleave(q0 / spec.temperature,
                                                          W, dim=0))
        chain, qs = [tok], []
        for i in range(D - 1):
            ml = None if live0 is None else live0 + 1 + i
            lg, cache, _ = drafter.apply(params_d, tok[:, None], cache,
                                         logits_slice="last", max_live=ml)
            tok, key = next_token(lg[:, -1], spec.greedy, spec.temperature, key)
            chain.append(tok)
            if not spec.greedy:
                qs.append(lg[:, -1].reshape(B, W, 1, -1))
        drafts = torch.stack(chain, dim=1).reshape(B, W, D)
        q_logits = None
        if not spec.greedy:
            q_logits = torch.cat([q0[:, None, None].expand(B, W, 1, q0.shape[-1]),
                                  *qs], dim=2)                  # [B, W, D, V]
        return DraftOut(drafts=drafts, t_last=t_last, dcache=cache,
                        q_logits=q_logits, key=key)


def make_policy(name: str, k: int = 2):
    if name == "linear":
        return LinearDraftPolicy()
    if name == "multi":
        if k < 2:
            raise ValueError(f"multi-draft needs k >= 2 candidates, got {k}")
        return MultiDraftPolicy(k=k)
    if name == "tree":
        if k < 1:
            raise ValueError(f"tree draft needs width >= 1, got {k}")
        return TreeDraftPolicy(width=k)
    raise ValueError(f"unknown draft policy {name!r} "
                     f"(expected 'linear', 'multi' or 'tree')")


# ===================================================================== spec
@dataclass(frozen=True)
class RoundSpec:
    """Static parameterization of one round. ``gamma`` is the chain depth
    of a tree policy. ``greedy=False`` samples at ``temperature`` (drafts
    divide the logits by it as given; the verify clamps it at 1e-6, as
    JAX's do). The defaults are the paged server's cached per-row greedy
    round (JAX defaults to ``commit="batch_min"``); ``SpecEngine`` passes
    ``commit="batch_min"`` and its cache mode. ``d_stateful``: the drafter
    carries recurrent state (ssm), rolled back to a draft step's
    snapshot."""
    gamma: int = 4
    greedy: bool = True
    temperature: float = 1.0
    commit: str = "per_row"                # COMMIT_MODES
    use_cache: bool = True
    d_stateful: bool = False
    policy: Any = field(default_factory=LinearDraftPolicy)

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")
        if self.commit not in COMMIT_MODES:
            raise ValueError(f"commit must be one of {COMMIT_MODES}")
        name = getattr(self.policy, "name", "")
        if name == "multi":
            if not self.greedy:
                raise ValueError("multi-draft is greedy-only")
            if self.use_cache:
                raise ValueError("multi-draft needs no-cache verification")
        if self.commit == "per_row" and not self.use_cache:
            raise ValueError("per-row commits need per-row cache indices "
                             "(use_cache=True)")
        if self.d_stateful and (not self.use_cache
                                or self.commit != "batch_min"):
            raise ValueError("stateful drafters need the cached "
                             "batch-synchronized path (docs/DESIGN.md §5)")
        if name == "tree":
            if not self.use_cache:
                raise ValueError("tree drafting is cached-only (branch "
                                 "caches + tree-attention verify)")
            if self.d_stateful:
                raise ValueError("tree drafting needs a KV-family drafter "
                                 "(branch caches replicate/fork KV rows)")
            # validates span = 1 + width*gamma <= MAX_SPAN up front
            chain_tree(self.policy.width, self.gamma)

    @property
    def drafted_per_round(self) -> int:
        return self.gamma


def _live0(state: RoundState, spec: RoundSpec):
    """Round-level live-token bound for paged block-scan reads (None for
    ring caches and batch-synchronized rounds, which need none: the kernel
    bounds each row by its own index)."""
    if not spec.use_cache or spec.commit != "per_row":
        return None
    return cache_ops.ops_for(state.tcache).live_bound(state.length,
                                                      state.active)


# =================================================================== phases
def draft_phase(drafter, params_d, state: RoundState,
                spec: RoundSpec) -> DraftOut:
    """Phase 1: run the draft policy."""
    if spec.use_cache:
        return spec.policy.draft_cached(drafter, params_d, state, spec,
                                        _live0(state, spec))
    return spec.policy.draft_nocache(drafter, params_d, state, spec)


def _greedy_verify(drafts, p_logits):
    """Greedy acceptance through the argmax kernel's wrapper, which takes
    the plain version for a CPU tensor."""
    from repro_torch.kernels import ops as kernel_ops
    return kernel_ops.verify_greedy(drafts, p_logits)


def verify_phase(target, params_t, state: RoundState, d: DraftOut,
                 spec: RoundSpec) -> VerifyOut:
    """Phase 2: one target pass + acceptance: cached over [t_last,
    d_1..d_G] (a tree: over [t_last, level-major nodes]), or a recompute
    over the K stacked candidate buffers with best-candidate selection."""
    if not spec.use_cache:
        return _verify_recompute(target, params_t, state, d, spec)
    if getattr(spec.policy, "name", "") == "tree":
        # ONE stacked cached pass over the whole tree; the chain tree's
        # (depths, bits) select tree attention in the target's layers
        B, W = d.drafts.shape[:2]
        tree = chain_tree(W, spec.gamma)
        level_major = d.drafts.transpose(1, 2).reshape(B, W * spec.gamma)
        verify_in = torch.cat([d.t_last[:, None], level_major], dim=1)
        live0 = _live0(state, spec)
        ml = None if live0 is None else live0 + tree.span - 1
        p_logits, tcache, _ = target.apply(params_t, verify_in, state.tcache,
                                           want_trail=True, max_live=ml,
                                           tree=(tree.depths, tree.bits))
        key = d.key
        if spec.greedy:
            res = acceptance.verify_tree_greedy(d.drafts, p_logits,
                                                tree.chain_slots)
        else:
            key, kv = key.split()
            res = acceptance.verify_tree_stochastic(
                kv, d.drafts, d.q_logits, p_logits, tree.chain_slots,
                spec.temperature)
        return VerifyOut(res=res, base_tokens=state.tokens, tcache=tcache,
                         key=key)
    drafts = d.drafts[:, 0]
    verify_in = torch.cat([d.t_last[:, None], drafts], dim=1)
    live0 = _live0(state, spec)
    ml = None if live0 is None else live0 + spec.gamma
    p_logits, tcache, _ = target.apply(params_t, verify_in, state.tcache,
                                       want_trail=True, max_live=ml)
    res, key = _verify_linear(drafts, d, p_logits, spec)
    return VerifyOut(res=res, base_tokens=state.tokens, tcache=tcache, key=key)


def _verify_linear(drafts, d: DraftOut, p_logits, spec: RoundSpec):
    """Acceptance of one chain per row: greedy through the argmax kernel's
    wrapper, or sampled with a child of the draft's key. Returns (result,
    the key to carry)."""
    if spec.greedy:
        return _greedy_verify(drafts, p_logits), d.key
    key, kv = d.key.split()
    return acceptance.verify_stochastic(kv, drafts, d.q_logits[:, 0], p_logits,
                                        spec.temperature), key


def _verify_recompute(target, params_t, state: RoundState, d: DraftOut,
                      spec: RoundSpec) -> VerifyOut:
    """Full-buffer target pass over the K stacked candidates; for K > 1 the
    best accepted prefix wins, ties to the drafter-greedy candidate 0
    (``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does)."""
    G = spec.gamma
    B, K, T = d.cand_tokens.shape
    p_full, _, _ = target.apply(params_t, d.cand_tokens.reshape(B * K, T))
    p_logits = _slice_logits(p_full, state.length - 1, G + 1)  # [B*K, G+1, V]
    res, key = _verify_linear(d.drafts.reshape(B * K, G), d, p_logits, spec)
    if K == 1:
        return VerifyOut(res=res, base_tokens=d.cand_tokens[:, 0], key=key)
    win = torch.argmax(res.n_emitted.reshape(B, K), dim=1)
    res = acceptance.VerifyResult(
        _take_candidate(res.n_accepted.reshape(B, K), win),
        _take_candidate(res.out_tokens.reshape(B, K, G + 1), win),
        _take_candidate(res.n_emitted.reshape(B, K), win))
    return VerifyOut(res=res, base_tokens=_take_candidate(d.cand_tokens, win),
                     key=key)


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


def _tree_commit(target, state: RoundState, d: DraftOut, v: VerifyOut,
                 spec: RoundSpec) -> RoundState:
    """Tree-round commit: compact the winner path's scattered KV into the
    committed tail, then the ordinary commit (per row or the batch
    minimum). The winner chain's level-l token sits at cache position
    (length-1) + chain_slots[winner][l-1]; its committed home is
    length + l - 1 — src >= dst always, and ``compact`` gathers before it
    scatters, so the move is overlap-safe. Compacting all G levels is fine:
    rollback masks everything past the accepted length. The drafter side
    needs no compaction: the winner's branch already holds the committed
    chain contiguously, so it becomes the next round's drafter cache
    (``_take_branch`` on a ring; ``PagedTreeRound`` adopts it on a pool)."""
    G = spec.gamma
    B, W = d.drafts.shape[:2]
    dev = state.tokens.device
    cs = torch.as_tensor(chain_tree(W, G).chain_slots, device=dev)   # [W, G]
    lvec = state.length.expand(B) if state.length.ndim == 0 else state.length
    src = (lvec - 1)[:, None] + cs[v.res.winner.long()] + state.t_off
    dst = lvec[:, None] + torch.arange(G, dtype=torch.int32,
                                       device=dev) + state.t_off
    tcache = cache_ops.ops_for(v.tcache).compact(v.tcache, src, dst)
    dcache = d.dcache
    if not _is_paged_branched(dcache, B):
        dcache = _take_branch(dcache, v.res.winner, W)
    d, v = d._replace(dcache=dcache), v._replace(tcache=tcache)
    if spec.commit == "per_row":
        return _commit_rows(state, d, v, spec)
    return _commit_batch_min(target, state, d, v, spec, 1 + W * G)


def _commit_rows(state: RoundState, d: DraftOut, v: VerifyOut,
                 spec: RoundSpec) -> RoundState:
    """Commit each row's accepted prefix + roll both caches back. A drafter
    cache pre-branched for a tree round is left to ``PagedTreeRound``,
    which adopts each row's winning branch; a placed round's (None) to
    ``PlacedRound``."""
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
    dcache = d.dcache
    if dcache is not None and not _is_paged_branched(dcache, B):
        dcache = cache_ops.ops_for(dcache).rollback(dcache, new_len - 1)
    return state._replace(
        tokens=tokens, length=new_len, dcache=dcache, tcache=tcache,
        key=v.key, n_rounds=state.n_rounds + 1,
        n_accepted=state.n_accepted + torch.where(active, res.n_accepted, zero),
        n_drafted=state.n_drafted + spec.drafted_per_round)


def _commit_batch_min(target, state: RoundState, d: DraftOut, v: VerifyOut,
                      spec: RoundSpec, q_len=None) -> RoundState:
    """Batch-synchronized commit: every row commits the batch-minimum
    emitted length (discarded acceptances are re-drafted; exact at B=1),
    so ``length`` stays a scalar. Cached: the target rolls back over the
    verify pass's ``q_len`` tokens (gamma + 1, or a tree's span), and the
    drafter by index or, stateful, to the snapshot after its n_acc + 1-th
    step; both caches end at (committed length - 1) consumed inputs,
    shifted by ``t_off``/``d_off``."""
    res = v.res
    B = state.tokens.shape[0]
    n_commit = res.n_emitted.min()
    tokens = _scatter_commit(v.base_tokens, state.length, res.out_tokens,
                             n_commit.expand(B), spec.gamma)
    new_len = state.length + n_commit
    n_acc = n_commit - 1
    st = state._replace(
        tokens=tokens, length=new_len, key=v.key, n_rounds=state.n_rounds + 1,
        n_accepted=state.n_accepted + n_acc,
        n_drafted=state.n_drafted + spec.drafted_per_round)
    if not spec.use_cache:
        return st
    tcache = target.rollback(v.tcache, new_len - 1 + state.t_off,
                             q_len or spec.gamma + 1)
    if d.dcache is None:                   # placed round: drafter-side rollback
        return st._replace(dcache=None, tcache=tcache)
    if spec.d_stateful:
        # snapshot j = state after consuming j+1 inputs; we need n_acc+1
        dcache = _restore_state_leaves(d.dcache, d.snaps, n_acc)
        dcache = {**dcache,
                  "index": (new_len - 1 + state.d_off).to(torch.int32)}
    else:
        dcache = cache_ops.ops_for(d.dcache).rollback(
            d.dcache, new_len - 1 + state.d_off)
    return st._replace(dcache=dcache, tcache=tcache)


def commit_phase(target, state: RoundState, d: DraftOut, v: VerifyOut,
                 spec: RoundSpec) -> RoundState:
    """Phase 3: commit the accepted prefix (per row, or the batch minimum)
    + roll the caches back.

    ``d.dcache is None`` marks a PLACED round (the drafter cache lives on
    the drafter's device): the drafter rollback is skipped here and run
    there by ``PlacedRound``; the committed state carries ``dcache=None``
    until the round reattaches it."""
    if getattr(spec.policy, "name", "") == "tree":
        return _tree_commit(target, state, d, v, spec)
    if spec.commit == "batch_min":
        return _commit_batch_min(target, state, d, v, spec)
    return _commit_rows(state, d, v, spec)


# ==================================================================== rounds
def spec_round(target, drafter, params_t, params_d, state: RoundState,
               spec: RoundSpec) -> RoundState:
    """ONE speculative round: the composition of the three phases."""
    d = draft_phase(drafter, params_d, state, spec)
    v = verify_phase(target, params_t, state, d, spec)
    return commit_phase(target, state, d, v, spec)


def phase_fns(target, drafter, spec: RoundSpec):
    """(draft, verify, commit) callables over the SAME phase code
    ``spec_round`` composes."""
    def draft(params_d, state):
        return draft_phase(drafter, params_d, state, spec)

    def verify(params_t, state, d):
        return verify_phase(target, params_t, state, d, spec)

    def commit(state, d, v):
        return commit_phase(target, state, d, v, spec)

    return draft, verify, commit


class TracedRound:
    """ONE speculative round, phase-split for observability: the three
    ``phase_fns`` run in turn, each inside its span with the device
    synchronized before the span closes, so a span's wall time is that
    phase's time on the card (host dispatch included), never its enqueue
    time. The tax against ``spec_round``: a host sync per phase, which
    forfeits overlap of one phase's launches with the previous phase's
    kernels; so engines build a TracedRound only for an ENABLED tracer.

    Token identity with ``spec_round``: it IS the composition of these
    phases, called in the same order on the same state (the pools update in
    place exactly as they do there), so tracing changes when the host
    waits, never what the round commits.

    ``last_phase_times`` holds the most recent round's per-phase seconds;
    servers turn it into RoundEvents and drift-monitor observations.
    """

    def __init__(self, target, drafter, spec: RoundSpec, tracer, **tags):
        self.spec = spec
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.tags = tags
        self._draft, self._verify, self._commit = phase_fns(target, drafter,
                                                            spec)
        self.last_phase_times: dict = {}

    def __call__(self, params_t, params_d, state: RoundState,
                 **tags) -> RoundState:
        tr = self.tracer
        dev = state.tokens.device
        t = {**self.tags, **tags}      # caller tags may override role etc.
        with tr.span("draft",
                     **{"phase": "draft", "role": "drafter", **t}) as s_d:
            d = self._draft(params_d, state)
            devices.synchronize(dev)
        with tr.span("verify",
                     **{"phase": "verify", "role": "target", **t}) as s_v:
            v = self._verify(params_t, state, d)
            devices.synchronize(dev)
        with tr.span("commit",
                     **{"phase": "commit", "role": "target", **t}) as s_c:
            new = self._commit(state, d, v)
            devices.synchronize(dev)
        self.last_phase_times = {"draft": s_d.duration,
                                 "verify": s_v.duration,
                                 "commit": s_c.duration}
        return new


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


# =========================================================== placed execution
def place_state(state: RoundState, placement, target_model=None,
                drafter_model=None) -> RoundState:
    """Pin a RoundState onto a realized Placement (api/placement.py): the
    drafter cache moves to the drafter's device, everything else — tokens,
    lengths, target cache, counters — to the target's (where verify and
    commit run). No-op for the degenerate lowering. ``.to`` of a tensor
    already on the device returns it: on a shared-device lowering the
    placed state shares its tensors with the input."""
    if not placement.heterogeneous:
        return state
    B = state.tokens.shape[0]
    dcache = (placement.drafter.put_cache(drafter_model, state.dcache, B)
              if drafter_model is not None
              else placement.to_drafter(state.dcache))
    tcache = (placement.target.put_cache(target_model, state.tcache, B)
              if target_model is not None
              else placement.to_target(state.tcache))
    rest = placement.to_target(state._replace(dcache=None, tcache=None))
    return rest._replace(dcache=dcache, tcache=tcache)


class PlacedRound:
    """ONE speculative round with plan-carried placement: the same three
    phases as ``spec_round``, split at the draft/verify handoff —

        drafter's device : draft (``draft_phase``'s policy) + drafter rollback
        target's device  : verify + commit (``verify_phase``/``commit_phase``)

    with the gamma-token package (gamma drafts + the last committed token;
    plus the drafter logits and the key in sampled mode) moved across
    between them, the paper's tiny PU-to-PU handoff. The key is a host
    object (``sampling.keys``), so its handoff moves nothing; its draws are
    made on the device of the logits they perturb.

    PyTorch launches are asynchronous and nothing in the round waits for
    the card, so the host can enqueue the drafter rollback and the NEXT
    round while this verify still runs (``SpecEngine``'s overlap loop).

    Token identity: the phases run the SAME code ``spec_round`` composes,
    so a placed round commits exactly the tokens the unplaced round would;
    only device residency and dispatch order change. The caches update in
    place, as everywhere in the port; the tokens, lengths and counters of
    the returned state are new tensors (``_scatter_commit`` returns a new
    buffer), so a caller may read a prior state's after dispatching the
    next round — never its caches.

    Supported: cached linear rounds (both commit modes, greedy or sampled)
    with KV-family drafters. Multi-draft, tree, no-cache rounds and
    stateful drafters keep the unplaced path.
    """

    def __init__(self, target, drafter, spec: RoundSpec, placement,
                 tracer=None):
        if getattr(spec.policy, "k", 1) > 1 \
                or getattr(spec.policy, "name", "") != "linear":
            raise ValueError("placed rounds are linear-draft only")
        if not spec.use_cache:
            raise ValueError("placed rounds need cached execution "
                             "(no-cache rounds recompute on one buffer)")
        if spec.d_stateful:
            raise ValueError("placed rounds need KV-family drafters "
                             "(state-trail rollback is single-device)")
        self.target, self.drafter = target, drafter
        self.spec, self.placement = spec, placement
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def _draft(self, params_d, t_last, length, dcache, key, active):
        """The draft on the drafter's device. The cached linear draft reads
        ONLY the last committed token from the buffer, so a [B] vector is
        the whole visible prefix (the real ``length`` feeds the paged
        live-block bound)."""
        sp = self.spec
        live0 = None
        if sp.commit == "per_row":
            live0 = cache_ops.ops_for(dcache).live_bound(length, active)
        st = RoundState(tokens=t_last[:, None],
                        length=torch.ones((), dtype=torch.int32,
                                          device=t_last.device),
                        dcache=dcache, key=key, active=active)
        d = sp.policy.draft_cached(self.drafter, params_d, st, sp, live0)
        q = None if sp.greedy else d.q_logits[:, 0]
        return d.drafts[:, 0], q, d.dcache, d.key

    def _verify_commit(self, params_t, state, tcache, drafts, t_last,
                       q_logits, key):
        state = state._replace(tcache=tcache)
        d = DraftOut(drafts=drafts[:, None], t_last=t_last, dcache=None,
                     q_logits=None if q_logits is None else q_logits[:, None],
                     key=key)
        v = verify_phase(self.target, params_t, state, d, self.spec)
        return commit_phase(self.target, state, d, v, self.spec)

    def __call__(self, params_t, params_d, state: RoundState,
                 **tags) -> RoundState:
        # the spans do NOT synchronize: a placed span measures host enqueue
        # and transfer time (kind "dispatch"/"handoff"); per-phase device
        # time comes from the phase-split TracedRound
        pm, tr = self.placement, self.tracer
        # last committed token + row lengths -> drafter's device: a [B]
        # vector each, never the [B, T] buffer
        t_last_t = _gather_last(state.tokens, state.length)
        with tr.span("draft.dispatch", phase="draft", role="drafter",
                     kind="dispatch", **tags):
            t_last_d, length_d, active_d, key_d, d_off_d = pm.to_drafter(
                (t_last_t, state.length, state.active, state.key,
                 state.d_off))
            drafts, q_log, dcache, key2 = self._draft(
                params_d, t_last_d, length_d, state.dcache, key_d, active_d)
        # the gamma-token handoff -> target's device
        with tr.span("handoff", phase="handoff", role="target",
                     kind="handoff", **tags):
            drafts_t, q_t, key_t = pm.to_target((drafts, q_log, key2))
        with tr.span("verify_commit.dispatch", phase="verify", role="target",
                     kind="dispatch", **tags):
            new = self._verify_commit(
                params_t, state._replace(dcache=None, tcache=None),
                state.tcache, drafts_t, t_last_t, q_t, key_t)
        # commit result -> drafter's device; its rollback is enqueued there
        with tr.span("rollback.dispatch", phase="commit", role="drafter",
                     kind="dispatch", **tags):
            new_len_d = pm.to_drafter(new.length)
            dcache = cache_ops.ops_for(dcache).rollback(dcache,
                                                        new_len_d - 1 + d_off_d)
        return new._replace(dcache=dcache)


class PagedTreeRound:
    """ONE paged tree round driven from the host: copy-on-write fork each
    row's drafter block table (one branch per chain, shared prefix blocks
    refcounted, partial tail copied — ``BlockAllocator.fork_row``), run the
    three phases ``spec_round`` composes against the pre-branched
    [B*W]-row drafter cache, then adopt each row's winning branch and free
    the losers (``adopt_branch``). The target cache needs no forks: the
    stacked verify writes every tree slot to its own position past the
    committed tail and ``_tree_commit`` compacts the winner path in place.

    Two host reads per round: the lengths before the forks, and the winners
    with the new lengths after the commit; the latter stay readable as
    ``last_winner`` / ``last_length`` (numpy), so a caller's bookkeeping
    needs no sync of its own. Scope: a fully-live batch; serving
    admission, preemption and capacity degradation stay with the
    scheduler.
    """

    def __init__(self, target, drafter, spec: RoundSpec, alloc_t, alloc_d):
        if getattr(spec.policy, "name", "") != "tree":
            raise ValueError("PagedTreeRound needs a TreeDraftPolicy spec")
        self.target, self.drafter = target, drafter
        self.spec = spec
        self.W = spec.policy.width
        self.alloc_t, self.alloc_d = alloc_t, alloc_d
        self.last_winner = self.last_length = None

    def _fork(self, state: RoundState) -> RoundState:
        W, D = self.W, self.spec.gamma
        span = 1 + W * D
        B = state.tokens.shape[0]
        dev = state.tokens.device
        lengths = state.length.cpu().numpy()
        pairs = []
        for b in range(B):
            L = int(lengths[b])
            if not self.alloc_t.ensure(b, L - 1 + span):
                raise RuntimeError(f"target pool exhausted growing row {b} "
                                   f"to {L - 1 + span} tokens")
            # the adopted branch was only ever grown to last round's draft
            # horizon — a fully-accepted round can commit past it, so the
            # row must be re-ensured to its new tail before forking
            if not self.alloc_d.ensure(b, L - 1):
                raise RuntimeError(f"drafter pool exhausted growing row {b} "
                                   f"to {L - 1} tokens")
            p = self.alloc_d.fork_row(b, L - 1, W)
            if p is None:
                raise RuntimeError(f"drafter pool exhausted forking row {b} "
                                   f"into {W} branches")
            pairs += p
            for w in range(W):
                if not self.alloc_d.ensure_branch(b, w, L - 1 + D):
                    raise RuntimeError(f"drafter pool exhausted growing "
                                       f"branch {w} of row {b}")
        dcache = paged_kv.copy_blocks(state.dcache, pairs)
        tbl = np.stack([self.alloc_d.branch_tables(b) for b in range(B)])
        dcache = {**dcache,
                  "block_table": torch.from_numpy(tbl.reshape(B * W, -1)).to(dev),
                  "index": torch.repeat_interleave(state.dcache["index"], W)}
        tcache = {**state.tcache, "block_table": self.alloc_t.device_table(dev)}
        return state._replace(dcache=dcache, tcache=tcache)

    def __call__(self, params_t, params_d, state: RoundState) -> RoundState:
        B = state.tokens.shape[0]
        dev = state.tokens.device
        state = self._fork(state)
        d = draft_phase(self.drafter, params_d, state, self.spec)
        v = verify_phase(self.target, params_t, state, d, self.spec)
        new = commit_phase(self.target, state, d, v, self.spec)
        winner, new_len = torch.stack(
            [v.res.winner, new.length.to(torch.int32)]).cpu().numpy()
        self.last_winner, self.last_length = winner, new_len
        for b in range(B):
            self.alloc_d.adopt_branch(b, int(winner[b]))
            keep = max(int(new_len[b]) - 1, 1)
            self.alloc_d.free_tail(b, keep)
            self.alloc_t.free_tail(b, keep)
        dcache = {**new.dcache,
                  "block_table": self.alloc_d.device_table(dev),
                  "index": torch.from_numpy(new_len - 1).to(dev)}
        tcache = {**new.tcache, "block_table": self.alloc_t.device_table(dev)}
        return new._replace(dcache=dcache, tcache=tcache)
