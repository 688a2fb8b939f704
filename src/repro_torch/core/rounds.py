"""The speculative round core: draft -> verify -> commit -> rollback
(port of the greedy subset of ``repro/core/rounds.py``: cached per-row
linear and paged tree rounds, and no-cache batch-synchronized rounds).

Every round of the paged server runs ``spec_round`` (or ``ar_round`` when
the cost model says drafting does not pay). A cached round drafts gamma
tokens per row with the drafter's cached single-token steps, verifies them
in ONE target pass over ``[t_last, d_1..d_gamma]``, commits each row's own
accepted prefix plus the correction/bonus token (``per_row`` commits) and
rolls both caches back by index.

A tree round (``TreeDraftPolicy``, driven by ``PagedTreeRound``) drafts
``width`` chains branching once at the root against copy-on-write forks of
the drafter's block tables, verifies the whole tree in ONE stacked target
pass through tree attention (``Model.apply(tree=...)``), commits the
winning chain's KV by compaction and adopts the winning drafter branch.

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

A cached round stays on the device too: the round-level live bound
(``_live0``) is a 0-dim device tensor handed to the attention kernel (a
paged tree round reads the lengths before its forks and the winners and
new lengths after its commit, as in JAX). Sampled acceptance and sampled
drafting, stateful drafters, ring-cache rounds (and with them cached
``batch_min`` commits), and the placed and traced round runners wait for
later slices.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.cache import ops as cache_ops
from repro_torch.cache import paged_kv
from repro_torch.core import acceptance
from repro_torch.core.tree import chain_tree


COMMIT_MODES = ("batch_min", "per_row")


# ==================================================================== state
class RoundState(NamedTuple):
    """The generation state every round threads through. ``length`` (and
    ``n_accepted``) is a scalar for batch-synchronized no-cache rounds (all
    rows share one committed length) or per-row ``[B]`` for the paged
    paths; ``active`` marks rows that still commit (frozen slots draft
    along but commit nothing; None = all rows live); the two paged caches
    are None on the no-cache path."""
    tokens: torch.Tensor           # [B, T] token buffer
    length: torch.Tensor           # scalar or [B] committed tokens
    dcache: Any = None
    tcache: Any = None
    active: Any = None             # [B] bool or None (= all rows live)
    n_rounds: Any = 0              # scalar
    n_accepted: Any = 0            # scalar (batch_min) or [B] (per_row)
    n_drafted: Any = 0             # scalar


class DraftOut(NamedTuple):
    """Draft-phase output: K candidate chains of gamma tokens per row
    (K = 1 for linear rounds, the tree width for tree rounds, k for
    multi-draft)."""
    drafts: torch.Tensor           # [B, K, G] drafted tokens
    t_last: Any = None             # [B] last committed token (cached path)
    dcache: Any = None
    cand_tokens: Any = None        # [B, K, T] no-cache candidate buffers


class VerifyOut(NamedTuple):
    """Verify-phase output: per-row acceptance + the commit base buffer."""
    res: Any                       # VerifyResult or TreeVerifyResult
    base_tokens: torch.Tensor      # [B, T] buffer the commit scatters into
    tcache: Any = None


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
    """tokens[b, length[b]-1] per row."""
    lvec = length.expand(tokens.shape[0]) if length.ndim == 0 else length
    return torch.gather(tokens, 1, (lvec - 1)[:, None].long())[:, 0]


def _is_paged_branched(dcache, B):
    """A paged drafter cache whose table has B*W rows was pre-branched by
    the host (``PagedTreeRound``'s copy-on-write forks)."""
    return (isinstance(dcache, dict) and "block_table" in dcache
            and dcache["block_table"].shape[0] != B)


def _take_candidate(x, win):
    """x: [B, K, ...] -> the winner candidate per row: [B, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), win.long()]


def _top_k(x, k):
    """[B, V] -> int32 [B, k]: the k largest entries per row, largest first
    and the lower index first among ties, as ``jax.lax.top_k`` orders them.
    ``torch.topk`` promises no order among ties; a stable sort does."""
    return torch.sort(x, dim=-1, descending=True,
                      stable=True).indices[:, :k].to(torch.int32)


# ================================================================= policies
@dataclass(frozen=True)
class LinearDraftPolicy:
    """Classic speculative sampling: ONE chain of gamma sequential greedy
    draft steps per row — cached single-token drafter steps, or no-cache
    full-buffer recomputes."""
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

    def draft_nocache(self, drafter, params_d, state: RoundState,
                      spec) -> DraftOut:
        G = spec.gamma
        length = state.length
        toks = state.tokens
        for i in range(G):
            logits, _, _ = drafter.apply(params_d, toks)
            pos = length - 1 + i
            q_i = _slice_logits(logits, pos, 1)[:, 0]           # [B, V]
            toks = _write_col(toks, pos + 1, torch.argmax(q_i, dim=-1))
        drafts = _slice_tokens(toks, length, G)
        return DraftOut(drafts=drafts[:, None], cand_tokens=toks[:, None])


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
        return DraftOut(drafts=drafts, cand_tokens=cand.reshape(B, K, T))


@dataclass(frozen=True)
class TreeDraftPolicy:
    """Tree drafting (greedy): ``width`` chains branching once at the root,
    drafted against branch caches and verified in ONE stacked cached target
    pass through tree attention (``Model.apply(tree=...)``).

    Draft: a root step consumes t_last on every branch row of the
    pre-branched [B*W]-row drafter cache (each branch's private tail block
    gets t_last's KV; the branch logits are identical, so row 0 of each
    group is the root distribution q0); the W chain heads are q0's top-W;
    each head then continues as a LINEAR chain of greedy steps against its
    own branch, so the drafter itself never needs tree attention. Width 1
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
        if W > 1 and not _is_paged_branched(state.dcache, B):
            raise NotImplementedError(
                "tree drafting needs the drafter's paged cache forked into "
                "width branch rows (PagedTreeRound); ring-cache tree rounds "
                "are not ported")
        logits, cache, _ = drafter.apply(
            params_d, torch.repeat_interleave(t_last, W)[:, None],
            state.dcache, logits_slice="last", max_live=live0)
        q0 = logits[:, -1].reshape(B, W, -1)[:, 0]             # [B, V]
        tok = _top_k(q0, W).reshape(B * W)
        chain = [tok]
        for i in range(D - 1):
            ml = None if live0 is None else live0 + 1 + i
            lg, cache, _ = drafter.apply(params_d, tok[:, None], cache,
                                         logits_slice="last", max_live=ml)
            tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
            chain.append(tok)
        drafts = torch.stack(chain, dim=1).reshape(B, W, D)
        return DraftOut(drafts=drafts, t_last=t_last, dcache=cache)


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
    """Static parameterization of one greedy round. ``gamma`` is the chain
    depth of a tree policy. The defaults are the paged server's cached
    per-row round (JAX defaults to ``commit="batch_min"``); the no-cache
    engine passes ``commit="batch_min", use_cache=False``."""
    gamma: int = 4
    commit: str = "per_row"                # COMMIT_MODES
    use_cache: bool = True
    policy: Any = field(default_factory=LinearDraftPolicy)

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {self.gamma}")
        if self.commit not in COMMIT_MODES:
            raise ValueError(f"commit must be one of {COMMIT_MODES}")
        name = getattr(self.policy, "name", "")
        if name == "multi" and self.use_cache:
            raise ValueError("multi-draft needs no-cache verification")
        if self.commit == "per_row" and not self.use_cache:
            raise ValueError("per-row commits need per-row cache indices "
                             "(use_cache=True)")
        if name == "tree":
            if not self.use_cache:
                raise ValueError("tree drafting is cached-only (branch "
                                 "caches + tree-attention verify)")
            # validates span = 1 + width*gamma <= MAX_SPAN up front
            chain_tree(self.policy.width, self.gamma)
        if self.use_cache and self.commit == "batch_min":
            raise NotImplementedError(
                "cached batch_min rounds run on the ring cache, which is not "
                "ported; the paged rounds commit per_row")

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
    if spec.use_cache:
        return spec.policy.draft_cached(drafter, params_d, state, spec,
                                        _live0(state))
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
        ml = _live0(state) + tree.span - 1
        p_logits, tcache, _ = target.apply(params_t, verify_in, state.tcache,
                                           max_live=ml,
                                           tree=(tree.depths, tree.bits))
        res = acceptance.verify_tree_greedy(d.drafts, p_logits,
                                            tree.chain_slots)
        return VerifyOut(res=res, base_tokens=state.tokens, tcache=tcache)
    drafts = d.drafts[:, 0]
    verify_in = torch.cat([d.t_last[:, None], drafts], dim=1)
    ml = _live0(state) + spec.gamma
    p_logits, tcache, _ = target.apply(params_t, verify_in, state.tcache,
                                       max_live=ml)
    res = _greedy_verify(drafts, p_logits)
    return VerifyOut(res=res, base_tokens=state.tokens, tcache=tcache)


def _verify_recompute(target, params_t, state: RoundState, d: DraftOut,
                      spec: RoundSpec) -> VerifyOut:
    """Full-buffer target pass over the K stacked candidates; for K > 1 the
    best accepted prefix wins, ties to the drafter-greedy candidate 0
    (``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does)."""
    G = spec.gamma
    B, K, T = d.cand_tokens.shape
    p_full, _, _ = target.apply(params_t, d.cand_tokens.reshape(B * K, T))
    p_logits = _slice_logits(p_full, state.length - 1, G + 1)  # [B*K, G+1, V]
    res = _greedy_verify(d.drafts.reshape(B * K, G), p_logits)
    if K == 1:
        return VerifyOut(res=res, base_tokens=d.cand_tokens[:, 0])
    win = torch.argmax(res.n_emitted.reshape(B, K), dim=1)
    res = acceptance.VerifyResult(
        _take_candidate(res.n_accepted.reshape(B, K), win),
        _take_candidate(res.out_tokens.reshape(B, K, G + 1), win),
        _take_candidate(res.n_emitted.reshape(B, K), win))
    return VerifyOut(res=res, base_tokens=_take_candidate(d.cand_tokens, win))


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


def _tree_commit(state: RoundState, d: DraftOut, v: VerifyOut,
                 spec: RoundSpec) -> RoundState:
    """Tree-round commit (per row): compact the winner path's scattered KV
    into the committed tail, then the ordinary per-row commit. The winner
    chain's level-l token sits at cache position (length-1) +
    chain_slots[winner][l-1]; its committed home is length + l - 1 —
    src >= dst always, and ``compact`` gathers before it scatters, so the
    move is overlap-safe. Compacting all G levels is fine: rollback masks
    everything past the accepted length. The drafter side needs no
    compaction: the winner's branch already holds the committed chain
    contiguously, and ``PagedTreeRound`` adopts it."""
    G = spec.gamma
    B, W = d.drafts.shape[:2]
    dev = state.tokens.device
    cs = torch.as_tensor(chain_tree(W, G).chain_slots, device=dev)   # [W, G]
    src = (state.length - 1)[:, None] + cs[v.res.winner.long()]
    dst = state.length[:, None] + torch.arange(G, dtype=torch.int32,
                                               device=dev)
    tcache = cache_ops.ops_for(v.tcache).compact(v.tcache, src, dst)
    return _commit_rows(state, d, v._replace(tcache=tcache), spec)


def _commit_rows(state: RoundState, d: DraftOut, v: VerifyOut,
                 spec: RoundSpec) -> RoundState:
    """Commit each row's accepted prefix + roll both caches back. A drafter
    cache pre-branched for a tree round is left to ``PagedTreeRound``,
    which adopts each row's winning branch."""
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
    if not _is_paged_branched(dcache, B):
        dcache = cache_ops.ops_for(dcache).rollback(dcache, new_len - 1)
    return state._replace(
        tokens=tokens, length=new_len, dcache=dcache, tcache=tcache,
        n_rounds=state.n_rounds + 1,
        n_accepted=state.n_accepted + torch.where(active, res.n_accepted, zero),
        n_drafted=state.n_drafted + spec.drafted_per_round)


def _commit_batch_min(state: RoundState, v: VerifyOut,
                      spec: RoundSpec) -> RoundState:
    """No-cache batch-synchronized commit: every row commits the
    batch-minimum emitted length (discarded acceptances are re-drafted;
    exact at B=1), so ``length`` stays a scalar; no cache to roll back."""
    res = v.res
    B = state.tokens.shape[0]
    n_commit = res.n_emitted.min()
    tokens = _scatter_commit(v.base_tokens, state.length, res.out_tokens,
                             n_commit.expand(B), spec.gamma)
    return state._replace(
        tokens=tokens, length=state.length + n_commit,
        n_rounds=state.n_rounds + 1,
        n_accepted=state.n_accepted + (n_commit - 1),
        n_drafted=state.n_drafted + spec.drafted_per_round)


def commit_phase(target, state: RoundState, d: DraftOut, v: VerifyOut,
                 spec: RoundSpec) -> RoundState:
    """Phase 3: commit the accepted prefix (per row, or the batch minimum
    on the no-cache path) + roll the caches back."""
    if getattr(spec.policy, "name", "") == "tree":
        return _tree_commit(state, d, v, spec)
    if spec.commit == "batch_min":
        return _commit_batch_min(state, v, spec)
    return _commit_rows(state, d, v, spec)


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
