"""Paged continuous-batching speculative server (port of
``repro/serving/paged_server.py::PagedSpecServer``).

Every request carries its own prompt length and decode budget; KV lives in
a shared block pool per model (cache/paged_kv.py) and the Scheduler drives
admission, prefill, slot refill into the live block tables and the
cost-model gamma/AR decision. One round — speculative
(``BatchedSpecEngine.round``) or AR when the cost model says speculation
does not pay — advances the whole batch; between rounds the host harvests
finished rows, frees their blocks and refills slots. Target and drafter
consume identical token positions, so one allocator and one block table
drive both models' pools.

Prefill runs one of two ways. Bucketed (the default): a one-row prefill of
the whole prompt, padded to a bucket, straight into the shared pools.
Chunked (``SchedulerConfig.prefill_chunk`` or ``prefix_cache``): the row
first attaches the longest chain of cached blocks the prefix pool holds
for its prompt (cache/prefix_pool.py), then prefills the rest at most one
chunk per step, before that step's round, and registers its fully written
prompt blocks in the pool when done. A mid-prefill row is inactive and its
row of the device block table is pushed as NULL: rounds keep writing every
row at its stale index, in place, and those writes must not land in the
row's real blocks, which may be cached blocks other rows attach. A chunk
carries the row's true table, uploaded from the allocator.

Overcommit (``overcommit > 1``) admits on expected demand; before each
round every live row grows to the round's demand, and when the pool is dry
a victim is evicted and re-queued with its committed tokens, which its
re-admission prefills again (greedy decode then continues byte-identically).
``cancel(rid)`` tears a request down at the start of the next step.

A round pulls ``length`` and ``active`` to the host once; nothing else in
it syncs unless tracing is on or a streaming front end set
``collect_streams`` (then the token buffer comes over in one more pull
when a row committed, and each streamed token passes the output guard). Every round records one ``RoundEvent``
(``events``), charges its KV block reads (``kv_traffic``) and, when
speculative, feeds the cost-model ``DriftMonitor`` (``drift``), traced or
not. An ENABLED ``tracer`` (repro_torch.obs) runs speculative rounds as
``rounds.TracedRound`` (draft/verify/commit spans, the device synchronized
inside each) and puts spans around the serve, each prefill and each AR
round; the per-phase times then reach the events and the drift monitor,
whose measured c (t_draft per token / t_target) drives the gamma decision
unless ``cost_coefficient`` pins it. A disabled tracer (the default) adds
no sync and no launch.

Placement (``placement``, ``api/placement.py``): each role's params,
block pool and block table live on its own device, each role's prefill
runs there, speculative rounds run as ``rounds.PlacedRound`` (draft on the
drafter's device, verify and commit on the target's) and AR rounds run on
the target's with the drafter cache detached. The two roles always get
separate block-table tensors then, even on a shared device, so nothing one
role writes can reach the other's table. A dense-family role of several
devices on a model axis is tensor-parallel (``parallel.tp``): its params
are split over its devices and its pool is made split (one pool per
device), every forward runs on all of them,
and the logits the verify and the output guard read are gathered on its
first device; the failed-row zeroing runs on every shard's pool.

Robustness: ``faults`` (serving/faults.py) injects a seeded schedule keyed
by the step index (``total_steps``): pool seizures and releases before the
step, an injected ``DrafterFault`` raised before the speculative round,
virtual delays added to the round's time, and corruption of a committed
token after it (the output guard then fails that request). ``watchdog``
(serving/watchdog.py) degrades the batch to AR after straggling
speculative rounds. A degraded batch stays on AR until it drains
(``_batch_drained``), and each degradation is logged in
``metrics.degradations`` and marked on its events. The port degrades only
on a ``DrafterFault`` and on the watchdog's trip; any other exception in
the round propagates out of ``step()``. The JAX server degrades on every
exception, which here would turn a failing CUDA kernel into a silent AR
run.

Two more differences from the JAX server: the last chunk of a prefill runs
at its true length, not padded to the chunk (no padding is ever written,
so none can wrap onto the row's last block), and the drafter's prefill
unembeds only its last position.

Invariant (tested): every completed request's tokens equal that prompt's
standalone greedy AR continuation, regardless of its neighbours' lengths,
the prefill path, the prefix pool, preemption or cancellation of others.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.cache.ops import PAGED
from repro_torch.cache.paged_kv import NULL_BLOCK, BlockAllocator
from repro_torch.cache.prefix_pool import PrefixPool
from repro_torch.core import rounds
from repro_torch.core.batched_engine import (KV_FAMILIES, BatchedEngineConfig,
                                             BatchedSpecEngine, RowState)
from repro_torch.obs import clock
from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.events import RoundEvent, RoundEventLog
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.parallel.shards import parts
from repro_torch.serving.faults import NO_FAULTS, DrafterFault, FaultPlan
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig, ServeRequest
from repro_torch.serving.watchdog import RoundWatchdog


def _set_rows(state: RowState, b: int, **fields) -> RowState:
    """``state`` with row ``b`` of each named [B] (or [B, T]) tensor set to
    the given value; the tensors are copied, never written in place."""
    out = {}
    for name, value in fields.items():
        t = getattr(state, name).clone()
        t[b] = value
        out[name] = t
    return state._replace(**out)


def _set_index(state: RowState, b: int, index: int) -> RowState:
    """``state`` with row ``b`` of both caches' index set to ``index``."""
    caches = {}
    for name in ("tcache", "dcache"):
        cache = getattr(state, name)
        t = cache["index"].clone()
        t[b] = index
        caches[name] = {**cache, "index": t}
    return state._replace(**caches)


class PagedSpecServer:
    def __init__(self, target, drafter, params_t, params_d,
                 scfg: Optional[SchedulerConfig] = None, *,
                 gamma: Optional[int] = None,
                 alpha: Optional[float] = None,
                 cost_coefficient: Optional[float] = None,
                 placement=None, tracer=None,
                 faults: Optional[FaultPlan] = None,
                 watchdog: Optional[RoundWatchdog] = None,
                 now=clock.wall, device=None):
        """``gamma``/``alpha``/``cost_coefficient`` override the scheduler's
        cost-model decision (None = decide online from telemetry; c then
        comes from the drift monitor once it has evidence). ``placement``,
        ``faults`` (default ``NO_FAULTS``) and ``watchdog`` (default
        ``RoundWatchdog()``): see the module docstring; ``tracer`` too. The
        server's state lives on ``device`` (``cuda`` unless the caller asks
        for the CPU), each role's on its placed device; the params must
        already be on ``device``."""
        if target.family not in KV_FAMILIES or drafter.family not in KV_FAMILIES:
            raise ValueError("paged speculative serving needs KV-cache "
                             f"families {KV_FAMILIES}, got "
                             f"{target.family}/{drafter.family}")
        self.device = devices.resolve(device)
        self.target, self.drafter = target, drafter
        self.placement = (placement if placement is not None
                          and placement.heterogeneous else None)
        if self.placement is not None:
            params_t = self.placement.target.put_params(target, params_t)
            params_d = self.placement.drafter.put_params(drafter, params_d)
        self.params_t, self.params_d = params_t, params_d
        # each role's device: its placed one, else the server's
        pm = self.placement
        self.dev_t = (pm.target.device if pm is not None else None) or self.device
        self.dev_d = (pm.drafter.device if pm is not None else None) or self.device
        self.scfg = scfg or SchedulerConfig()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.faults = faults if faults is not None else NO_FAULTS
        self.watchdog = watchdog if watchdog is not None else RoundWatchdog()
        self.metrics = ServingMetrics(gamma_max=self.scfg.gamma_max, now=now)
        self.events = RoundEventLog(alpha_ema=self.metrics.alpha_ema)
        self.drift: Optional[DriftMonitor] = None  # built at first spec round
        self.alloc = BlockAllocator(self.scfg.num_blocks, self.scfg.block_size,
                                    self.scfg.max_blocks_per_row,
                                    self.scfg.max_batch)
        self.sched = Scheduler(self.scfg, self.alloc, self.metrics)
        self._gamma_override = gamma
        self._alpha_override = alpha
        self._c_override = cost_coefficient

        self.B = self.scfg.max_batch
        self.T = self.scfg.max_tokens_per_row + self.scfg.gamma_max + 2
        self._slots: List[Optional[ServeRequest]] = [None] * self.B
        self._target_len = np.zeros(self.B, np.int64)
        # chunked-prefill state: None on the bucketed path. Mid-prefill rows
        # are ``_masked`` (inactive, their pushed table row NULL)
        self._chunk = self.scfg.effective_chunk if self.scfg.chunked else None
        self.prefix_pool = (PrefixPool(self.alloc) if self.scfg.prefix_cache
                            else None)
        self._prefill_pos = np.zeros(self.B, np.int64)  # next suffix position
        self._prefill_hit = np.zeros(self.B, np.int64)  # tokens from cache
        self._prefill_chunks = np.zeros(self.B, np.int64)
        self._masked: set = set()
        self._table_masked: frozenset = frozenset()  # masked set last pushed
        # this step's chunk-program work, for its RoundEvent and the drift
        # monitor
        self._round_prefill_tokens = 0
        self._round_prefill_chunks = 0
        self._round_prefill_t = 0.0
        self._aborted_pending: List[int] = []  # mid-prefill evictions
        self._pending_cancels: Deque[int] = deque()  # processed at next step
        self._state: Optional[RowState] = None
        self._lengths: Optional[np.ndarray] = None  # host mirror of .length
        self._batch_formed = False   # gamma decided for the current batch
        self._engines: Dict[int, BatchedSpecEngine] = {}
        self._table_version = -1    # last allocator.version pushed to device
        self.gamma = None           # decided at batch formation
        self._degraded = False      # watchdog/fault AR pin (one-way until
                                    # the batch drains and re-forms)
        self._vocab = int(target.cfg.vocab_size)  # output-guard bound
        self._failed_pending: List[int] = []
        # the per-round token harvest for streaming front ends; off, a round
        # pulls no token to the host
        self.collect_streams = False
        self.done: List[ServeRequest] = []
        self.total_rounds = 0
        self.total_steps = 0        # step() calls incl. idle steps: the
                                    # fault plan's index (it advances when no
                                    # round runs, so seized blocks keyed to a
                                    # later step always come back)
        self.n_prefills = 0         # bucketed prefills run (one forward each)
        self.n_prefill_chunks = 0   # chunk programs run (one forward each)
        # paged-attention read accounting (kv_traffic()): per-round KV
        # gathers, live-bounded vs worst-case row capacity, for the target
        # (verify / AR read) and the drafter (gamma draft reads per
        # speculative round; none under AR)
        self.kv_blocks_read_t = 0
        self.kv_blocks_read_d = 0
        self.kv_blocks_capacity_t = 0
        self.kv_blocks_capacity_d = 0

    # ------------------------------------------------------------- plumbing
    def submit(self, req: ServeRequest):
        self.sched.submit(req)

    def inject_faults(self, plan: FaultPlan):
        """Swap the fault schedule in (chaos runs; safe before the first
        step)."""
        self.faults = plan

    def _engine(self, gamma: int) -> BatchedSpecEngine:
        if gamma not in self._engines:
            self._engines[gamma] = BatchedSpecEngine(
                self.target, self.drafter, BatchedEngineConfig(gamma=gamma),
                placement=self.placement, tracer=self.tracer)
        return self._engines[gamma]

    def _empty_state(self) -> RowState:
        """Empty pools for both roles, a tensor-parallel role's made split
        (one pool per device, its KV heads), and the row state."""
        B, dev, pm = self.B, self.dev_t, self.placement
        lay_t = pm.target.layout(self.target) if pm is not None else None
        lay_d = pm.drafter.layout(self.drafter) if pm is not None else None
        geom = dict(num_blocks=self.scfg.num_blocks,
                    block_size=self.scfg.block_size,
                    max_blocks_per_row=self.scfg.max_blocks_per_row)
        st = RowState(
            tokens=torch.zeros((B, self.T), dtype=torch.int32, device=dev),
            length=torch.ones((B,), dtype=torch.int32, device=dev),  # length-1 >= 0
            dcache=PAGED.init(self.drafter, B, device=self.dev_d,
                              layout=lay_d, **geom),
            tcache=PAGED.init(self.target, B, device=self.dev_t,
                              layout=lay_t, **geom),
            active=torch.zeros((B,), dtype=torch.bool, device=dev),
            n_rounds=torch.zeros((), dtype=torch.int32, device=dev),
            n_accepted=torch.zeros((B,), dtype=torch.int32, device=dev),
            n_drafted=torch.zeros((), dtype=torch.int32, device=dev))
        if pm is not None:
            st = rounds.place_state(st, pm, self.target, self.drafter)
        return st

    def _tables(self, host: np.ndarray):
        """Device copies of a host block table (rows) for (target, drafter):
        one shared tensor unplaced; placed, two independent uploads, one on
        each role's device, so that neither role's table is the other's."""
        if self.placement is None:
            table = torch.from_numpy(host).to(self.device)
            return table, table
        return (self.placement.to_target(torch.from_numpy(host.copy())),
                self.placement.to_drafter(torch.from_numpy(host.copy())))

    def _sync_tables(self, state: RowState) -> RowState:
        """Push the host block table to the device, only when the allocator
        or the mid-prefill set changed since the last push. Mid-prefill rows
        go as NULL, so the rounds' writes at their stale index land in the
        null block. Unplaced, both caches share the one device table."""
        masked = frozenset(self._masked)
        if (self._table_version == self.alloc.version
                and self._table_masked == masked):
            return state
        self._table_version = self.alloc.version
        self._table_masked = masked
        host = self.alloc.table.copy()
        if masked:
            host[sorted(masked)] = NULL_BLOCK
        t_table, d_table = self._tables(host)
        return state._replace(tcache={**state.tcache, "block_table": t_table},
                              dcache={**state.dcache, "block_table": d_table})

    def _row_views(self, state: RowState, b: int, start: int):
        """One-row views of both caches for a prefill of row ``b`` from
        position ``start``: the row's TRUE table (the pushed one may have
        it nulled), uploaded from the allocator, and the pools shared; each
        on its role's device."""
        t_table, d_table = self._tables(self.alloc.table[b:b + 1].copy())
        return ({**state.tcache, "block_table": t_table,
                 "index": torch.full((1,), start, dtype=torch.int32,
                                     device=self.dev_t)},
                {**state.dcache, "block_table": d_table,
                 "index": torch.full((1,), start, dtype=torch.int32,
                                     device=self.dev_d)})

    def _forward_prefill(self, state: RowState, b: int, toks: np.ndarray,
                         start: int) -> torch.Tensor:
        """Write the KV of ``toks`` (positions start..) into both pools for
        row ``b``, each role's prefill on its own device; returns the 0-dim
        device flag "the target's logits are all finite" (the caller pulls
        it). The drafter's prefill logits are never read: it unembeds only
        the last position."""
        tview, dview = self._row_views(state, b, start)
        x = torch.from_numpy(np.ascontiguousarray(toks[None]))
        logits, _, _ = self.target.apply(self.params_t, x.to(self.dev_t), tview)
        self.drafter.apply(self.params_d, x.to(self.dev_d), dview,
                           logits_slice="last")
        return torch.isfinite(logits).all()

    # -------------------------------------------------------------- prefill
    def _prefill_into(self, state: RowState, row: int, req: ServeRequest):
        """Length-bucketed one-row prefill written straight into the shared
        pools (in place), then rolled back to the true prompt length (exact:
        the padded tail is causally invisible to the real tokens and masked
        afterward). A PREEMPTED request prefills its ``effective_prompt``,
        the committed prefix snapshotted at eviction, and decodes on from
        there.

        Returns ``(state, ok)``: ``ok`` is False when the target produced
        non-finite prefill logits — the caller fails the request instead of
        decoding from a poisoned cache."""
        prompt = np.asarray(req.effective_prompt, np.int32)
        padded = self.sched.pad_to_bucket(prompt)
        P = req.resume_len
        with self.tracer.span("prefill", phase="prefill", role="target",
                              rid=req.rid, prompt_len=P):
            ok = self._forward_prefill(state, row, padded[:-1], 0)
            if self.tracer.enabled:
                for dev in {self.dev_t, self.dev_d}:
                    devices.synchronize(dev)
        ok = bool(ok)
        self.n_prefills += 1
        tokens = state.tokens.clone()
        tokens[row] = 0
        tokens[row, :P] = torch.from_numpy(prompt).to(self.dev_t)
        # target_len counts from the ORIGINAL prompt: a resumed request
        # only owes the rest of its decode budget
        self._target_len[row] = req.prompt_len + req.max_new
        state = _set_rows(state._replace(tokens=tokens), row, length=P,
                          active=True)
        return _set_index(state, row, P - 1), ok

    # ------------------------------------------------- chunked prefill path
    def _begin_prefill(self, state: RowState, b: int,
                       req: ServeRequest) -> RowState:
        """Admit ``req`` into row ``b`` on the chunked path: look up the
        prefix pool, attach any cached block chain (the row then prefills
        only its suffix), stage the prompt tokens and mark the row
        mid-prefill until ``_advance_prefills`` finishes the suffix. The
        re-grow after the attach cannot fail: admission's grant goes back to
        the free list first and cached blocks take none."""
        prompt = np.asarray(req.effective_prompt, np.int32)
        P, BS = req.resume_len, self.scfg.block_size
        hit_blocks: List[int] = []
        if self.prefix_pool is not None and P > 1:
            # cap at (P-1)//BS blocks: the row's first decode write lands at
            # position P-1, which must NEVER fall inside a shared block
            cap = min((P - 1) // BS, self.scfg.max_blocks_per_row)
            hit_blocks = self.prefix_pool.lookup(prompt, cap)
            if hit_blocks:
                admit = self.sched.admit_tokens(req)
                self.alloc.free_row(b)
                self.alloc.attach(b, hit_blocks)
                if not self.alloc.ensure(b, admit):
                    raise AssertionError("re-grow after a cached-prefix attach failed")
        start = len(hit_blocks) * BS
        self._prefill_pos[b] = start
        self._prefill_hit[b] = start
        self._prefill_chunks[b] = 0
        self._target_len[b] = req.prompt_len + req.max_new
        self._masked.add(b)
        tokens = state.tokens.clone()
        tokens[b] = 0
        tokens[b, :P] = torch.from_numpy(prompt).to(self.dev_t)
        # reset the device length: the slot's previous occupant left its
        # final length behind, which must not read as instant completion
        return _set_rows(state._replace(tokens=tokens), b, length=1, active=False)

    def _run_chunk(self, state: RowState, b: int, req: ServeRequest):
        """One chunk program for mid-prefill row ``b``: write KV for suffix
        positions [pos, min(pos + C, P - 1)). The last chunk runs at its
        true length. Returns ``ok`` (finite target logits), or None when
        the pool is dry (the caller aborts the prefill)."""
        prompt = np.asarray(req.effective_prompt, np.int32)
        s = int(self._prefill_pos[b])
        e = min(s + self._chunk, req.resume_len - 1)
        if not self.sched.grow(b, e):
            return None
        t0 = self.tracer.clock()
        with self.tracer.span("prefill_chunk", phase="prefill", role="target",
                              rid=req.rid, start=s, end=e):
            ok = self._forward_prefill(state, b, prompt[s:e], s)
        ok = bool(ok)
        self.n_prefill_chunks += 1
        self._prefill_pos[b] = e
        self._prefill_chunks[b] += 1
        self._round_prefill_tokens += e - s
        self._round_prefill_chunks += 1
        self._round_prefill_t += self.tracer.clock() - t0
        return ok

    def _complete_prefill(self, state: RowState, b: int,
                          req: ServeRequest) -> RowState:
        """Suffix done: register the fully written prompt blocks in the
        prefix pool, unmask the row, set its committed length and index,
        activate it. Registered blocks sit strictly below position P-1, so
        this row and every attacher write only past them."""
        P, BS = req.resume_len, self.scfg.block_size
        if self.prefix_pool is not None and P > 1:
            F = min((P - 1) // BS, self.scfg.max_blocks_per_row)
            if F > 0:
                prompt = np.asarray(req.effective_prompt, np.int32)
                self.prefix_pool.insert(prompt[:F * BS],
                                        [int(x) for x in self.alloc.table[b, :F]])
        self._masked.discard(b)
        hit = int(self._prefill_hit[b])
        self.metrics.prefill(req.rid, max(P - 1 - hit, 0), hit_tokens=hit,
                             chunks=int(self._prefill_chunks[b]))
        self._lengths[b] = P
        return _set_index(_set_rows(state, b, length=P, active=True), b, P - 1)

    def _abort_prefill(self, state: RowState, b: int,
                       req: ServeRequest) -> RowState:
        """Mid-prefill eviction: free the row's blocks and re-queue.
        Re-admission restarts the prefill (cheaply, when the prefix pool
        still holds the chain)."""
        self.alloc.free_row(b)
        self._masked.discard(b)
        self._slots[b] = None
        self.sched.requeue(req)
        self._aborted_pending.append(req.rid)
        return _set_rows(state, b, active=False)

    def _advance_prefills(self, state: RowState) -> RowState:
        """Advance mid-prefill rows by at most ONE chunk program per step,
        so the prefill work between two rounds stays bounded. Fully cached
        rows (empty suffix) and rows whose chunk just finished the suffix
        activate this step."""
        if self._chunk is None or not self._masked:
            return state
        budget = 1
        for b in sorted(self._masked):
            req = self._slots[b]
            P = req.resume_len
            if int(self._prefill_pos[b]) >= P - 1:
                state = self._complete_prefill(state, b, req)
                continue
            if budget <= 0:
                continue
            budget -= 1
            ok = self._run_chunk(state, b, req)
            if ok is None:
                state = self._abort_prefill(state, b, req)
                continue
            if not ok:
                # non-finite target logits: fail cleanly, never decode from
                # a poisoned cache
                self.alloc.free_row(b)
                self._masked.discard(b)
                self.metrics.fail(req.rid, "non-finite prefill logits",
                                  n_generated=req.resume_len - req.prompt_len)
                self._failed_pending.append(req.rid)
                self._slots[b] = None
                continue
            if int(self._prefill_pos[b]) >= P - 1:
                state = self._complete_prefill(state, b, req)
        return state

    # ------------------------------------------------------------- AR round
    def _ar_round(self, state: RowState) -> RowState:
        """gamma* = 0 fallback: one committed token per active row per round,
        target model only. Placed, it runs on the target's device with the
        drafter cache detached and reattached untouched."""
        if self.placement is not None:
            out = rounds.ar_round(self.target, self.params_t,
                                  state._replace(dcache=None))
            return out._replace(dcache=state.dcache)
        return rounds.ar_round(self.target, self.params_t, state)

    # -------------------------------------------------------------- serving
    def _refill(self, state: RowState, lengths: np.ndarray) -> RowState:
        for b in range(self.B):
            if self._slots[b] is not None:
                continue
            req = self.sched.try_admit(b)
            if req is None:
                break                       # FCFS head-blocking
            if self._chunk is not None:
                state = self._begin_prefill(state, b, req)
                lengths[b] = 1              # mirrors the reset device length
                self._slots[b] = req
                continue
            state, ok = self._prefill_into(state, b, req)
            if not ok:
                # non-finite target logits: fail the request cleanly instead
                # of decoding from a poisoned cache
                self.alloc.free_row(b)
                self.metrics.fail(req.rid, "non-finite prefill logits",
                                  n_generated=req.resume_len - req.prompt_len)
                self._failed_pending.append(req.rid)
                state = _set_rows(state, b, active=False)
                continue
            self.metrics.prefill(req.rid, max(req.resume_len - 1, 0))
            lengths[b] = req.resume_len     # keep the host mirror current
            self._slots[b] = req
        return state

    def _harvest(self, state: RowState, lengths: np.ndarray) -> RowState:
        """``lengths`` is the round's single host snapshot of state.length.
        Completing rows pass the output guard before release: a committed
        token outside the vocabulary fails the request with the reason
        recorded instead of returning garbage."""
        for b in range(self.B):
            req = self._slots[b]
            if (req is None or b in self._masked
                    or lengths[b] < self._target_len[b]):
                continue
            toks = state.tokens[b, :self._target_len[b]].cpu().numpy()
            gen = toks[req.prompt_len:]
            if ((gen < 0) | (gen >= self._vocab)).any():
                self._fail_row(b, req, int(self._target_len[b]))
            else:
                req.tokens = toks
                self.sched.release(b, req)
                self.done.append(req)
                self._slots[b] = None
            state = _set_rows(state, b, active=False)
        return self._sync_tables(self._refill(state, lengths))

    def _fail_row(self, b: int, req: ServeRequest, cur: int):
        """Terminal-failure teardown of an in-flight row with a corrupt
        committed token: blocks freed, reason recorded, rid queued for the
        step-info. The caller clears the row's active flag.

        Before the blocks go back to the free list, the K/V of each block the
        row owns alone (refcount 1, not pinned by the prefix pool) is zeroed
        in every layer of both roles' pools: the rounds between the
        corruption and this guard fed the bad id, whose embedding is NaN, so
        those blocks hold NaN K/V, and a later request that reads them as
        masked stale slots would still turn NaN (0 x NaN). Cached, attached
        and copy-on-write-shared blocks hold prompt KV other requests read,
        and keep their bytes. JAX frees the blocks as they are."""
        alloc = self.alloc
        owned = [int(blk) for blk in alloc.table[b, :int(alloc.n_alloc[b])]
                 if alloc.refcnt[blk] == 1 and int(blk) not in alloc.cached]
        if owned and self._state is not None:
            for cache in (self._state.tcache, self._state.dcache):
                for name in ("k", "v"):
                    for pool in parts(cache[name]):   # every shard's pool
                        pool.index_fill_(1, torch.tensor(
                            owned, dtype=torch.long, device=pool.device), 0)
        self.alloc.free_row(b)
        self.metrics.fail(req.rid,
                          f"corrupt token id outside [0, {self._vocab})",
                          n_generated=max(cur - req.prompt_len, 0))
        self._failed_pending.append(req.rid)
        self._slots[b] = None

    def _corrupt_one_row(self, lengths):
        """Fault injection: poison the newest committed token of the first
        emitting row to an out-of-vocab id; the output guard must fail that
        request instead of returning the garbage."""
        for b, req in enumerate(self._slots):
            if req is None:
                continue
            cur = int(min(lengths[b], self._target_len[b]))
            if cur > req.prompt_len:
                tokens = self._state.tokens.clone()
                tokens[b, cur - 1] = self._vocab
                self._state = self._state._replace(tokens=tokens)
                return

    def _harvest_streams(self, prev_len, lengths) -> Dict[int, np.ndarray]:
        """Newly committed tokens per live request this round (committed ==
        final: verify accepted them, so streaming is exact). TTFT is stamped
        here on every path; the tokens come to the host, in one pull for
        all emitting rows, only when ``collect_streams`` is set. Streamed
        tokens pass the output guard first: a token outside the vocabulary
        fails the request instead of reaching a client."""
        streams: Dict[int, np.ndarray] = {}
        tok_host = None
        for b, req in enumerate(self._slots):
            if req is None or b in self._masked:
                continue        # mid-prefill: nothing committed yet
            cur = int(min(lengths[b], self._target_len[b]))
            if cur > req.prompt_len:
                self.metrics.first_token(req.rid)   # idempotent
            if not self.collect_streams or cur <= int(prev_len[b]):
                continue
            if tok_host is None:
                tok_host = self._state.tokens.cpu().numpy()
            new = tok_host[b, int(prev_len[b]):cur].copy()
            if ((new < 0) | (new >= self._vocab)).any():
                self._fail_row(b, req, cur)
                self._state = _set_rows(self._state, b, active=False)
                continue
            streams[req.rid] = new
        return streams

    # ----------------------------------------------------------- preemption
    def _committed(self, b: int) -> int:
        return int(min(self._lengths[b], self._target_len[b]))

    def _choose_victim(self, prefer_not: int) -> Optional[int]:
        """Victim policy: among occupied rows, LATEST deadline first (None
        sorts latest), ties broken by fewest committed tokens (cheapest
        recompute). The occupied row with the earliest deadline is spared
        whenever another candidate exists, and so is the row whose growth
        triggered the eviction (``prefer_not``), evicted only as the last
        resort."""
        occupied = [b for b in range(self.B) if self._slots[b] is not None]
        if not occupied:
            return None

        def dl(b):
            d = self._slots[b].deadline
            return float("inf") if d is None else d

        cands = list(occupied)
        if len(cands) > 1:
            head = min(occupied, key=lambda b: (dl(b), b))
            cands = [b for b in cands if b != head]
        if prefer_not in cands and len(cands) > 1:
            cands = [b for b in cands if b != prefer_not]
        return max(cands, key=lambda b: (dl(b), -self._committed(b), -b))

    def _preempt_row(self, b: int, state: RowState) -> RowState:
        """Evict row ``b``: snapshot its committed prefix (prompt +
        generated tokens, never unverified speculation), free ALL its KV
        blocks and re-queue the request."""
        req = self._slots[b]
        if b in self._masked:
            # mid-prefill victim: nothing committed beyond the prefix it is
            # already prefilling
            return self._abort_prefill(state, b, req)
        cur = self._committed(b)
        req.resume_tokens = state.tokens[b, :cur].cpu().numpy().astype(np.int32)
        req.preemptions += 1
        self.alloc.free_row(b)
        self._slots[b] = None
        self.sched.requeue(req)
        return _set_rows(state, b, active=False)

    def _ensure_capacity(self, state: RowState):
        """Overcommit enforcement between the gamma decision and the round:
        every live row must own blocks for its committed prefix plus this
        round's gamma + 1 unverified tokens. When the pool runs dry, evict
        victims until the row fits. Under worst-case reservation the
        admission grant already covers every round, so nothing is evicted.
        Returns ``(state, preempted_rids)``."""
        preempted: List[int] = []
        for b in range(self.B):
            if self._slots[b] is None or b in self._masked:
                continue   # mid-prefill rows grow chunk by chunk instead
            needed = self._committed(b) + self.gamma + 1
            while self._slots[b] is not None and not self.sched.grow(b, needed):
                victim = self._choose_victim(prefer_not=b)
                if victim is None:
                    break
                preempted.append(self._slots[victim].rid)
                state = self._preempt_row(victim, state)
                if victim == b:
                    break               # the growing row evicted itself
        return state, preempted

    # ----------------------------------------------------------- telemetry
    def _account_round(self, prev_len: np.ndarray):
        """Per-round paged-attention read bound: with live = batch-max
        committed length of the occupied rows, a speculative round reads
        ceil((live+i)/BS) blocks per row for draft step i plus
        ceil((live+gamma)/BS) for the verify; an AR round reads
        ceil(live/BS) on the target only — against max_blocks_per_row per
        gather at worst. Feeds kv_traffic().

        Returns ``(blocks_read, blocks_written)`` for this round (the write
        side is a span estimate: distinct blocks covering the gamma + 1
        unverified target writes plus gamma drafter writes per occupied
        row), the RoundEvent's traffic fields."""
        occupied = np.array([s is not None for s in self._slots])
        n_occ = int(occupied.sum())
        live = int(prev_len[occupied].max()) if occupied.any() else 1
        bs, mb = self.scfg.block_size, self.scfg.max_blocks_per_row

        def blocks(tokens):
            return min(-(-tokens // bs), mb)

        def write_span(n_new):
            # distinct blocks covering token positions [live, live + n_new)
            return 0 if n_new <= 0 else (live + n_new - 1) // bs - live // bs + 1

        if self.gamma > 0:
            t_blocks, d_gathers = blocks(live + self.gamma), self.gamma
            d_blocks = sum(blocks(live + i) for i in range(self.gamma))
            written = (write_span(self.gamma + 1)
                       + write_span(self.gamma)) * n_occ
        else:
            t_blocks, d_gathers, d_blocks = blocks(live), 0, 0
            written = write_span(1) * n_occ
        self.kv_blocks_read_t += t_blocks * self.B
        self.kv_blocks_read_d += d_blocks * self.B
        self.kv_blocks_capacity_t += mb * self.B
        self.kv_blocks_capacity_d += d_gathers * mb * self.B
        return (t_blocks + d_blocks) * self.B, written

    def kv_traffic(self) -> Dict[str, float]:
        """KV bytes gathered by the rounds' attention reads, live-block
        bounded (actual) vs worst-case row capacity. Target and drafter
        gathers are charged against their own pools' block sizes."""
        def per_block(cache):
            total = 0
            for leaf in cache.values():
                if leaf.ndim == 5:          # [L, NB, BS, Kv, D] pools
                    L, _, BS, Kv, D = leaf.shape
                    total += L * BS * Kv * D * leaf.element_size()
            return total

        pt = per_block(self._state.tcache) if self._state is not None else 0
        pd = per_block(self._state.dcache) if self._state is not None else 0
        return {"read_blocks": self.kv_blocks_read_t + self.kv_blocks_read_d,
                "capacity_blocks": (self.kv_blocks_capacity_t
                                    + self.kv_blocks_capacity_d),
                "read_bytes": (self.kv_blocks_read_t * pt
                               + self.kv_blocks_read_d * pd),
                "capacity_bytes": (self.kv_blocks_capacity_t * pt
                                   + self.kv_blocks_capacity_d * pd)}

    def _measured_c(self) -> Optional[float]:
        """Drift-measured cost coefficient, once the monitor has evidence:
        the next gamma decision uses the MEASURED t_draft/t_target instead
        of the configured prior."""
        if self._c_override is not None or self.drift is None:
            return None
        ev = self.drift.evidence()
        return ev["c"] if ev else None

    def _record_event(self, prev_len, lengths, active, rids, t_round,
                      phase_t, blocks_read, blocks_written, queue_depth,
                      n_preempted, n_expired, n_failed, fault_delay):
        """One RoundEvent per round (always, traced or not) + a drift
        observation per speculative round (phase times when traced)."""
        emitted = lengths - prev_len
        accepted = tuple(int(max(e - 1, 0))
                         for e, a in zip(emitted, active) if a)
        live_rids = tuple(r for r, a in zip(rids, active)
                          if a and r is not None)
        t_prefill = (self._round_prefill_t if self._round_prefill_chunks
                     else None)
        self.events.record(RoundEvent(
            round=self.total_rounds - 1, gamma=self.gamma,
            n_active=int(np.sum(active)), accepted=accepted,
            emitted=int(emitted[active].sum()) if active.any() else 0,
            t_round=t_round,
            t_draft=phase_t.get("draft"), t_verify=phase_t.get("verify"),
            t_commit=phase_t.get("commit"),
            blocks_read=blocks_read, blocks_written=blocks_written,
            rids=live_rids, t_wall=clock.wall(), queue_depth=queue_depth,
            n_preempted=n_preempted, n_expired=n_expired, n_failed=n_failed,
            degraded=self._degraded, fault_delay=fault_delay,
            prefill_tokens=self._round_prefill_tokens,
            prefill_chunks=self._round_prefill_chunks, t_prefill=t_prefill,
            prefix_hit_rate=self.metrics.prefix_hit_rate()))
        if self.gamma > 0:
            if self.drift is None:
                c = (self._c_override if self._c_override is not None
                     else self.scfg.cost_coefficient)
                self.drift = DriftMonitor(self.gamma, c)
            self.drift.observe(t_round=t_round,
                               t_draft=phase_t.get("draft"),
                               t_verify=phase_t.get("verify"),
                               t_commit=phase_t.get("commit"),
                               t_prefill=t_prefill, gamma=self.gamma)

    # --------------------------------------------------------- cancellation
    def cancel(self, rid: int):
        """Ask for ``rid`` (queued or in flight) to be cancelled. The
        teardown runs at the start of the next ``step()``: a queued request
        leaves the queue; an in-flight row is released with its committed
        tokens and its blocks go back to the pool, so the row can be
        refilled in the same step."""
        self._pending_cancels.append(rid)

    def _process_cancels(self) -> List[int]:
        cancelled: List[int] = []
        while self._pending_cancels:
            rid = self._pending_cancels.popleft()
            if self.sched.cancel(rid):          # still queued: just dequeue
                cancelled.append(rid)
                continue
            for b, req in enumerate(self._slots):
                if req is None or req.rid != rid:
                    continue
                if b in self._masked:
                    # cancelled mid-prefill: nothing decoded
                    req.tokens = np.asarray(req.effective_prompt, np.int32)
                    self._masked.discard(b)
                    cur = req.prompt_len
                else:
                    cur = self._committed(b)
                    req.tokens = self._state.tokens[b, :cur].cpu().numpy()
                self.alloc.free_row(b)
                self.metrics.cancel(rid, cur - req.prompt_len)
                self._slots[b] = None
                self._state = _set_rows(self._state, b, active=False)
                cancelled.append(rid)
                break
        return cancelled

    # ------------------------------------------------------------ the loop
    def run(self):
        """Drain the queue; returns completed requests (rows finish by their
        own lengths, so not in submission order)."""
        with self.tracer.span("serve", phase="serve"):
            while self.step() is not None:
                pass
            return self.done

    def _batch_drained(self):
        """The current batch is over: the next admission re-forms it (and
        re-decides gamma; no live row carries stale drafter KV then). The
        degradation and the watchdog recover with the batch."""
        self._batch_formed = False
        self._degraded = False
        self.watchdog.reset()

    def _drain_failed(self) -> List[int]:
        out, self._failed_pending = self._failed_pending, []
        return out

    def _drain_aborted(self, seen: List[int]) -> List[int]:
        """Mid-prefill evictions since the last drain, less those already
        in ``seen``."""
        out, self._aborted_pending = self._aborted_pending, []
        return [r for r in out if r not in seen]

    def _idle_info(self, cancelled, expired, failed, preempted) -> Dict:
        """The step-info of a step in which no round ran."""
        return {"streams": {}, "finished": [], "cancelled": cancelled,
                "expired": expired, "failed": failed, "preempted": preempted,
                "round": None,
                "queue_depth": len(self.sched.queue), "n_live": 0}

    def step(self) -> Optional[Dict]:
        """ONE serving round: apply the step's pool faults, process
        cancellations, admit/refill (expiring doomed queue heads), advance
        one prefill chunk, decide gamma, enforce block capacity (preempting
        victims under overcommit), run one round (AR when degraded), record
        telemetry, harvest finished rows. Returns None when idle, else a
        step-info dict: ``streams`` ({rid: tokens committed this round},
        filled only when ``collect_streams`` is set), finished / cancelled /
        expired / failed / preempted (evicted and re-queued, not terminal)
        rids, the round id (None when no round ran; the stream events join
        the round events through it), queue depth and live rows. ``run()``
        is ``while step() is not None``: the synchronous and the streaming
        paths share this one loop, which keeps their tokens identical."""
        if self._state is None:
            self._state = self._empty_state()
            self._lengths = self._state.length.cpu().numpy().astype(np.int64)
        step_idx = self.total_steps
        self.total_steps += 1
        delta = self.faults.pool_delta(step_idx)
        if delta > 0:
            self.alloc.seize(delta)
        elif delta < 0:
            self.alloc.release_seized(-delta)
        cancelled = self._process_cancels()
        self._round_prefill_tokens = 0
        self._round_prefill_chunks = 0
        self._round_prefill_t = 0.0
        self._state = self._refill(self._state, self._lengths)
        # one chunk program per step, BEFORE the round, so a row whose
        # suffix completes decodes this step
        self._state = self._sync_tables(self._advance_prefills(self._state))
        expired = self.sched.drain_expired()
        if not any(r is not None for r in self._slots):
            self._batch_drained()
            failed = self._drain_failed()
            if cancelled or expired or failed or self.sched.has_work():
                return self._idle_info(cancelled, expired, failed,
                                       self._drain_aborted([]))
            return None
        if all(b in self._masked for b in range(self.B)
               if self._slots[b] is not None):
            # every occupied row is still mid-prefill: no round to run
            return self._idle_info(cancelled, expired, self._drain_failed(),
                                   self._drain_aborted([]))

        # gamma/AR decision (paper Eq. 1, telemetry alpha): decided at batch
        # formation, then re-decided while speculative. AR->spec is one-way
        # OFF within a batch: the drafter KV is not written during AR
        # rounds, so it resynchronizes only at the next batch formation.
        if self._gamma_override is not None:
            self.gamma = self._gamma_override
        elif not self._batch_formed or self.gamma > 0:
            self.gamma, _ = self.sched.choose_gamma(
                self._alpha_override, self._c_override or self._measured_c())
        self._batch_formed = True
        if self._degraded:
            # degradation wins over a pinned gamma: a tripped watchdog or a
            # failed drafter keeps the batch on AR until it drains
            self.gamma = 0

        # overcommit: grow every live row to this round's demand, evicting
        # victims when the pool is dry
        self._state, preempted = self._ensure_capacity(self._state)
        preempted += self._drain_aborted(preempted)
        self._state = self._sync_tables(self._state)
        if not any(r is not None for r in self._slots):
            # extreme pressure evicted the whole batch; deliver and retry
            self._batch_drained()
            return self._idle_info(cancelled, expired, self._drain_failed(),
                                   preempted)

        queue_depth = len(self.sched.queue)
        prev_len = self._lengths
        phase_t: dict = {}
        t0 = self.tracer.clock()
        if self.gamma > 0:
            eng = self._engine(self.gamma)
            try:
                # the injected drafter failure raises BEFORE the round (the
                # state is intact) and recovers as a real one would
                if self.faults.drafter_fails(step_idx):
                    raise DrafterFault(
                        f"injected drafter failure at step {step_idx}")
                if eng.placed_round is not None:
                    self._state = eng.placed_round(
                        self.params_t, self.params_d, self._state)
                elif eng.traced_round is not None:
                    self._state = eng.traced_round(
                        self.params_t, self.params_d, self._state,
                        round=self.total_rounds, gamma=self.gamma)
                    phase_t = eng.traced_round.last_phase_times
                else:
                    self._state = eng.round(self.params_t, self.params_d,
                                            self._state)
            except DrafterFault as e:
                # degrade the batch to AR (one-way until it drains) instead
                # of wedging the server; any other exception propagates
                self.metrics.degrade(self.total_rounds,
                                     f"spec round failed: {e}")
                self._degraded = True
                self.gamma = 0
                with self.tracer.span("ar_round", phase="verify",
                                      role="target", round=self.total_rounds):
                    self._state = self._ar_round(self._state)
        else:
            with self.tracer.span("ar_round", phase="verify",
                                  role="target", round=self.total_rounds):
                self._state = self._ar_round(self._state)
                if self.tracer.enabled:
                    devices.synchronize(self.dev_t)
        # account AFTER the round, so a degraded round is charged as the AR
        # round that ran
        blocks_read, blocks_written = self._account_round(prev_len)
        self.total_rounds += 1
        # ONE host sync per round: lengths + active in a single pull
        snap = torch.stack([self._state.length,
                            self._state.active.to(torch.int32)]).cpu().numpy()
        lengths, active = snap[0].astype(np.int64), snap[1].astype(bool)
        fault_delay = self.faults.round_delay(step_idx)
        # dispatch -> sync, plus the injected virtual straggle, if any
        t_round = self.tracer.clock() - t0 + fault_delay
        if self.gamma > 0 and self.watchdog.observe(t_round):
            self.metrics.degrade(self.total_rounds,
                                 "watchdog: straggling speculative rounds")
            self._degraded = True  # takes effect next round
        self._lengths = lengths
        if self.faults.corrupts(step_idx):
            self._corrupt_one_row(lengths)
        emitted = lengths - prev_len
        rids = [r.rid if r is not None else None for r in self._slots]
        self.metrics.record_round(np.maximum(emitted - 1, 0), self.gamma,
                                  active, rids)
        streams = self._harvest_streams(prev_len, lengths)
        # _harvest's refill writes newly admitted rows into ``lengths``;
        # the event must see THIS round's commit
        ev_lengths = lengths.copy()
        done_before = len(self.done)
        self._state = self._harvest(self._state, lengths)
        expired += self.sched.drain_expired()
        failed = self._drain_failed()
        self._record_event(prev_len, ev_lengths, active, rids, t_round,
                           phase_t, blocks_read, blocks_written, queue_depth,
                           n_preempted=len(preempted), n_expired=len(expired),
                           n_failed=len(failed), fault_delay=fault_delay)
        return {"streams": streams,
                "finished": [r.rid for r in self.done[done_before:]],
                "cancelled": cancelled,
                "expired": expired,
                "failed": failed,
                "preempted": preempted,
                "round": self.total_rounds - 1,
                "queue_depth": queue_depth,
                "n_live": int(np.sum(active))}
