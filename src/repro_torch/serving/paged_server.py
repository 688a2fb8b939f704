"""Paged continuous-batching speculative server (port of
``repro/serving/paged_server.py::PagedSpecServer`` on its default path:
bucketed all-at-once prefill, worst-case admission).

Every request carries its own prompt length and decode budget; KV lives in
a shared block pool per model (cache/paged_kv.py) and the Scheduler drives
admission, length-bucketed prefill, slot refill into the live block tables
and the cost-model gamma/AR decision. One round — speculative
(``BatchedSpecEngine.round``) or AR when the cost model says speculation
does not pay — advances the whole batch; between rounds the host harvests
finished rows, frees their blocks and refills slots by running a bucketed
one-row prefill straight into the shared pools. Target and drafter consume
identical token positions, so one allocator and one block table drive both
models' pools.

A round pulls ``length`` and ``active`` to the host once; nothing else in
it syncs. A failing speculative round raises: the JAX server degrades such
a round to AR, which here would hide a kernel that fails. Placement,
tracing, fault injection, the watchdog, the prefix pool, chunked prefill,
overcommit with preemption and cancellation wait for later slices.

Invariant (tested): every completed request's tokens equal that prompt's
standalone greedy AR continuation, regardless of its neighbours' lengths.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as devices
from repro_torch.cache.ops import PAGED
from repro_torch.cache.paged_kv import BlockAllocator
from repro_torch.core import rounds
from repro_torch.core.batched_engine import (KV_FAMILIES, BatchedEngineConfig,
                                             BatchedSpecEngine, RowState)
from repro_torch.obs import clock
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig, ServeRequest


class PagedSpecServer:
    def __init__(self, target, drafter, params_t, params_d,
                 scfg: Optional[SchedulerConfig] = None, *,
                 gamma: Optional[int] = None,
                 alpha: Optional[float] = None,
                 cost_coefficient: Optional[float] = None,
                 now=clock.wall, device=None):
        """``gamma``/``alpha``/``cost_coefficient`` override the scheduler's
        cost-model decision (None = decide online from telemetry). The
        server's state lives on ``device`` (``cuda`` unless the caller asks
        for the CPU); the params must already be there."""
        if target.family not in KV_FAMILIES or drafter.family not in KV_FAMILIES:
            raise ValueError("paged speculative serving needs KV-cache families")
        self.device = devices.resolve(device)
        self.target, self.drafter = target, drafter
        self.params_t, self.params_d = params_t, params_d
        self.scfg = scfg or SchedulerConfig()
        self.metrics = ServingMetrics(gamma_max=self.scfg.gamma_max, now=now)
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
        self._state: Optional[RowState] = None
        self._lengths: Optional[np.ndarray] = None  # host mirror of .length
        self._batch_formed = False   # gamma decided for the current batch
        self._engines: Dict[int, BatchedSpecEngine] = {}
        self._table_version = -1    # last allocator.version pushed to device
        self.gamma = None           # decided at batch formation
        self._vocab = int(target.cfg.vocab_size)  # output-guard bound
        self._failed_pending: List[int] = []
        self.done: List[ServeRequest] = []
        self.total_rounds = 0
        self.n_prefills = 0

    # ------------------------------------------------------------- plumbing
    def submit(self, req: ServeRequest):
        self.sched.submit(req)

    def _engine(self, gamma: int) -> BatchedSpecEngine:
        if gamma not in self._engines:
            self._engines[gamma] = BatchedSpecEngine(
                self.target, self.drafter, BatchedEngineConfig(gamma=gamma))
        return self._engines[gamma]

    def _empty_state(self) -> RowState:
        B, dev = self.B, self.device
        geom = dict(num_blocks=self.scfg.num_blocks,
                    block_size=self.scfg.block_size,
                    max_blocks_per_row=self.scfg.max_blocks_per_row)
        return RowState(
            tokens=torch.zeros((B, self.T), dtype=torch.int32, device=dev),
            length=torch.ones((B,), dtype=torch.int32, device=dev),  # length-1 >= 0
            dcache=PAGED.init(self.drafter, B, device=dev, **geom),
            tcache=PAGED.init(self.target, B, device=dev, **geom),
            active=torch.zeros((B,), dtype=torch.bool, device=dev),
            n_rounds=torch.zeros((), dtype=torch.int32, device=dev),
            n_accepted=torch.zeros((B,), dtype=torch.int32, device=dev),
            n_drafted=torch.zeros((), dtype=torch.int32, device=dev))

    def _sync_tables(self, state: RowState) -> RowState:
        """Push the host block table to the device, only when it changed
        since the last push. Both caches share the one device table."""
        if self._table_version == self.alloc.version:
            return state
        self._table_version = self.alloc.version
        table = self.alloc.device_table(self.device)
        return state._replace(tcache={**state.tcache, "block_table": table},
                              dcache={**state.dcache, "block_table": table})

    # -------------------------------------------------------------- prefill
    def _prefill_into(self, state: RowState, row: int, req: ServeRequest):
        """Length-bucketed one-row prefill written straight into the shared
        pools (in place), then rolled back to the true prompt length (exact:
        the padded tail is causally invisible to the real tokens and masked
        afterward). The caller must have synced the block tables.

        Returns ``(state, ok)``: ``ok`` is False when the target produced
        non-finite prefill logits — the caller fails the request instead of
        decoding from a poisoned cache."""
        dev = self.device
        prompt = np.asarray(req.prompt, np.int32)
        padded = self.sched.pad_to_bucket(prompt)
        P = req.prompt_len
        toks = torch.from_numpy(padded[None, :-1]).to(dev)
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        table_row = state.tcache["block_table"][row:row + 1]
        logits, _, _ = self.target.apply(
            self.params_t, toks,
            {**state.tcache, "block_table": table_row, "index": zero})
        # the drafter's prefill logits are never read: unembed the last
        # position only
        self.drafter.apply(self.params_d, toks,
                           {**state.dcache, "block_table": table_row,
                            "index": zero}, logits_slice="last")
        ok = bool(torch.isfinite(logits).all())
        self.n_prefills += 1
        tindex = state.tcache["index"].clone()
        tindex[row] = P - 1
        dindex = state.dcache["index"].clone()
        dindex[row] = P - 1
        tokens = state.tokens.clone()
        tokens[row] = 0
        tokens[row, :P] = torch.from_numpy(prompt).to(dev)
        length = state.length.clone()
        length[row] = P
        active = state.active.clone()
        active[row] = True
        self._target_len[row] = req.prompt_len + req.max_new
        return state._replace(tokens=tokens, length=length, active=active,
                              tcache={**state.tcache, "index": tindex},
                              dcache={**state.dcache, "index": dindex}), ok

    # ------------------------------------------------------------- AR round
    def _ar_round(self, state: RowState) -> RowState:
        """gamma* = 0 fallback: one committed token per active row per round,
        target model only."""
        return rounds.ar_round(self.target, self.params_t, state)

    # -------------------------------------------------------------- serving
    @staticmethod
    def _deactivate(state: RowState, b: int) -> RowState:
        active = state.active.clone()
        active[b] = False
        return state._replace(active=active)

    def _refill(self, state: RowState, lengths: np.ndarray) -> RowState:
        for b in range(self.B):
            if self._slots[b] is not None:
                continue
            req = self.sched.try_admit(b)
            if req is None:
                break                       # FCFS head-blocking
            state = self._sync_tables(state)
            state, ok = self._prefill_into(state, b, req)
            if not ok:
                # non-finite target logits: fail the request cleanly instead
                # of decoding from a poisoned cache
                self.alloc.free_row(b)
                self.metrics.fail(req.rid, "non-finite prefill logits")
                self._failed_pending.append(req.rid)
                state = self._deactivate(state, b)
                continue
            self.metrics.prefill(req.rid, max(req.prompt_len - 1, 0))
            lengths[b] = req.prompt_len     # keep the host mirror current
            self._slots[b] = req
        return state

    def _harvest(self, state: RowState, lengths: np.ndarray) -> RowState:
        """``lengths`` is the round's single host snapshot of state.length.
        Completing rows pass the output guard before release: a committed
        token outside the vocabulary fails the request with the reason
        recorded instead of returning garbage."""
        for b in range(self.B):
            req = self._slots[b]
            if req is None or lengths[b] < self._target_len[b]:
                continue
            toks = state.tokens[b, :self._target_len[b]].cpu().numpy()
            gen = toks[req.prompt_len:]
            if ((gen < 0) | (gen >= self._vocab)).any():
                self.alloc.free_row(b)
                self.metrics.fail(req.rid,
                                  f"corrupt token id outside [0, {self._vocab})",
                                  n_generated=len(gen))
                self._failed_pending.append(req.rid)
            else:
                req.tokens = toks
                self.sched.release(b, req)
                self.done.append(req)
            self._slots[b] = None
            state = self._deactivate(state, b)
        return self._sync_tables(self._refill(state, lengths))

    def run(self):
        """Drain the queue; returns completed requests (rows finish by their
        own lengths, so not in submission order)."""
        while self.step() is not None:
            pass
        return self.done

    def _drain_failed(self) -> List[int]:
        out, self._failed_pending = self._failed_pending, []
        return out

    def step(self) -> Optional[Dict]:
        """ONE serving round: admit/refill (expiring doomed queue heads),
        decide gamma, run one round, record telemetry, harvest finished
        rows. Returns None when idle, else a step-info dict (finished /
        expired / failed rids, the round id, queue depth, live rows)."""
        if self._state is None:
            self._state = self._empty_state()
            self._lengths = self._state.length.cpu().numpy().astype(np.int64)
        self._state = self._sync_tables(self._refill(self._state, self._lengths))
        expired = self.sched.drain_expired()
        if not any(r is not None for r in self._slots):
            # the batch is over: the next admission re-forms it and
            # re-decides gamma
            self._batch_formed = False
            failed = self._drain_failed()
            if expired or failed or self.sched.has_work():
                return {"finished": [], "expired": expired, "failed": failed,
                        "round": None, "queue_depth": len(self.sched.queue),
                        "n_live": 0}
            return None

        # gamma/AR decision (paper Eq. 1, telemetry alpha): decided at batch
        # formation, then re-decided while speculative. AR->spec is one-way
        # OFF within a batch: the drafter KV is not written during AR
        # rounds, so it resynchronizes only at the next batch formation.
        if self._gamma_override is not None:
            self.gamma = self._gamma_override
        elif not self._batch_formed or self.gamma > 0:
            self.gamma, _ = self.sched.choose_gamma(self._alpha_override,
                                                    self._c_override)
        self._batch_formed = True

        queue_depth = len(self.sched.queue)
        prev_len = self._lengths
        if self.gamma > 0:
            self._state = self._engine(self.gamma).round(
                self.params_t, self.params_d, self._state)
        else:
            self._state = self._ar_round(self._state)
        self.total_rounds += 1
        # ONE host sync per round: lengths + active in a single pull
        snap = torch.stack([self._state.length,
                            self._state.active.to(torch.int32)]).cpu().numpy()
        lengths, active = snap[0].astype(np.int64), snap[1].astype(bool)
        self._lengths = lengths
        emitted = lengths - prev_len
        rids = [r.rid if r is not None else None for r in self._slots]
        self.metrics.record_round(np.maximum(emitted - 1, 0), self.gamma,
                                  active, rids)
        for b, req in enumerate(self._slots):
            if req is not None and min(lengths[b], self._target_len[b]) > req.prompt_len:
                self.metrics.first_token(req.rid)
        done_before = len(self.done)
        self._state = self._harvest(self._state, lengths)
        expired += self.sched.drain_expired()
        return {"finished": [r.rid for r in self.done[done_before:]],
                "expired": expired,
                "failed": self._drain_failed(),
                "round": self.total_rounds - 1,
                "queue_depth": queue_depth,
                "n_live": int(np.sum(active))}
